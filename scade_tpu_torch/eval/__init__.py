"""Test-set rendering with metrics, and LPIPS(alex)."""
