"""Synthetic depth-sensor degradation (reference: data/error_sources.py:3-21).

The counterpart of ``scade_tpu/data/error_sources.py``. Each function is a
draw and its math: the draw (``draw_uniform``, ``draw_normal``) comes from a
``torch.Generator`` on the depth's device, or is given, so two runs (or the
JAX package's ``jax.random`` draw) can be fed the same drop mask and the
same noise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def draw_uniform(gen: Optional[torch.Generator], like: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) of ``like``'s shape, on its device."""
    return torch.rand(like.shape, generator=gen, device=like.device)


def draw_normal(gen: Optional[torch.Generator], like: torch.Tensor) -> torch.Tensor:
    """Standard normals of ``like``'s shape, on its device."""
    return torch.randn(like.shape, generator=gen, device=like.device)


def add_missing_depth(depth: torch.Tensor, valid_depth: torch.Tensor, p: float = 0.1,
                      invalid_depth_value: float = 0.0, *, u: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invalidate random pixels until the total invalid share reaches ``p``
    (reference :3-15): a no-op where the map is already sparser; otherwise
    each currently valid pixel is dropped where its uniform ``u`` (drawn
    from ``generator`` when not given) lies below
    (p − p_before)·n_pixels / n_valid. Only dropped pixels are rewritten.
    Returns (depth, valid)."""
    if u is None:
        u = draw_uniform(generator, depth)
    valid = valid_depth.bool()
    n_pixels = valid.numel()
    n_valid = valid.sum()
    p_before = (n_pixels - n_valid).float() / n_pixels
    p_gap = torch.clamp(p - p_before, min=0.0)
    p_inv = p_gap * n_pixels / n_valid.clamp(min=1).float()
    drop = u < p_inv
    new_depth = torch.where(drop, torch.full_like(depth, invalid_depth_value), depth)
    return new_depth, valid & ~drop


def add_quadratic_depth_noise(depth: torch.Tensor, valid_depth: torch.Tensor, a: float = 1.68e-3,
                              b: float = 6.58e-3, c: float = 4.78e-2, *,
                              noise: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Kinect-style noise at valid pixels only (reference :17-21):
    d + n·(a d² + b d + c), clamped at 0, with standard normals ``noise``
    (drawn from ``generator`` when not given)."""
    if noise is None:
        noise = draw_normal(generator, depth)
    std = a * depth ** 2 + b * depth + c
    noisy = torch.clamp(depth + noise * std, min=0.0)
    return torch.where(valid_depth.bool(), noisy, depth).to(depth.dtype)
