"""The card a run needs, what it reports of it, and what may not be loaded."""

from __future__ import annotations

import os
import subprocess
import sys
from typing import List

# Top-level module names that no process of the benchmark may hold: JAX and
# the JAX package the port was made from. Compared whole, so the port
# (``scade_tpu_torch``) is not among them.
FORBIDDEN = ("jax", "jaxlib", "flax", "scade_tpu")


def forbidden_modules() -> List[str]:
    """The forbidden top-level names found in ``sys.modules``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def cache_env(checkout: str) -> None:
    """Fixed cache directories inside the checkout for every compiler a
    program may use (the port builds its own kernels into
    ``scade_tpu_torch/_build/``), so that only a checkout's first run builds."""
    base = os.path.join(checkout, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def require_devices(count: int) -> None:
    """Exits with code 2, printing no result, without ``count`` CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this benchmark runs only on an NVIDIA card")
    if torch.cuda.device_count() < count:
        sys.exit(f"the workload needs {count} CUDA devices; "
                 f"{torch.cuda.device_count()} are visible")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them ('' without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def describe(device, count: int) -> dict:
    """The result's ``device`` block: the platform, the card's name, the
    cards used and the peak of memory allocated on the fullest."""
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count))}


def set_precision(config: dict) -> None:
    """The TF32 switches the configuration states."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = config["precision"]["cuda_matmul_allow_tf32"]
    torch.backends.cudnn.allow_tf32 = config["precision"]["cudnn_allow_tf32"]
