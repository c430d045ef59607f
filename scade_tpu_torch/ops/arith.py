"""Float32 arithmetic rounded as the JAX package's jitted steps round it on
the CPU, where the port reproduces them bit for bit: XLA's CPU backend
contracts a product and the sum that takes it into one fused multiply-add."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def fma(a: torch.Tensor, b: Union[torch.Tensor, float], c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 operands, rounded once to float32: their product
    is exact in float64, and the float64 sum rounds to float32 as the fused
    operation does except on ties of float32 met within 2^-53."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a.double() * b).add_(c.double()).float()
