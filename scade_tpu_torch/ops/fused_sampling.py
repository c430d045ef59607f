"""Inverse-CDF sampling: kernel K2 and its plain versions.

Replaces the Pallas kernel ``scade_tpu/ops/fused_sampling.py::_lookup_kernel``
and the CDF build the JAX package runs before it. The CUDA source is
``csrc/fused_sampling.cu``; its header says what bounds it on the card
(bytes: (2M - 1 + 2S) * 4 per ray) and how one warp per ray builds the CDF in
shared memory and inverts it, reading strided weights and broadcast draws in
place.

``fused_sample_pdf`` is the entry point. For CUDA tensors it launches the
kernel (``sample_pdf_cuda``) and raises if the launch fails; only for CPU
tensors does it take the plain ``sampling.sample_pdf``, which is also the
oracle. The kernel sums the CDF in another order than ``torch.cumsum``;
``cdf_kernel_order`` builds it in the kernel's order with torch ops, so that
``sampling.lookup(cdf_kernel_order(w), bins, u)`` is the kernel's function
bit for bit (tests and ``chip_smoke.py`` use it; the main path does not).
The backward recomputes through the plain ``sample_pdf``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scade_tpu_torch import _kernels
from scade_tpu_torch.ops import sampling

LANES = 32  # a warp: the kernel's lanes per ray
WARPS = 4  # rays per block, as csrc/fused_sampling.cu
SMEM_LIMIT = 227 * 1024  # shared memory a block can use on Hopper


@functools.cache
def _entry():
    fn = _kernels.load("fused_sampling").sample_pdf_fused
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def sample_pdf_cuda(bins, weights, u):
    """Launches kernel K2 on the current stream: bins (R, M), weights
    (R, M-1), u (R, S), each float32 on the card with inner stride 1 and any
    row stride (0 for a draw row shared by all rays) → (R, S).
    ``sample_pdf_cuda.launches`` counts the launches."""
    if bins.dim() != 2 or weights.dim() != 2 or u.dim() != 2:
        raise ValueError("sample_pdf_cuda: bins, weights and u must be 2-D, got "
                         f"{bins.dim()}, {weights.dim()}, {u.dim()} dims")
    R, M = bins.shape
    S = u.shape[1]
    if weights.shape != (R, M - 1) or u.shape[0] != R:
        raise ValueError(f"sample_pdf_cuda: shapes bins {tuple(bins.shape)}, weights "
                         f"{tuple(weights.shape)}, u {tuple(u.shape)}; expected (R, M), "
                         "(R, M-1), (R, S)")
    if M < 2:
        raise ValueError(f"sample_pdf_cuda: M={M} bins, needs at least 2")
    if not bins.dtype == weights.dtype == u.dtype == torch.float32:
        raise ValueError(f"sample_pdf_cuda: needs float32, got {bins.dtype}, {weights.dtype}, "
                         f"{u.dtype}")
    if not bins.stride(1) == weights.stride(1) == u.stride(1) == 1:
        raise ValueError("sample_pdf_cuda: needs inner stride 1, got "
                         f"{bins.stride(1)}, {weights.stride(1)}, {u.stride(1)}")
    if not (bins.is_cuda and bins.device == weights.device == u.device):
        raise ValueError("sample_pdf_cuda: needs CUDA tensors on one device, got "
                         f"{bins.device}, {weights.device}, {u.device}")
    if WARPS * 2 * M * 4 > SMEM_LIMIT:
        raise ValueError(f"sample_pdf_cuda: M={M} bins exceed shared memory")
    out = torch.empty((R, S), dtype=torch.float32, device=bins.device)
    if R == 0 or S == 0:
        return out
    # the raw handle of torch.cuda.current_stream(), without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(out.device.index)
    status = _entry()(bins.data_ptr(), bins.stride(0), weights.data_ptr(), weights.stride(0),
                      u.data_ptr(), u.stride(0), out.data_ptr(), R, M, S, stream)
    _kernels.check(status, "sample_pdf_fused")
    sample_pdf_cuda.launches += 1
    return out


sample_pdf_cuda.launches = 0


def cdf_kernel_order(weights):
    """The CDF of ``sampling._cdf_from_weights`` summed in the kernel's order:
    lane l of a warp owns the segment [l L, (l+1) L) of the M-1 weights,
    L = ceil((M-1) / 32); segment sums, a butterfly for the total, the
    divide, segment sums of the quotients, a Kogge-Stone scan of those for
    each lane's offset, then serial sums from the offsets. Each step is an
    f32 add or divide, as the kernel's round-to-nearest intrinsics.
    weights (..., M-1) → (..., M)."""
    n = weights.shape[-1]
    L = -(-n // LANES)
    # (..., 32, L): a lane's segment, padded with zeros, which add exactly
    seg = torch.nn.functional.pad(weights + 1e-5, (0, LANES * L - n)).unflatten(-1, (LANES, L))
    lane = torch.arange(LANES, device=weights.device)
    s = torch.zeros_like(seg[..., 0])
    for j in range(L):
        s = s + seg[..., j]
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ off]
    pdf = seg / s[..., :1, None]
    t = torch.zeros_like(s)
    for j in range(L):
        t = t + pdf[..., j]
    for off in (1, 2, 4, 8, 16):
        t = torch.cat([t[..., :off], t[..., :-off] + t[..., off:]], -1)
    c = torch.cat([torch.zeros_like(t[..., :1]), t[..., :-1]], -1)
    cdf = []
    for j in range(L):
        c = c + pdf[..., j]
        cdf.append(c)
    cdf = torch.stack(cdf, -1).flatten(-2)[..., :n]
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)


class _FusedSamplePdf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bins, weights, u):
        ctx.save_for_backward(bins, weights, u)
        if weights.device.type == "cpu":
            return sampling.sample_pdf(bins, weights, u)
        return sample_pdf_cuda(bins, weights, u)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = sampling.sample_pdf(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_sample_pdf(bins, weights, u):
    """``sample_pdf`` through kernel K2: bins (R, M), weights (R, M-1),
    u (R, S) → (R, S), as the renderer passes them (on CPU tensors the plain
    version also takes more leading dimensions)."""
    return _FusedSamplePdf.apply(bins, weights, u)
