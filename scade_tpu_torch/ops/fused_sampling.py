"""Inverse-CDF sampling: kernel K2, its backward kernel, and their plain versions.

Replaces the Pallas kernel ``scade_tpu/ops/fused_sampling.py::_lookup_kernel``
and the CDF build the JAX package runs before it; the backward kernel is the
counterpart of its ``_bwd`` (:172), a VJP of the plain ``sample_pdf``. The
CUDA source is ``csrc/fused_sampling.cu``; its header says what bounds each
kernel on the card (bytes) and how one warp per ray builds the CDF in shared
memory, inverts it, and for the backward sorts each draw's gradient terms by
entry (a stable counting sort on integers) so that each entry's owner adds
them in a fixed order, reading strided weights and broadcast draws in place.

The port has one CDF law: ``sampling._cdf_from_weights``, summed in the
order XLA gives the JAX package on the CPU (see ``sampling.ROW_WINDOW``).
The kernels build it in that order with round-to-nearest intrinsics, so the
CDF, and with it every bin and 1e-5-guard decision, is the JAX package's
bit for bit in the kernels and in the plain version alike;
``cdf_kernel_order`` is another name for it.

``fused_sample_pdf`` is the entry point. For CUDA tensors it launches the
kernels (``sample_pdf_cuda`` forward, ``sample_pdf_backward_cuda`` backward)
and raises if a launch fails; only for CPU tensors does it take the plain
``sampling.sample_pdf`` and autograd through it, which is also the oracle.
``sample_pdf_backward_kernel_order`` repeats the backward kernel's
arithmetic with torch ops bit for bit (tests and ``chip_smoke.py`` use it;
the main path does not).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scade_tpu_torch import _kernels
from scade_tpu_torch.ops import sampling

WARPS = 4  # rays per block, as csrc/fused_sampling.cu
TILE = 128  # draws the backward kernel sorts at a time, as csrc/fused_sampling.cu
SMEM_LIMIT = 227 * 1024  # shared memory a block can use on Hopper


def scratch_words(M):
    """The CDF build's scratch row a warp, in 4-byte words (the window and
    block totals of every level), as csrc/fused_sampling.cu."""
    return M // 8 + 8


@functools.cache
def _entry():
    fn = _kernels.load("fused_sampling").sample_pdf_fused
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_entry():
    fn = _kernels.load("fused_sampling").sample_pdf_backward
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 4
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(what, tensors, rows_per_warp, words_per_warp=0):
    """The launchers' argument checks: ``tensors`` are bins (R, M), weights
    (R, M-1), then tensors of shape (R, S); ``rows_per_warp`` rows of M
    4-byte words, the CDF build's scratch row and ``words_per_warp`` more a
    warp in shared memory. Every check but the device's comes first, so that
    each shows on CPU tensors. Returns R, M, S."""
    names = ("bins", "weights", "u", "g")[:len(tensors)]
    if any(t.dim() != 2 for t in tensors):
        raise ValueError(f"{what}: {', '.join(names)} must be 2-D, got "
                         f"{', '.join(str(t.dim()) for t in tensors)} dims")
    bins, weights, u = tensors[:3]
    R, M = bins.shape
    S = u.shape[1]
    if weights.shape != (R, M - 1) or any(t.shape != (R, S) for t in tensors[2:]):
        raise ValueError(f"{what}: shapes " + ", ".join(
            f"{n} {tuple(t.shape)}" for n, t in zip(names, tensors))
            + "; expected (R, M), (R, M-1), then (R, S)")
    if M < 2:
        raise ValueError(f"{what}: M={M} bins, needs at least 2")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{what}: needs float32, got "
                         f"{', '.join(str(t.dtype) for t in tensors)}")
    if any(t.stride(1) != 1 for t in tensors):
        raise ValueError(f"{what}: needs inner stride 1, got "
                         f"{', '.join(str(t.stride(1)) for t in tensors)}")
    if not (bins.is_cuda and all(t.device == bins.device for t in tensors)):
        raise ValueError(f"{what}: needs CUDA tensors on one device, got "
                         f"{', '.join(str(t.device) for t in tensors)}")
    if WARPS * (rows_per_warp * M + scratch_words(M) + words_per_warp) * 4 > SMEM_LIMIT:
        raise ValueError(f"{what}: M={M} bins exceed shared memory")
    return R, M, S


def sample_pdf_cuda(bins, weights, u):
    """Launches kernel K2 on the current stream: bins (R, M), weights
    (R, M-1), u (R, S), each float32 on the card with inner stride 1 and any
    row stride (0 for a draw row shared by all rays) → (R, S).
    ``sample_pdf_cuda.launches`` counts the launches."""
    R, M, S = _check_inputs("sample_pdf_cuda", (bins, weights, u), 2)
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


def sample_pdf_backward_cuda(bins, weights, u, g, need_bins=False, need_u=False):
    """Launches K2's backward kernel on the current stream: the VJP of the
    forward kernel's function at (bins, weights, u) for the upstream
    gradient g (R, S), as ``sample_pdf_backward_kernel_order`` computes it.
    Takes what ``sample_pdf_cuda`` takes, and g likewise. Returns
    (grad_bins, grad_weights, grad_u), contiguous, grad_bins and grad_u None
    unless asked for. ``sample_pdf_backward_cuda.launches`` counts the
    launches."""
    # cdf, bins, pdf, two rows of sums, the list starts (M + 1), the sorted terms
    R, M, S = _check_inputs("sample_pdf_backward_cuda", (bins, weights, u, g), 6,
                            1 + 4 * TILE)

    def empty(n):
        return torch.empty((R, n), dtype=torch.float32, device=bins.device)

    grad_w = empty(M - 1)
    grad_bins = empty(M) if need_bins else None
    grad_u = empty(S) if need_u else None
    if R == 0:
        return grad_bins, grad_w, grad_u
    stream = torch._C._cuda_getCurrentRawStream(grad_w.device.index)
    status = _backward_entry()(
        bins.data_ptr(), bins.stride(0), weights.data_ptr(), weights.stride(0),
        u.data_ptr(), u.stride(0), g.data_ptr(), g.stride(0), grad_w.data_ptr(),
        0 if grad_bins is None else grad_bins.data_ptr(),
        0 if grad_u is None else grad_u.data_ptr(), R, M, S, stream)
    _kernels.check(status, "sample_pdf_backward")
    sample_pdf_backward_cuda.launches += 1
    return grad_bins, grad_w, grad_u


sample_pdf_backward_cuda.launches = 0


# The CDF the kernels build: the plain version's, in the same order of sums.
cdf_kernel_order = sampling._cdf_from_weights


def _suffix_sums(x):
    """The reverse scan of the backward kernel: out[i] = sum of x[j] for
    j >= i over x (..., n), in the CDF build's blocks of SCAN_BLOCK: each
    block's running sums from its top, the block totals' running sums from
    the last block down (each block's offset the sum of those after it),
    then one add an entry."""
    n = x.shape[-1]
    B = sampling.SCAN_BLOCK
    blocks = torch.nn.functional.pad(x, (0, -n % B)).unflatten(-1, (-1, B))
    inner = sampling._serial_sums(blocks.flip(-1)).flip(-1)
    totals = inner[..., 0]
    after = sampling._serial_sums(totals.flip(-1)).flip(-1)[..., 1:]
    offsets = torch.cat([after, torch.zeros_like(totals[..., :1])], -1)
    return (inner + offsets[..., None]).flatten(-2)[..., :n]


def sample_pdf_backward_kernel_order(bins, weights, u, g):
    """The VJP of ``sample_pdf(bins, weights, u)`` for the upstream gradient
    g, in the backward kernel's order of operations, with torch ops: bins
    (R, M), weights (R, M-1), u and g (R, S) → (grad_bins, grad_weights,
    grad_u). Per draw, with below/above, the interpolant t and the guarded
    denom of the forward (the same CDF, so the same decisions):
      gu = g (b[above] - b[below]) / denom           → grad_u
      b[below] += g - g t,  b[above] += g t           (bins)
      cdf[below] += gu t - gu,  cdf[above] += -gu t   (or cdf[below] += -gu
                                                       where the guard fired)
    Each bin's and CDF entry's sum runs over the draws in index order, a
    draw's below before its above (the kernel sorts the terms by entry,
    stably, and the lane that owns an entry adds its list); cdf[0] takes
    none. Then grad_pdf, the reverse scan of the CDF entries 1..M-1
    (``_suffix_sums``), d = sum grad_pdf pdf in the row sum's order
    (``sampling._row_sum``), and grad_w = (grad_pdf - d) / sum(w')."""
    M = bins.shape[-1]
    cdf, pdf, s = sampling._cdf_parts(weights)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=M - 1)
    cb, ca = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bb, ba = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = ca - cb
    guard = denom < 1e-5
    denom = torch.where(guard, torch.ones_like(denom), denom)
    t = (u - cb) / denom
    gu = (g * (ba - bb)) / denom
    q = gu * t
    zero = torch.zeros_like(q)
    g_cb = torch.where(guard, -gu, q - gu)
    g_ca = torch.where(guard, zero, -q)
    g_ba = g * t
    g_bb = g - g_ba
    idx = torch.arange(M, device=bins.device)
    gc = torch.zeros_like(bins)
    gb = torch.zeros_like(bins)
    for j in range(u.shape[-1]):
        at_b, at_a = idx == below[:, j:j + 1], idx == above[:, j:j + 1]
        gc = torch.where(at_b, gc + g_cb[:, j:j + 1], gc)
        gc = torch.where(at_a, gc + g_ca[:, j:j + 1], gc)
        gb = torch.where(at_b, gb + g_bb[:, j:j + 1], gb)
        gb = torch.where(at_a, gb + g_ba[:, j:j + 1], gb)
    g_pdf = _suffix_sums(gc[:, 1:])
    d = sampling._row_sum(g_pdf * pdf)[..., None]
    return gb, (g_pdf - d) / s, gu


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
        need_bins, need_w, need_u = ctx.needs_input_grad
        if saved[1].device.type != "cpu":
            grad_bins, grad_w, grad_u = sample_pdf_backward_cuda(
                *saved, g.contiguous(), need_bins=need_bins, need_u=need_u)
            return grad_bins, grad_w if need_w else None, grad_u
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = sampling.sample_pdf(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_sample_pdf(bins, weights, u):
    """``sample_pdf`` through kernel K2 and its backward kernel: bins (R, M),
    weights (R, M-1), u (R, S) → (R, S), as the renderer passes them (on CPU
    tensors the plain version also takes more leading dimensions)."""
    return _FusedSamplePdf.apply(bins, weights, u)
