"""Kernel K2 (one kernel for the CDF build and the inverse-CDF lookup) as the
CPU can check it: its CDF in the kernel's summation order, its function
against the JAX package, and its wrapper's argument checks.

``cdf_kernel_order`` is held three ways:
- bit for bit against a literal transcription of the kernel's loops in
  numpy float32 scalars (every lane, every shuffle), so that on the card
  ``lookup(cdf_kernel_order(w), ...)`` is exactly the kernel's function;
- within 6 * 2^-24 of the CDF summed in f64 (a CDF lies in [0, 1], where an
  f32 ulp is at most 2^-24 below 1): up to 4.4 * 2^-24 seen on 4,000 rows
  on the CPU, torch.cumsum's order there up to 3.3;
- bit for bit against ``sampling._cdf_from_weights`` on dyadic weights, whose
  sums are exact in any order.
Lookups against JAX: 2e-6/1e-6 from dyadic weights, as
test_torch_kernels.py; from random weights rtol 1e-4, as
test_torch_ops.py::test_sample_pdf_live, since the two CDFs differ by f32
ulps and the lookup multiplies that by (bin gap) / (CDF gap).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scade_tpu.ops import sampling as jsampling
from scade_tpu_torch.ops import fused_sampling, sampling
from test_torch_kernels import dyadic_weights

EDGE_DRAWS = [0.0, 1e-8, 1.0 - 1e-7, 0.5, 1.0]
CDF_ATOL = 6 * 2.0**-24


def kernel_cdf_loop(w):
    """The kernel's CDF for one row, transcribed from csrc/fused_sampling.cu
    lane by lane in numpy float32 scalars."""
    f = np.float32
    n = len(w)
    L = (n + 31) // 32
    seg = [f(x) + f(1e-5) for x in w]
    lo = [min(lane * L, n) for lane in range(32)]
    hi = [min(a + L, n) for a in lo]
    s = [f(0)] * 32
    for lane in range(32):
        for i in range(lo[lane], hi[lane]):
            s[lane] = f(s[lane] + seg[i])
    for off in (16, 8, 4, 2, 1):
        s = [f(s[lane] + s[lane ^ off]) for lane in range(32)]
    t = [f(0)] * 32
    for lane in range(32):
        for i in range(lo[lane], hi[lane]):
            seg[i] = f(seg[i] / s[lane])
            t[lane] = f(t[lane] + seg[i])
    for off in (1, 2, 4, 8, 16):
        t = [f(t[lane - off] + t[lane]) if lane >= off else t[lane] for lane in range(32)]
    c = [f(0)] + t[:-1]
    for lane in range(32):
        for i in range(lo[lane], hi[lane]):
            c[lane] = f(c[lane] + seg[i])
            seg[i] = c[lane]
    return np.array([0.0] + seg, np.float32)


def cdf_f64(w):
    w64 = w.astype(np.float64) + np.float32(1e-5)
    cdf = np.cumsum(w64 / w64.sum(-1, keepdims=True), -1)
    return np.concatenate([np.zeros_like(cdf[..., :1]), cdf], -1)


def inputs(M, R=64, S=128, dyadic=False, seed=0):
    rng = np.random.default_rng(seed + M)
    # strictly ascending bins, as z_mid is
    bins = (0.5 + np.cumsum(rng.uniform(0.005, 0.06, (R, M)), -1)).astype(np.float32)
    w = dyadic_weights(rng, R, M) if dyadic else rng.uniform(0, 1, (R, M - 1)).astype(np.float32)
    u = rng.uniform(0, 1, (R, S)).astype(np.float32)
    u[:, :len(EDGE_DRAWS)] = EDGE_DRAWS
    return bins, w, u


@pytest.mark.parametrize("M", [2, 3, 33, 34, 63, 191, 300])
def test_cdf_kernel_order_is_the_kernels_loop(M):
    """M-1 around multiples of 32 puts empty and partial segments in the
    last lanes; a zero row is the 1e-5 floor alone."""
    w = np.random.default_rng(M).uniform(0, 1, (3, M - 1)).astype(np.float32)
    w[0] = 0.0
    got = fused_sampling.cdf_kernel_order(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, np.stack([kernel_cdf_loop(row) for row in w]))


@pytest.mark.parametrize("M", [2, 63, 191])
def test_cdf_kernel_order_within_ulps_of_f64(M):
    rng = np.random.default_rng(100 + M)
    w = rng.uniform(0, 1, (256, M - 1)).astype(np.float32)
    w[:64] **= 4  # a few heavy bins, many near the floor
    got = fused_sampling.cdf_kernel_order(torch.from_numpy(w))
    assert got.shape == (256, M) and got.dtype == torch.float32
    assert (got[:, 0] == 0).all() and (got[:, 1:] >= got[:, :-1]).all()
    np.testing.assert_allclose(got.numpy(), cdf_f64(w), rtol=0, atol=CDF_ATOL)


@pytest.mark.parametrize("M", [2, 63, 191])
def test_cdf_kernel_order_exact_on_dyadic_weights(M):
    w = torch.from_numpy(dyadic_weights(np.random.default_rng(M), 128, M))
    np.testing.assert_array_equal(fused_sampling.cdf_kernel_order(w).numpy(),
                                  sampling._cdf_from_weights(w).numpy())


@pytest.mark.parametrize("dyadic,atol,rtol", [(True, 2e-6, 1e-6), (False, 2e-6, 1e-4)])
@pytest.mark.parametrize("M", [2, 63, 191])
def test_kernel_order_lookup_matches_jax(M, dyadic, atol, rtol):
    """The kernel's function, lookup(cdf_kernel_order(w), bins, u), against
    the JAX package's sample_pdf, edge draws included."""
    bins, w, u = inputs(M, dyadic=dyadic)
    got = sampling.lookup(fused_sampling.cdf_kernel_order(torch.from_numpy(w)),
                          torch.from_numpy(bins), torch.from_numpy(u)).numpy()
    ref = np.asarray(jsampling.sample_pdf(jnp.asarray(bins), jnp.asarray(w), jnp.asarray(u)))
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)
    assert np.isfinite(got).all()
    assert (got >= bins[:, :1]).all() and (got <= bins[:, -1:]).all()


@pytest.mark.parametrize("M", [63, 191])
def test_kernel_order_holds_the_f64_witness(M):
    """chip_smoke.py's bound on random weights, here against the CPU's plain
    version: the kernel's share of draws within 1e-5 of sample_pdf computed
    in f64 at most 0.1 point below the plain version's, its CDF at most 2x
    as far from the f64 CDF. (The largest distance of a draw is no bound: at
    the 1e-5 guard the function jumps by up to a bin width.)"""
    bins, w, u = (torch.from_numpy(a) for a in inputs(M, R=1024))
    cdf64 = sampling._cdf_from_weights(w.double())
    oracle = sampling.lookup(cdf64, bins.double(), u.double())
    kernel = sampling.lookup(fused_sampling.cdf_kernel_order(w), bins, u).double()
    plain = sampling.sample_pdf(bins, w, u).double()
    share = [((x - oracle).abs() <= 1e-5).double().mean().item() for x in (kernel, plain)]
    assert share[0] >= share[1] - 0.001
    cdf_err = [(c.double() - cdf64).abs().max().item()
               for c in (fused_sampling.cdf_kernel_order(w), sampling._cdf_from_weights(w))]
    assert cdf_err[0] <= 2 * cdf_err[1]


@pytest.mark.parametrize("M", [2, 63, 191])
def test_fused_sample_pdf_on_cpu_takes_the_plain_version(M):
    """On CPU tensors, a weights[..., 1:-1] view and a draw row broadcast with
    row stride 0, as the renderer passes them, give the plain sample_pdf of
    their contiguous copies, without a launch."""
    bins, w, u = inputs(M)
    full = torch.from_numpy(np.pad(w, ((0, 0), (1, 1)), constant_values=7.0))
    wv = full[:, 1:-1]
    uv = torch.from_numpy(u[0]).expand(u.shape)
    assert wv.stride() == (M + 1, 1) and uv.stride() == (0, 1)
    before = fused_sampling.sample_pdf_cuda.launches
    got = fused_sampling.fused_sample_pdf(torch.from_numpy(bins), wv, uv)
    assert fused_sampling.sample_pdf_cuda.launches == before
    ref = sampling.sample_pdf(torch.from_numpy(bins), wv.contiguous(), uv.contiguous())
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def refused_inputs(case):
    bins, w, u = (torch.from_numpy(a) for a in inputs(63, R=4, S=8))
    if case == "inner stride":
        w = torch.from_numpy(np.repeat(w.numpy(), 2, -1))[:, ::2]
    elif case == "float32":
        u = u.double()
    elif case == "at least 2":
        bins, w = bins[:, :1], w[:, :0]
    elif case == "shapes":
        u = u[:3]
    elif case == "2-D":
        bins, w, u = bins[None], w[None], u[None]
    return bins, w, u


@pytest.mark.parametrize("case", ["CUDA", "inner stride", "float32", "at least 2", "shapes",
                                  "2-D"])
def test_sample_pdf_cuda_refuses(case):
    """The launcher refuses what the kernel does not take (every other check
    comes before the device's, so each shows here on CPU tensors); on CPU
    tensors it never takes the plain version."""
    with pytest.raises(ValueError, match=case):
        fused_sampling.sample_pdf_cuda(*refused_inputs(case))
