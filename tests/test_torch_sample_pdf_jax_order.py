"""The port's CDF law against the JAX package's, bit for bit.

``sampling._cdf_from_weights`` (and ``fused_sampling.cdf_kernel_order``, the
kernels' name for it) sums in the order XLA gives
``scade_tpu.ops.sampling._cdf_from_weights`` on the CPU, so the CDF, the
draws of ``sample_pdf`` and every below/above and 1e-5-guard decision are
the JAX package's bit for bit, eager and under ``jax.jit`` (there the draws
within an ulp: XLA fuses the interpolation's multiply-add). Rows:
- opaque: 5 (or 20) adjacent bins hold a Dirichlet draw of total 1.0 or
  0.999, the rest 0 (``test_torch_cuda.opaque``): an empty bin's CDF gap
  sits at the 1e-5 guard, within an ulp of the CDF, so another order of sums
  flips a quarter of the guard's decisions there;
- peaked (98% of the weight in 3 adjacent bins), uniform, and dyadic (exact
  in any order).
At every width the port runs (M = 31, 63, 95, 191) and a sweep of widths up
to 257 (two levels of the cumulative sum's blocks above 256), 1,100 and
1,535 (two levels of the row sum's windows above 1,024). The gradient
of the weights, of the plain backward and of the backward kernel's torch
transcription, lies within relative L2 1e-5 of ``jax.vjp`` on opaque rows
with no draw masked: the decisions are the same, and only the gradients'
own sums run in other orders (JAX's through max/min reductions and one-hot
products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scade_tpu.ops import sampling as jsampling
from scade_tpu_torch.ops import fused_sampling, sampling
from test_torch_cuda import dyadic, opaque, peaked

WIDTHS = [30, 62, 94, 190]  # M - 1 at M = 31, 63, 95, 191
# up to 257 (two levels of the cumulative sum's blocks above 256), then 1,100
# and 1,535 (two levels of the row sum's windows above 1,024; M = 1,536)
SWEEP = sorted(set(range(1, 258, 9)) | {15, 16, 17, 31, 32, 33, 255, 256, 257, 1100, 1535})
EAGER = WIDTHS + [16, 17, 32, 33, 256, 257]  # the sweep's edges, also op by op
KINDS = ("opaque", "opaque20", "peaked", "uniform", "dyadic")
R, S = 256, 128
GRAD_TOL = 1e-5


def rows(kind, n, rng, R_=16):
    M = n + 1
    if kind == "opaque":
        return opaque(rng, R_, M)
    if kind == "opaque20":
        return opaque(rng, R_, M, width=20)
    if kind == "peaked":
        return peaked(rng, R_, M, exact=False) if n >= 3 else opaque(rng, R_, M)
    if kind == "uniform":
        return rng.uniform(0, 1, (R_, n)).astype(np.float32)
    return dyadic(rng, R_, M)


def draw_inputs(M, kind, seed=0):
    rng = np.random.default_rng(seed + M)
    bins = (0.5 + np.cumsum(rng.uniform(0.005, 0.06, (R, M)), -1)).astype(np.float32)
    w = rows(kind, M - 1, rng, R)
    u = rng.uniform(0, 1, (R, S)).astype(np.float32)
    u[:, :5] = [0.0, 1e-8, 1.0 - 1e-7, 0.5, 1.0]
    g = rng.standard_normal((R, S)).astype(np.float32)
    return bins, w, u, g


def sweep_rows(n):
    rng = np.random.default_rng(n)
    return np.concatenate([rows(kind, n, rng) for kind in KINDS])


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's CDFs (jitted, and op by op at EAGER), draws (op by
    op and jitted) and weights' VJPs (jitted), once for the module."""
    ns = sorted(set(WIDTHS) | set(SWEEP))
    ws = [jnp.asarray(sweep_rows(n)) for n in ns]
    jitted = jax.jit(lambda ws_: [jsampling._cdf_from_weights(w) for w in ws_])(ws)
    cdf = {n: [np.asarray(c)] for n, c in zip(ns, jitted)}
    for n, w in zip(ns, ws):
        if n in EAGER:
            cdf[n].append(np.asarray(jsampling._cdf_from_weights(w)))
    draw, draws, grads = jax.jit(jsampling.sample_pdf), {}, {}

    @jax.jit
    def grad_w(bins, w, u, g):
        return jax.vjp(lambda w_: jsampling.sample_pdf(bins, w_, u), w)[1](g)[0]

    for M in (n + 1 for n in WIDTHS):
        for kind in KINDS:
            bins, w, u, g = draw_inputs(M, kind)
            args = [jnp.asarray(a) for a in (bins, w, u)]
            draws[M, kind] = (np.asarray(jsampling.sample_pdf(*args)), np.asarray(draw(*args)))
        grads[M] = np.asarray(grad_w(*draw_inputs(M, "opaque")))
    return dict(cdf=cdf, draws=draws, grads=grads)


@pytest.mark.parametrize("n", SWEEP + [n for n in WIDTHS if n not in SWEEP])
def test_cdf_is_jax_bit_for_bit(jax_side, n):
    """Both names of the port's CDF against scade_tpu's, jitted (and op by
    op at EAGER)."""
    w = torch.from_numpy(sweep_rows(n))
    for got in (sampling._cdf_from_weights(w), fused_sampling.cdf_kernel_order(w)):
        for ref in jax_side["cdf"][n]:
            np.testing.assert_array_equal(got.numpy(), ref)


def decisions(cdf, u):
    """below, above and whether the 1e-5 guard fires, per draw, from a CDF
    (numpy, as the JAX package's masked reductions select them)."""
    M = cdf.shape[-1]
    k = (cdf[:, None, :] <= u[:, :, None]).sum(-1)
    below, above = np.maximum(k - 1, 0), np.minimum(k, M - 1)
    denom = (np.take_along_axis(cdf, above, -1) - np.take_along_axis(cdf, below, -1))
    return below, above, denom < np.float32(1e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("M", [n + 1 for n in WIDTHS])
def test_sample_pdf_is_jax_bit_for_bit(jax_side, M, kind):
    """The plain sample_pdf's draws, and its below/above/guard decisions,
    are the JAX package's: the draws bit for bit op by op, and within an
    ulp under jax.jit, where XLA contracts the interpolation's multiply and
    add into one fused multiply-add; on opaque rows the guard's decision on
    an empty bin is live (it fires on some and not on others)."""
    bins, w, u, _ = draw_inputs(M, kind)
    got = sampling.sample_pdf(*map(torch.from_numpy, (bins, w, u))).numpy()
    eager, jitted = jax_side["draws"][M, kind]
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_array_max_ulp(got, jitted, maxulp=1)
    mine = decisions(sampling._cdf_from_weights(torch.from_numpy(w)).numpy(), u)
    theirs = decisions(np.asarray(jsampling._cdf_from_weights(jnp.asarray(w))), u)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    if kind.startswith("opaque"):
        cdf = sampling._cdf_from_weights(torch.from_numpy(w)).numpy()
        gaps = np.diff(cdf, axis=-1)[w == 0]
        assert 0.05 < (gaps < np.float32(1e-5)).mean() < 0.95


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


@pytest.mark.parametrize("M", [n + 1 for n in WIDTHS])
def test_weights_gradient_near_jax_on_opaque_rows(jax_side, M):
    """grad_w of the plain backward (fused_sample_pdf on CPU tensors) and of
    sample_pdf_backward_kernel_order within relative L2 GRAD_TOL of
    jax.vjp, every draw carrying its gradient."""
    bins, w, u, g = map(torch.from_numpy, draw_inputs(M, "opaque"))
    ref = jax_side["grads"][M]
    wl = w.clone().requires_grad_(True)
    plain = torch.autograd.grad(fused_sampling.fused_sample_pdf(bins, wl, u), wl, g)[0]
    kernel = fused_sampling.sample_pdf_backward_kernel_order(bins, w, u, g)[1]
    assert rel_l2(plain, ref) <= GRAD_TOL
    assert rel_l2(kernel, ref) <= GRAD_TOL
