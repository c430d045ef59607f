"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA card and nvcc; every test skips without a CUDA device. The
file imports neither JAX nor scade_tpu, so it runs on a machine without
them; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: K1 in f32 1e-4 at every point (the 3xTF32 products are
f32-accurate; the plain version rounds where the kernel does). K1 in bf16 is
held per point to the same 1e-4, but for 95% of the points, with a median
under 1e-6 and every point within 0.05: operands rounded to bf16 make a sum
taken in another order round an activation the other way now and then, and
the flip carries through the later layers. The plain version, with its
hidden units permuted (the same function, its sums in another order),
disagrees with itself that way: chip_smoke.py measures it beside the kernel
and holds the kernel to it and to sums taken in f64 (on an H100, at the main
path's shapes: the kernel 97.41-97.44% of points within 1e-4, the plain
version reordered 97.42-97.48%, so the kernel sits at the witness and
passes within the share's slack of 0.01, not above it; both at most
3.0e-2; at this file's sizes the kernel keeps 96.9-100%). A kernel run in
the other mode fails either bound. Point counts around the 128-point tile
and two tiles check the masked edge and a last block with few points;
40,000 points (313 tiles) make the persistent blocks walk several tiles
each. K1's backward kernels (``fused_mlp_backward_cuda``) at W = 64,
128, 256 on 300, 65,536 and 196,645 points, after a forward in either mode:
bit-equal over two calls and to the call that recomputes the forward's kept
state (the f32 forward keeps it and its backward launches no forward;
bf16's keeps nothing and its backward launches the keeping forward, counted
as one), one counted call each, and held to the plain f32 gradient through
an f64 witness (at W = 256 also at D = 12 and 16, where the delta kernel
reads a tile's ReLU masks from the kept state, not from shared memory):
a ReLU pre-activation within rounding of 0 flips its unit's gradient, so
the plain f32 recompute itself differs from the f64 gradient by 0.6-3% of a
tensor's largest entry at these sizes (H100). Which points flip differs
between the two, so one tensor's distance is noise (2.4 and 11.7 times the
plain version's seen), but the worst tensor's is not (0.97-1.01 times):
every tensor's distance to the f64 gradient must stay within twice the
plain version's worst plus 1e-5 of its largest entry, and within 1e-3 of
the plain gradient at 300 points. With pts or dirs asking for a
gradient, the backward raises: its kernels give the weights' gradients
only. K1's forward keeps its state only where K1's backward will follow
(not under no_grad, in bf16, or for points that want a gradient), and
keeping changes no bit of its output. K2 bit for bit the plain
sample_pdf (cdf_kernel_order is the plain version's CDF law) on random and
dyadic weights and on opaque rows (``opaque``), where an ulp of the CDF
decides the 1e-5 guard; its strided and zero-stride inputs exactly as their
contiguous copies. K2's backward kernel bit for bit against
sample_pdf_backward_kernel_order, the same on every launch (it adds in a
fixed order, with no atomics), and against autograd through the plain
sample_pdf on every draw (both decide bins and guard on one CDF) at rtol
1e-4 with an atol of 1e-6 of the largest entry on dyadic weights; on
random, opaque and peaked ones 1e-4 of it (peaked: ~87 terms an entry,
whose sums in two orders differ by up to 1.8e-6 of the largest entry;
grad_w = (grad_pdf - d) / sum(w') is a difference of terms that can be far
larger than itself). A resumed CLI run
on the card equals a straight one leaf by leaf. render_rays with both
kernels against the plain path, at a small width and at the ScanNet
cell's (8x256, multires 9, 64 + 128 samples; nets after 20 train steps on
the cell's views, 512 rays of a held-out 468x624 view); rays that carry a
gradient make the fine pass's K1 backward raise. Three eager train
steps at the ScanNet cell's shapes (8x256 nets, 64 + 128 samples, 1,024
rays, K=20, 20 views at 468x624, both kernels on, f32) run under ``torch.cuda.set_sync_debug_mode("error")``, so with no host
read, and leave parameters and Adam moments bit-equal to the same steps
through the 0-d image index they replace
(``tests/test_torch_sync_free_step.py`` keeps its expressions) and
``torch.cumprod``, whose backward reads the host; ``cumprod_nonzero`` equals
it in value and gradient at the step's shapes.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scade_tpu_torch import cli
from scade_tpu_torch.models.nerf import NeRF, NeRFConfig
from scade_tpu_torch.ops import fused_mlp, fused_sampling, sampling
from scade_tpu_torch.ops import volume
from scade_tpu_torch.ops.embedding import Embedder, positional_encoding
from scade_tpu_torch.ops.rays import get_rays
from scade_tpu_torch.render import renderer
from scade_tpu_torch.train import step


def dyadic(rng, R, M):
    """Weights whose CDF every order of sums builds exactly (as
    tests/test_torch_kernels.py::dyadic_weights): w + 1e-5 on multiples of
    2^-12, each row summing to a power of two."""
    k = rng.integers(1, 64, (R, M - 1))
    k[:, -1] += (1 << int(np.ceil(np.log2(k.sum(-1).max())))) - k.sum(-1)
    v = (k * 2.0**-12).astype(np.float32)
    w = (v - np.float32(1e-5)).astype(np.float32)
    assert ((w + np.float32(1e-5)) == v).all()
    return w


def guard_row(M, exact):
    """A row of weights with one heavy interval: the others' CDF gaps are
    under 1e-5, so that draws in them take the 1e-5 guard (denom 1). Exact:
    dyadic, 1/2^17 a gap; else zeros and a 1."""
    n = M - 1
    if not exact:
        w = np.zeros(n, np.float32)
        w[n // 2] = 1.0
        return w
    k = np.ones(n, np.int64)
    k[n // 2] = 2**17 - (n - 1)
    v = (k * 2.0**-12).astype(np.float32)
    w = (v - np.float32(1e-5)).astype(np.float32)
    assert ((w + np.float32(1e-5)) == v).all()
    return w


def peaked(rng, R, M, exact):
    """Weights as a trained NeRF's P_depth weights are: 98% of a row's
    weight in 3 adjacent bins at a random place (fewer where M - 1 < 3), so
    that most draws share a few CDF entries. Exact: dyadic, the light bins
    1-3 / 2^12 each and the row's sum a power of two."""
    n = M - 1
    h = min(3, n)
    at = rng.integers(0, n - h + 1, R)
    heavy = np.zeros((R, n), bool)
    for r in range(R):
        heavy[r, at[r]:at[r] + h] = True
    if not exact:
        w = np.where(heavy, rng.uniform(0.5, 1, (R, n)), rng.uniform(0, 1, (R, n)))
        light = np.where(heavy, 0, w)
        w = np.where(heavy, 0.98 * w / np.where(heavy, w, 0).sum(-1, keepdims=True),
                     0.02 * light / np.maximum(light.sum(-1, keepdims=True), 1e-30))
        return w.astype(np.float32)
    k = np.where(heavy, 0, rng.integers(1, 4, (R, n)))
    total = 1 << int(np.ceil(np.log2(50 * k.sum(-1).max() + 4)))
    for r in range(R):
        rest = total - k[r].sum()
        parts = rng.integers(rest // 4, rest // h + 1, h)
        parts[-1] = rest - parts[:-1].sum()
        k[r, at[r]:at[r] + h] = parts
    v = (k * 2.0**-12).astype(np.float32)
    w = (v - np.float32(1e-5)).astype(np.float32)
    assert ((w + np.float32(1e-5)) == v).all()
    return w


def opaque(rng, R, M, width=5):
    """Weights of rays through an opaque surface: ``width`` adjacent bins at
    a random place hold a Dirichlet draw summing to 1.0 (even rows) or 0.999
    (odd rows), every other bin 0. An empty bin's CDF gap, 1e-5 / sum(w'),
    sits at the 1e-5 guard, so which side of it the gap falls on is decided
    by the CDF's last ulp (167 or 168 ulps of 2^-24 below 1): these rows
    show whether two CDFs sum in one order."""
    n = M - 1
    h = min(width, n)
    at = rng.integers(0, n - h + 1, R)
    w = np.zeros((R, n), np.float32)
    for r in range(R):
        w[r, at[r]:at[r] + h] = rng.dirichlet(np.ones(h)) * (1.0 if r % 2 == 0 else 0.999)
    return w


def backward_case(M, R, S, exact, seed=0, peak=False, opaque_rows=False):
    """Seeded numpy inputs of K2's backward: strictly ascending bins, random
    or dyadic (``exact``) weights, ``peaked`` where ``peak``, ``opaque``
    where ``opaque_rows``, draws with 0, 1e-8, 1 - 1e-7, 0.5 and 1 first,
    row 1 (M > 2) a guard_row with 5 draws in its narrow gaps, and an
    upstream gradient g ~ N(0, 1)."""
    rng = np.random.default_rng(seed + M + 1000 * exact)
    bins = (0.5 + np.cumsum(rng.uniform(0.005, 0.06, (R, M)), -1)).astype(np.float32)
    w = dyadic(rng, R, M) if exact else rng.uniform(0, 1, (R, M - 1)).astype(np.float32)
    u = rng.uniform(0, 1, (R, S)).astype(np.float32)
    edge = [0.0, 1e-8, 1.0 - 1e-7, 0.5, 1.0][:S]
    u[:, :len(edge)] = edge
    g = rng.standard_normal((R, S)).astype(np.float32)
    if peak:
        w = peaked(rng, R, M, exact)
    if opaque_rows:
        w = opaque(rng, R, M)
    if M > 2 and R > 1 and S >= 10:
        w[1] = guard_row(M, exact)
        u[1, 5:10] = (np.arange(1, 6) + 0.5) / 2**17
    return bins, w, u, g


def grads_close(got, ref, exact):
    """The backward's bound against another order of its sums (see the
    module docstring): rtol 1e-4, atol 1e-6 (dyadic weights) or 1e-4 of the
    largest entry, at least 1."""
    for a, b in zip(got, ref):
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=(1e-6 if exact else 1e-4) * scale)


def bf16_agrees(err, tol):
    """The bf16 mode's bound on the per-point errors ``err``: see above."""
    return bool((err <= tol).float().mean() >= 0.95 and err.median() <= 1e-6
                and err.max() <= 0.05)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W,F,n", [(256, 9, 1000), (256, 9, 127), (256, 9, 128), (256, 9, 129),
                                   (256, 9, 255), (256, 9, 256), (256, 9, 257), (256, 9, 40000),
                                   (128, 4, 77), (64, 10, 64)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-4)])
def test_k1_matches_plain(cuda, W, F, n, dtype, tol):
    gen = torch.Generator().manual_seed(W + n)
    E = 3 + 6 * F
    model = NeRF(NeRFConfig(D=8, W=W, input_ch=E, input_ch_views=3), generator=gen).to(cuda)
    cfg = fused_mlp.FusedCfg(8, W, F, (4,))
    pts = (torch.rand(n, 3, generator=gen) * 2 - 1).to(cuda)
    dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1).to(cuda)
    ws = fused_mlp.flat_weights(model)
    with torch.no_grad():
        before = fused_mlp.fused_mlp_cuda.launches
        got = fused_mlp.fused_nerf_apply(model, cfg, pts, dirs, dtype)
        assert fused_mlp.fused_mlp_cuda.launches == before + 1
        ref = fused_mlp.fused_mlp_plain(ws, cfg, pts, dirs, dtype)
        other = fused_mlp.fused_mlp_plain(
            ws, cfg, pts, dirs, torch.float32 if dtype == torch.bfloat16 else torch.bfloat16)
    torch.cuda.synchronize()
    err, other_err = (got - ref).abs().amax(-1), (other - ref).abs().amax(-1)
    # a kernel that ran in the other mode would fail the bound
    if dtype == torch.float32:
        assert err.max().item() <= tol
        assert other_err.max().item() > 10 * tol
    else:
        assert bf16_agrees(err, tol)
        assert not bf16_agrees(other_err, tol)


def rel_errs(got, ref):
    """Per tensor, the largest difference over the largest entry of ref."""
    return [((a.double() - b.double()).abs().max() / b.double().abs().max()).item()
            for a, b in zip(got, ref)]


def relu_near_zero(weights, cfg, pts, dirs, margin):
    """The points at which the f64 network has a ReLU pre-activation within
    ``margin`` of 0, relative to the largest |z| of its layer there: where
    sums of f32 rounding, in any order, may take either side."""
    w = [t.double() for t in weights]
    emb = positional_encoding(pts.double(), Embedder(input_dims=3, num_freqs=cfg.num_freqs,
                                                     max_freq_log2=float(cfg.num_freqs - 1)))
    near = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)

    def check(z):
        near.logical_or_((z.abs() <= margin * z.abs().amax(1, keepdim=True)).any(1))
        return torch.relu(z)

    h = emb
    for i in range(cfg.D):
        x = torch.cat([emb, h], -1) if i > 0 and (i - 1) in cfg.skips else h
        h = check(torch.nn.functional.linear(x, w[2 * i], w[2 * i + 1]))
    feature = torch.nn.functional.linear(h, w[2 * cfg.D + 2], w[2 * cfg.D + 3])
    check(torch.nn.functional.linear(torch.cat([feature, dirs.double()], -1), w[2 * cfg.D + 4],
                                     w[2 * cfg.D + 5]))
    return near


# K1's backward, each tensor's largest difference over the largest entry of
# the f64 gradient from |g| (the size of its terms: a head's bias gradient
# is a sum of terms that cancel). Against the plain f32 gradient, whose ReLU
# decisions it takes: up to 7.8e-7 seen, where a build that keeps the
# 3xTF32 decisions reads 4.8e-5 to 2.4e-4 from 65,536 points on. Against
# the f64 gradient, where no decision lies within 2^-13 of 0 (g zeroed
# elsewhere): up to 1.4e-5 seen, as plain f32 itself, where TF32 products
# read 1.5e-3 and more (H100).
K1_BWD_PLAIN_TOL, K1_BWD_TOL, K1_BWD_MARGIN = 1e-5, 5e-5, 2.0**-13


def k1_backward_holds(cuda, D, W, F, n, dtype):
    """K1's backward through fused_nerf_apply at D layers (skip at 4),
    width W, F frequencies and n points: the f32 forward keeps and its
    backward launches no forward; bf16's keeps nothing and its backward
    launches the keeping forward (the recompute). Two calls bit-equal, and
    bit-equal to fused_mlp_backward_cuda without the state; held to the
    plain f32 gradient and, where no ReLU decision lies near 0, to the f64
    one, as TF32 products are not. pts or dirs asking for a gradient raise."""
    gen = torch.Generator().manual_seed(W + n)
    model = NeRF(NeRFConfig(D=D, W=W, input_ch=3 + 6 * F, input_ch_views=3),
                 generator=gen).to(cuda)
    cfg = fused_mlp.FusedCfg(D, W, F, (4,))
    pts = (torch.rand(n, 3, generator=gen) * 2 - 1).to(cuda)
    dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1).to(cuda)
    g = torch.randn(n, 4, generator=gen).to(cuda)
    params = fused_mlp.flat_weights(model)
    f32 = dtype == torch.float32

    def counts():
        return (fused_mlp.fused_mlp_cuda.launches, fused_mlp.fused_mlp_cuda.kept,
                fused_mlp.fused_mlp_backward_cuda.launches)

    def kernel_grads(g):
        launches, kept, backward = counts()
        out = fused_mlp.fused_nerf_apply(model, cfg, pts, dirs, dtype)
        # the f32 forward keeps what the backward reads
        assert counts() == (launches + 1, kept + f32, backward)
        grads = torch.autograd.grad(out, params, g)
        # bf16's backward launches the keeping forward first; f32's none
        assert counts() == (launches + 1 + (not f32), kept + 1, backward + 1)
        return grads

    def plain_grads(g, dt=torch.float32):
        w = [p.detach().to(dt).requires_grad_() for p in params]
        return torch.autograd.grad(fused_mlp.fused_mlp_plain(w, cfg, pts.to(dt), dirs.to(dt)), w,
                                   g.to(dt))

    def errs(got, ref, g):
        size = plain_grads(g.abs(), torch.float64)
        return [((a.double() - b.double()).abs().max() / c.abs().max()).item()
                for a, b, c in zip(got, ref, size)]

    got = kernel_grads(g)
    assert all(torch.equal(a, b) for a, b in zip(got, kernel_grads(g)))
    # from the kept state bit for bit what the call that recomputes it gives
    launches, kept, backward = counts()
    recomputed = fused_mlp.fused_mlp_backward_cuda([p.detach() for p in params], cfg, pts, dirs, g)
    assert counts() == (launches + 1, kept + 1, backward + 1)
    assert all(torch.equal(a, b) for a, b in zip(got, recomputed))
    assert max(errs(got, plain_grads(g), g)) <= K1_BWD_PLAIN_TOL
    # the products: against f64 where the ReLU decisions are clear, which
    # products in TF32 miss
    g0 = g.masked_fill(relu_near_zero(params, cfg, pts, dirs, K1_BWD_MARGIN)[:, None], 0.0)
    exact = plain_grads(g0, torch.float64)
    assert max(errs(kernel_grads(g0), exact, g0)) <= K1_BWD_TOL
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert max(errs(plain_grads(g0), exact, g0)) > K1_BWD_TOL
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    # pts or dirs asking for a gradient: the kernels give the weights' only
    backward = fused_mlp.fused_mlp_backward_cuda.launches
    for x, d in ((pts.clone().requires_grad_(), dirs), (pts, dirs.clone().requires_grad_())):
        out = fused_mlp.fused_nerf_apply(model, cfg, x, d, dtype)
        with pytest.raises(ValueError, match="not those of pts or dirs"):
            torch.autograd.grad(out, params, g)
    assert fused_mlp.fused_mlp_backward_cuda.launches == backward


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [300, 65536, 196608 + 37])
@pytest.mark.parametrize("W,F", [(64, 4), (128, 4), (256, 9)])
def test_k1_backward_is_the_plain_gradient(cuda, W, F, n, dtype):
    k1_backward_holds(cuda, 8, W, F, n, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 40000])
@pytest.mark.parametrize("D", [12, 16])
def test_k1_backward_of_a_deep_trunk_is_the_plain_gradient(cuda, D, n):
    """Past D=10 at W=256 a tile's mask words do not fit in the delta
    kernel's shared memory and it reads them from the kept state."""
    k1_backward_holds(cuda, D, 256, 9, n, torch.float32)


@pytest.mark.cuda
def test_k1_backward_refuses_a_misaligned_g(cuda):
    gen = torch.Generator().manual_seed(3)
    model = NeRF(NeRFConfig(D=2, W=64, input_ch=27, input_ch_views=3), generator=gen).to(cuda)
    cfg = fused_mlp.FusedCfg(2, 64, 4, ())
    pts = torch.rand(10, 3, generator=gen).to(cuda)
    dirs = torch.nn.functional.normalize(torch.randn(10, 3, generator=gen), dim=-1).to(cuda)
    g = torch.randn(41, generator=gen).to(cuda)[1:].view(10, 4)  # contiguous, 4 bytes off
    weights = [w.detach() for w in fused_mlp.flat_weights(model)]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_mlp.fused_mlp_backward_cuda(weights, cfg, pts, dirs, g)


@pytest.mark.cuda
@pytest.mark.parametrize("W,F,n", [(256, 9, 40000), (128, 4, 77), (64, 10, 300)])
def test_k1_keeps_only_for_a_backward(cuda, W, F, n):
    """K1's forward keeps its state only where autograd will take K1's
    backward (grad mode on, a weight wanting a gradient, pts and dirs
    none, f32); every other forward (a render under no_grad, bf16, points
    that want a gradient) keeps nothing. Keeping changes no bit of out."""
    gen = torch.Generator().manual_seed(W + n)
    model = NeRF(NeRFConfig(D=8, W=W, input_ch=3 + 6 * F, input_ch_views=3), generator=gen).to(cuda)
    cfg = fused_mlp.FusedCfg(8, W, F, (4,))
    pts = (torch.rand(n, 3, generator=gen) * 2 - 1).to(cuda)
    dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1).to(cuda)

    def forward(p=pts, dtype=torch.float32):
        kept = fused_mlp.fused_mlp_cuda.kept
        out = fused_mlp.fused_nerf_apply(model, cfg, p, dirs, dtype)
        return out, fused_mlp.fused_mlp_cuda.kept - kept

    kept_out, kept = forward()
    assert kept == 1
    with torch.no_grad():
        plain_out, kept = forward()
        assert kept == 0 and torch.equal(plain_out, kept_out)
        assert forward(dtype=torch.bfloat16)[1] == 0
    assert forward(dtype=torch.bfloat16)[1] == 0
    out, kept = forward(pts.clone().requires_grad_())
    assert kept == 0 and torch.equal(out, kept_out)
    model.requires_grad_(False)
    out, kept = forward()
    assert kept == 0 and torch.equal(out, kept_out)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [63, 191, 2, 300, 1100])
@pytest.mark.parametrize("R,S", [(1000, 128), (37, 128), (5, 3)])
def test_k2_matches_plain(cuda, R, S, M):
    gen = torch.Generator().manual_seed(R + M)
    bins = (0.5 + torch.cumsum(torch.rand(R, M, generator=gen) * 0.05 + 0.005, -1)).to(cuda)
    # the renderer's weights[..., 1:-1]: row stride M + 1, one float into its row
    w_full = torch.rand(R, M + 1, generator=gen).to(cuda)
    w = w_full[:, 1:-1]
    u = torch.rand(R, S, generator=gen).to(cuda)
    u[:, 0], u[:, -1] = 0.0, 1.0
    u[:, 1 % S] = 1.0 - 1e-7
    before = fused_sampling.sample_pdf_cuda.launches
    got = fused_sampling.sample_pdf_cuda(bins, w, u)
    assert fused_sampling.sample_pdf_cuda.launches == before + 1
    # bit for bit the plain sample_pdf: the same CDF law, the same rounding
    assert torch.equal(got, sampling.lookup(fused_sampling.cdf_kernel_order(w), bins, u))
    # and on dyadic weights, which every order of sums builds exactly
    k = torch.randint(1, 64, (R, M - 1), generator=gen)
    k[:, -1] += 2 ** int(k.sum(-1).max()).bit_length() - k.sum(-1)
    v = (k * 2.0**-12).float().to(cuda)
    wd = v - 1e-5
    assert (wd + 1e-5 == v).all()
    assert torch.equal(fused_sampling.sample_pdf_cuda(bins, wd, u),
                       sampling.sample_pdf(bins, wd, u))
    # a strided weights view and a zero-stride draw row read in place
    torch.testing.assert_close(got, fused_sampling.sample_pdf_cuda(bins, w.contiguous(), u),
                               atol=0, rtol=0)
    ub = u[:1].expand(R, S)
    torch.testing.assert_close(fused_sampling.sample_pdf_cuda(bins, w, ub),
                               fused_sampling.sample_pdf_cuda(bins, w, ub.contiguous()),
                               atol=0, rtol=0)
    # opaque rows: an ulp of the CDF decides the guard, so bit for bit
    wo = torch.from_numpy(opaque(np.random.default_rng(R + M), R, M)).to(cuda)
    assert torch.equal(fused_sampling.sample_pdf_cuda(bins, wo, u),
                       sampling.sample_pdf(bins, wo, u))
    # through the autograd Function: kernel forward, backward kernel, the
    # same on every run and exactly its torch transcription; near the plain
    # backward on every draw
    for weights in (w, wo):
        grads = []
        for _ in range(2):
            wt = weights.clone().requires_grad_(True)
            out = fused_sampling.fused_sample_pdf(bins, wt, u)
            assert torch.equal(out, fused_sampling.sample_pdf_cuda(bins, weights, u))
            before = fused_sampling.sample_pdf_backward_cuda.launches
            out.sum().backward()
            assert fused_sampling.sample_pdf_backward_cuda.launches == before + 1
            grads.append(wt.grad)
        assert torch.equal(grads[0], grads[1])
        assert torch.equal(grads[0], fused_sampling.sample_pdf_backward_kernel_order(
            bins, weights, u, torch.ones_like(u))[1])
        w2 = weights.clone().requires_grad_(True)
        sampling.sample_pdf(bins, w2, u).sum().backward()
        grads_close([grads[0]], [w2.grad], exact=False)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [63, 191, 2, 300, 1100])
@pytest.mark.parametrize("R,S", [(1000, 128), (37, 128), (5, 3), (37, 200)])
def test_k2_backward_kernel(cuda, R, S, M):
    """The backward kernel through its launcher: every gradient bit for bit
    its torch transcription (sample_pdf_backward_kernel_order) run on the
    card, two launches equal, the weights' [:, 1:-1] view and a zero-stride
    draw row read in place, and against autograd through the plain
    sample_pdf (grads_close) on every draw, on dyadic, random and opaque
    weights, and peaked (98% of the weight in 3 adjacent bins, held by the
    random weights' atol, see tests/test_torch_sample_pdf_backward.py).
    S = 200 is two of the kernel's tiles of draws, the second partial.
    M = 300 takes a second level of the CDF's blocks, M = 1,100 a second
    level of the row sum's windows and, in the backward, more than 48 KB of
    shared memory a block."""
    for exact, peak, opaque_rows in ((True, False, False), (False, False, False),
                                     (True, True, False), (False, True, False),
                                     (False, False, True)):
        b, w, u, g = backward_case(M, R, S, exact, peak=peak, opaque_rows=opaque_rows)
        bins, u, g = (torch.from_numpy(a).to(cuda) for a in (b, u, g))
        full = torch.from_numpy(np.pad(w, ((0, 0), (1, 1)), constant_values=3.0)).to(cuda)
        wv = full[:, 1:-1]
        before = fused_sampling.sample_pdf_backward_cuda.launches
        got = fused_sampling.sample_pdf_backward_cuda(bins, wv, u, g, need_bins=True,
                                                      need_u=True)
        assert fused_sampling.sample_pdf_backward_cuda.launches == before + 1
        order = fused_sampling.sample_pdf_backward_kernel_order(bins, wv, u, g)
        for a, ref in zip(got, order):
            assert a.shape == ref.shape and torch.equal(a, ref)
        again = fused_sampling.sample_pdf_backward_cuda(bins, wv, u, g, need_bins=True,
                                                        need_u=True)
        assert all(torch.equal(a, c) for a, c in zip(got, again))
        only_w = fused_sampling.sample_pdf_backward_cuda(bins, wv.contiguous(), u, g)
        assert only_w[0] is None and only_w[2] is None and torch.equal(only_w[1], got[1])
        ub = u[:1].expand(R, S)
        assert all(torch.equal(a, c) for a, c in zip(
            fused_sampling.sample_pdf_backward_cuda(bins, wv, ub, g, True, True),
            fused_sampling.sample_pdf_backward_cuda(bins, wv, ub.contiguous(), g, True, True)))
        leaves = [t.clone().requires_grad_(True) for t in (bins, wv, u)]
        ref = torch.autograd.grad(sampling.sample_pdf(*leaves), leaves, g)
        grads_close(got, ref, exact and not peak)


@pytest.mark.cuda
def test_cli_resume_on_the_card_is_bit_equal(cuda, tmp_path, monkeypatch):
    """tests/test_torch_cli.py::test_resume_is_bit_equal_to_a_straight_run on
    --device cuda: 12 + 12 steps equal 24 straight, every leaf of the .tar."""
    subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "..", "tools",
                                      "make_synthetic_scene.py"),
         str(tmp_path / "scene"), "--H", "32", "--W", "48", "--K", "2", "--n_train", "2",
         "--n_val", "1", "--n_test", "1", "--n_video", "0"],
        check=True, capture_output=True)
    monkeypatch.chdir(tmp_path)

    def train(expname, *flags):
        cli.main("scannet", [
            "train", "--data_dir", str(tmp_path), "--scene_id", "scene", "--ckpt_dir",
            str(tmp_path / "ckpt"), "--expname", expname, "--N_samples", "8", "--N_importance",
            "16", "--multires", "4", "--N_rand", "64", "--chunk", "2048", "--num_hypothesis",
            "2", "--cimle_dir", "dump", "--device", "cuda", "--i_img", "1000000", "--i_print",
            "1000000", *flags])

    train("straight", "--num_iterations", "24", "--i_weights", "24")
    train("resumed", "--num_iterations", "12", "--i_weights", "12")
    train("resumed", "--num_iterations", "24", "--i_weights", "12")
    a = torch.load(tmp_path / "ckpt" / "straight" / "000024.tar")
    b = torch.load(tmp_path / "ckpt" / "resumed" / "000024.tar")

    def leaves(x, prefix=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, x

    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys() and a["global_step"] == 24
    for key, value in la.items():
        if torch.is_tensor(value):
            assert torch.equal(value, lb[key]), key
        else:
            assert value == lb[key], key


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "full_width"])
def test_render_rays_kernels_match_plain(cuda, case):
    """small: fresh 64-wide nets on rays near the origin. full_width: the
    ScanNet cell's nets (8x256, multires 9, 64 + 128 samples) after 20
    train steps on the cell's views, 512 rays drawn from a held-out 468x624
    view, the scene's near, far and box."""
    gen = torch.Generator().manual_seed(2)
    if case == "small":
        kw = dict(multires=4, netwidth=64, netwidth_fine=64, n_samples=8, n_importance=16)
        rc = renderer.make_render_config(**kw)
        scene = renderer.SceneVars(NeRF(rc.nerf_coarse, generator=gen).to(cuda),
                                   NeRF(rc.nerf_fine, generator=gen).to(cuda),
                                   torch.zeros(3, device=cuda), torch.tensor(0.5, device=cuda),
                                   torch.zeros(0, device=cuda))
        ro = (torch.randn(64, 3, generator=gen) * 0.1).to(cuda)
        rd = torch.nn.functional.normalize(torch.randn(64, 3, generator=gen), dim=-1).to(cuda)
        near, far = 0.1, 6.0
    else:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
        from host_syncs import H, N_TRAIN, N_VAL, W, ring_scene  # the cell's views, on the card

        kw = {}
        rc = renderer.make_render_config()
        views = ring_scene(cuda, seed=4)
        state = step.create_train_state(0, rc, step.TrainConfig(), n_images=N_TRAIN + N_VAL)
        step_fn = step.make_train_step(rc, step.TrainConfig(), H, W, N_TRAIN)
        train_gen = torch.Generator(device=cuda).manual_seed(0)
        for _ in range(20):
            step_fn(state, views, train_gen)
        rays_o, rays_d = get_rays(H, W, views.intrinsics[N_TRAIN], views.poses[N_TRAIN])
        idx = torch.randperm(H * W, generator=gen)[:512].to(cuda)
        ro, rd = rays_o.reshape(-1, 3)[idx], rays_d.reshape(-1, 3)[idx]
        scene = renderer.SceneVars(state.model_coarse, state.model_fine, views.bb_center,
                                   views.bb_scale, torch.zeros(0, device=cuda))
        near, far = float(views.near), float(views.far)
    plain = renderer.make_render_config(**kw, use_fused=False, fused_sampling=False).test_mode()
    with torch.no_grad():
        a = renderer.render_rays(scene, rc.test_mode(), ro, rd, near, far)
        b = renderer.render_rays(scene, plain, ro, rd, near, far)
    assert (a["rgb_map"] - b["rgb_map"]).abs().max().item() <= 1e-3
    assert (a["depth_map"] - b["depth_map"]).abs().max().item() <= 1e-2


@pytest.mark.cuda
def test_a_fine_pass_on_points_that_want_a_gradient_raises(cuda):
    """The renderer sends the fine pass to K1 whatever its points want, so
    rays that carry a gradient reach K1's backward, which raises rather
    than fall back to the plain network."""
    gen = torch.Generator().manual_seed(3)
    rc = renderer.make_render_config(multires=4, netwidth=64, netwidth_fine=64, n_samples=8,
                                     n_importance=16)
    scene = renderer.SceneVars(NeRF(rc.nerf_coarse, generator=gen).to(cuda),
                               NeRF(rc.nerf_fine, generator=gen).to(cuda),
                               torch.zeros(3, device=cuda), torch.tensor(0.5, device=cuda),
                               torch.zeros(0, device=cuda))
    ro = (torch.randn(64, 3, generator=gen) * 0.1).to(cuda).requires_grad_()
    rd = torch.nn.functional.normalize(torch.randn(64, 3, generator=gen), dim=-1).to(cuda)
    launches = fused_mlp.fused_mlp_cuda.launches
    out = renderer.render_rays(scene, rc, ro, rd, 0.1, 6.0)
    assert fused_mlp.fused_mlp_cuda.launches - launches == 2  # both passes on K1
    backward = fused_mlp.fused_mlp_backward_cuda.launches
    with pytest.raises(ValueError, match="not those of pts or dirs"):
        torch.autograd.grad(out["rgb_map"].sum(), ro)  # through the fine pass alone
    assert fused_mlp.fused_mlp_backward_cuda.launches == backward


@pytest.mark.cuda
def test_train_step_reads_nothing_from_the_card(cuda, monkeypatch):
    from test_torch_sync_free_step import sample_ray_batch_0d, scaled_hypotheses_0d

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from host_syncs import H, N_TRAIN, N_VAL, W, ring_scene  # the cell's views, on the card

    n = N_TRAIN + N_VAL
    scene = ring_scene(cuda, seed=4)
    rc = renderer.make_render_config()
    # scales and shifts on a rate that moves them, so that steps 2 and 3 read
    # the values step 1 wrote
    tc = step.TrainConfig(scaleshift_lr=1e-3)
    state = step.create_train_state(0, rc, tc, n_images=n)
    with torch.no_grad():  # a scale and shift of their own for every view
        g = torch.Generator(device=cuda).manual_seed(5)
        state.scales.copy_(1.0 + 0.2 * torch.rand(n, 1, generator=g, device=cuda))
        state.shifts.copy_(0.1 * torch.randn(n, 1, generator=g, device=cuda))
    # the step launched op by op, which a capture needs free of host reads
    # (tests/test_torch_step_graph.py runs the replays under the same mode)
    step_fn = step.make_train_step(rc, tc, H, W, N_TRAIN).eager

    def three_steps(st):
        gen = torch.Generator(device=cuda)
        for i in range(1, 4):
            gen.manual_seed((7 << 32) + i)
            step_fn(st, scene, gen)

    # first the step as it was, which also builds the kernels and their tables
    with monkeypatch.context() as m:
        m.setattr(step, "sample_ray_batch", sample_ray_batch_0d)
        m.setattr(step, "_scaled_hypotheses", scaled_hypotheses_0d)
        m.setattr(volume, "cumprod_nonzero", lambda x: torch.cumprod(x, dim=-1))
        ref = copy.deepcopy(state)
        three_steps(ref)
    got = copy.deepcopy(state)
    torch.cuda.synchronize()
    launches = fused_mlp.fused_mlp_backward_cuda.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        three_steps(got)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert fused_mlp.fused_mlp_backward_cuda.launches - launches == 6  # K1's backward ran

    def leaves(st):
        return {"params": st.nerf_params() + [st.scales, st.shifts], "mu": st.opt.mu,
                "nu": st.opt.nu, "ss_mu": st.ss_opt.mu, "ss_nu": st.ss_opt.nu}

    assert got.step == ref.step == 3 and got.opt.count == ref.opt.count == 3
    for name, ts in leaves(ref).items():
        for i, (a, b) in enumerate(zip(ts, leaves(got)[name])):
            assert torch.equal(a, b), (name, i)
    assert not torch.equal(got.scales, state.scales)  # scales and shifts moved


@pytest.mark.cuda
@pytest.mark.parametrize("S", [65, 193])
def test_cumprod_nonzero_is_torch_cumprod(cuda, S):
    gen = torch.Generator(device=cuda).manual_seed(S)
    x = 1.0 - torch.rand((1024, S), generator=gen, device=cuda) + 1e-10
    x[:, :1] = 1.0
    x[:, 1::3] = 1e-10
    g = torch.randn((1024, S), generator=gen, device=cuda)
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out_a, out_b = torch.cumprod(a, dim=-1), volume.cumprod_nonzero(b)
    assert torch.equal(out_a, out_b)
    ga, = torch.autograd.grad(out_a[:, :-1], a, g[:, :-1])
    gb, = torch.autograd.grad(out_b[:, :-1], b, g[:, :-1])
    assert torch.equal(ga, gb)
