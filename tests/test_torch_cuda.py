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
each. K2 2e-6/1e-6 where the
order of its sums cannot matter: against the plain lookup of the CDF summed
in the kernel's order (cdf_kernel_order), and against the plain sample_pdf
on dyadic weights, which every order sums exactly; its strided and
zero-stride inputs exactly as their contiguous copies. K2's backward kernel
bit for bit against sample_pdf_backward_kernel_order, the same on every
launch (it adds in a fixed order, with no atomics), and against autograd
through the plain sample_pdf at rtol 1e-4 with an atol of 1e-6 of the
largest entry on dyadic weights; on random weights, and on peaked ones
(~87 terms an entry, whose sums in two orders differ by up to 1.8e-6 of
the largest entry), with an atol of 1e-4 of the largest entry, on the draws
that f32 can decide (``decidable``; the plain backward's own atomics add in
no fixed order there). A resumed CLI run
on the card equals a straight one leaf by leaf. The renderer as in
chip_smoke.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scade_tpu_torch import cli
from scade_tpu_torch.models.nerf import NeRF, NeRFConfig
from scade_tpu_torch.ops import fused_mlp, fused_sampling, sampling
from scade_tpu_torch.render import renderer


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


def backward_case(M, R, S, exact, seed=0, peak=False):
    """Seeded numpy inputs of K2's backward: strictly ascending bins, random
    or dyadic (``exact``) weights, ``peaked`` where ``peak``, draws with 0,
    1e-8, 1 - 1e-7, 0.5 and 1 first, row 1 (M > 2) a guard_row with 5 draws
    in its narrow gaps, and an upstream gradient g ~ N(0, 1)."""
    rng = np.random.default_rng(seed + M + 1000 * exact)
    bins = (0.5 + np.cumsum(rng.uniform(0.005, 0.06, (R, M)), -1)).astype(np.float32)
    w = dyadic(rng, R, M) if exact else rng.uniform(0, 1, (R, M - 1)).astype(np.float32)
    u = rng.uniform(0, 1, (R, S)).astype(np.float32)
    edge = [0.0, 1e-8, 1.0 - 1e-7, 0.5, 1.0][:S]
    u[:, :len(edge)] = edge
    g = rng.standard_normal((R, S)).astype(np.float32)
    if peak:
        w = peaked(rng, R, M, exact)
    if M > 2 and R > 1 and S >= 10:
        w[1] = guard_row(M, exact)
        u[1, 5:10] = (np.arange(1, 6) + 0.5) / 2**17
    return bins, w, u, g


def decidable(bins, w, u, ulps=16):
    """1 on the draws where sample_pdf's gradient is well-conditioned in f32,
    0 elsewhere; a float tensor of u's shape. Two f32 CDFs summed in other
    orders differ by a few ulps of their entries, and the gradient is a
    ratio of CDF differences that jumps at every CDF entry and at the 1e-5
    guard. So a draw counts only where, by the CDF summed in f64 and with
    ``ulps`` ulps of the entries as the error: no entry but cdf[0] lies
    within the error of u; the guard's decision is further than the error
    from 1e-5; and the error is at most 1e-4 of the denominator."""
    cdf = sampling._cdf_from_weights(w.double())
    u = u.double()
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    ca = torch.gather(cdf, -1, above)
    denom = ca - torch.gather(cdf, -1, below)
    err = ulps * 2.0**-24 * ca
    clear = (denom - 1e-5).abs() > err
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    near = ((cdf[..., 1:, None] - u[..., None, :]).abs() <= ulps * 2.0**-24
            * cdf[..., 1:, None]).any(-2)
    return (clear & (err <= 1e-4 * denom) & ~near).float()


def grads_close(got, ref, exact):
    """The backward's bound against another order of its sums (see the
    module docstring): rtol 1e-4, atol 1e-6 (exact CDF) or 1e-4 of the
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


@pytest.mark.cuda
def test_k1_backward_is_the_plain_gradient(cuda):
    gen = torch.Generator().manual_seed(1)
    model = NeRF(NeRFConfig(D=8, W=64, input_ch=27, input_ch_views=3), generator=gen).to(cuda)
    cfg = fused_mlp.FusedCfg(8, 64, 4, (4,))
    pts = torch.rand(300, 3, generator=gen).to(cuda)
    dirs = torch.nn.functional.normalize(torch.randn(300, 3, generator=gen), dim=-1).to(cuda)
    fused_mlp.fused_nerf_apply(model, cfg, pts, dirs).square().sum().backward()
    g_kernel = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    plain = fused_mlp.fused_mlp_plain(fused_mlp.flat_weights(model), cfg, pts, dirs)
    plain.square().sum().backward()
    for a, p in zip(g_kernel, model.parameters()):
        assert torch.allclose(a, p.grad, atol=1e-3 * p.grad.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [63, 191, 2])
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
    # exact: against the plain lookup of the CDF summed in the kernel's order
    kernel_order = sampling.lookup(fused_sampling.cdf_kernel_order(w), bins, u)
    torch.testing.assert_close(got, kernel_order, atol=2e-6, rtol=1e-6)
    # exact: on dyadic weights every order sums alike, so the plain version too
    k = torch.randint(1, 64, (R, M - 1), generator=gen)
    k[:, -1] += 2 ** int(k.sum(-1).max()).bit_length() - k.sum(-1)
    v = (k * 2.0**-12).float().to(cuda)
    wd = v - 1e-5
    assert (wd + 1e-5 == v).all()
    torch.testing.assert_close(fused_sampling.sample_pdf_cuda(bins, wd, u),
                               sampling.sample_pdf(bins, wd, u), atol=2e-6, rtol=1e-6)
    # a strided weights view and a zero-stride draw row read in place
    torch.testing.assert_close(got, fused_sampling.sample_pdf_cuda(bins, w.contiguous(), u),
                               atol=0, rtol=0)
    ub = u[:1].expand(R, S)
    torch.testing.assert_close(fused_sampling.sample_pdf_cuda(bins, w, ub),
                               fused_sampling.sample_pdf_cuda(bins, w, ub.contiguous()),
                               atol=0, rtol=0)
    # through the autograd Function: kernel forward, backward kernel, the
    # same on every run and exactly its torch transcription; near the plain
    # backward on the draws f32 can decide
    mask = decidable(bins, w, u)
    grads = []
    for _ in range(2):
        wt = w.clone().requires_grad_(True)
        out = fused_sampling.fused_sample_pdf(bins, wt, u)
        torch.testing.assert_close(out, got, atol=0, rtol=0)
        before = fused_sampling.sample_pdf_backward_cuda.launches
        (out * mask).sum().backward()
        assert fused_sampling.sample_pdf_backward_cuda.launches == before + 1
        grads.append(wt.grad)
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(grads[0], fused_sampling.sample_pdf_backward_kernel_order(
        bins, w, u, mask)[1])
    w2 = w.clone().requires_grad_(True)
    (sampling.sample_pdf(bins, w2, u) * mask).sum().backward()
    grads_close([grads[0]], [w2.grad], exact=False)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [63, 191, 2])
@pytest.mark.parametrize("R,S", [(1000, 128), (37, 128), (5, 3), (37, 200)])
def test_k2_backward_kernel(cuda, R, S, M):
    """The backward kernel through its launcher: every gradient bit for bit
    its torch transcription (sample_pdf_backward_kernel_order) run on the
    card, two launches equal, the weights' [:, 1:-1] view and a zero-stride
    draw row read in place, and against autograd through the plain
    sample_pdf (grads_close), on dyadic weights with every draw and on
    random ones where f32 can decide; each also peaked (98% of the weight in
    3 adjacent bins, held by the random weights' atol, see
    tests/test_torch_sample_pdf_backward.py). S = 200 is two of the kernel's
    tiles of draws, the second partial."""
    for exact, peak in ((True, False), (False, False), (True, True), (False, True)):
        b, w, u, g = backward_case(M, R, S, exact, peak=peak)
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
        gm = g if exact else g * decidable(bins, wv, u)
        leaves = [t.clone().requires_grad_(True) for t in (bins, wv, u)]
        ref = torch.autograd.grad(sampling.sample_pdf(*leaves), leaves, gm)
        grads_close(fused_sampling.sample_pdf_backward_cuda(bins, wv, u, gm, True, True), ref,
                    exact and not peak)


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
def test_render_rays_kernels_match_plain(cuda):
    gen = torch.Generator().manual_seed(2)
    kw = dict(multires=4, netwidth=64, netwidth_fine=64, n_samples=8, n_importance=16)
    rc = renderer.make_render_config(**kw).test_mode()
    plain = renderer.make_render_config(**kw, use_fused=False, fused_sampling=False).test_mode()
    scene = renderer.SceneVars(NeRF(rc.nerf_coarse, generator=gen).to(cuda),
                               NeRF(rc.nerf_fine, generator=gen).to(cuda),
                               torch.zeros(3, device=cuda), torch.tensor(0.5, device=cuda),
                               torch.zeros(0, device=cuda))
    ro = (torch.randn(64, 3, generator=gen) * 0.1).to(cuda)
    rd = torch.nn.functional.normalize(torch.randn(64, 3, generator=gen), dim=-1).to(cuda)
    with torch.no_grad():
        a = renderer.render_rays(scene, rc, ro, rd, 0.1, 6.0)
        b = renderer.render_rays(scene, plain, ro, rd, 0.1, 6.0)
    assert (a["rgb_map"] - b["rgb_map"]).abs().max().item() <= 1e-3
    assert (a["depth_map"] - b["depth_map"]).abs().max().item() <= 1e-2
