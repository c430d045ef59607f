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
zero-stride inputs exactly as their contiguous copies; its gradient 1e-5
(the plain backward twice, its atomic adds in a fixed order). The renderer
as in chip_smoke.py.
"""

import pytest
import torch

from scade_tpu_torch.models.nerf import NeRF, NeRFConfig
from scade_tpu_torch.ops import fused_mlp, fused_sampling, sampling
from scade_tpu_torch.render import renderer


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
    # through the autograd Function: kernel forward, plain backward
    wt = w.clone().requires_grad_(True)
    out = fused_sampling.fused_sample_pdf(bins, wt, u)
    torch.testing.assert_close(out, got, atol=0, rtol=0)
    w2 = w.clone().requires_grad_(True)
    # the same backward twice; the gathers' backward adds with atomics, in an
    # order that changes from run to run unless deterministic algorithms are
    # on (at M=2 the weights' gradient is 0 in exact arithmetic, and what the
    # atomics leave of the cancelling terms reached 1.5e-5 at 1,000 rays on an H100)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out.sum().backward()
        sampling.sample_pdf(bins, w2, u).sum().backward()
    finally:
        torch.use_deterministic_algorithms(deterministic)
    torch.testing.assert_close(wt.grad, w2.grad, atol=1e-5, rtol=0)


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
