"""Kernels K1 (fused PE + MLP) and K2 (CDF build + inverse-CDF lookup) of the port, as
the CPU runs them (their plain versions behind the autograd Functions),
against the JAX package's Pallas kernels in interpret mode.

Tolerances:
- K1 f32 forward 1e-5, the bound tests/test_fused_mlp.py holds the Pallas
  kernel to; gradients 1e-3, the same. K1 bf16 forward 8e-3: both round
  operands to bf16 at each product and sum in f32, but the sums run in other
  orders, and an ulp of difference can flip an activation's bf16 rounding
  (5.2e-3 seen at N=300). The port in f32 is 1.35e-2 from the Pallas bf16
  output, so the bound tells the modes apart; the test checks that too.
- K2 atol 2e-6, rtol 1e-6, as tests/test_fused_sampling.py, end to end from
  weights whose CDF both frameworks build exactly (test_torch_ops.py holds
  the lookup on random CDFs).
  Gradients w.r.t. weights and bins atol 1e-5 and rtol 1e-5: they reach
  ~1e3, where an f32 ulp is 6e-5, and the backward sums in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from scade_tpu.models.nerf import NeRFConfig as JNeRFConfig
from scade_tpu.models.nerf import nerf_init, params_to_torch_state_dict
from scade_tpu.ops import fused_mlp as jfused_mlp
from scade_tpu.ops import fused_sampling as jfused_sampling
from scade_tpu_torch.models.nerf import NeRF, NeRFConfig
from scade_tpu_torch.ops import fused_mlp, fused_sampling


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)
    monkeypatch.setattr(jfused_mlp.pl, "pallas_call", interp)


def k1_setup(F=4, N=300):
    E = 3 + 6 * F
    jcfg = JNeRFConfig(D=8, W=256, input_ch=E, input_ch_views=3, use_viewdirs=True)
    params = nerf_init(jax.random.PRNGKey(0), jcfg)
    model = NeRF(NeRFConfig(D=8, W=256, input_ch=E, input_ch_views=3, use_viewdirs=True))
    sd = params_to_torch_state_dict(jax.tree.map(np.asarray, params), prefix="")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(N, 3)).astype(np.float32)
    dirs = rng.normal(size=(N, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return params, model, pts, dirs, jfused_mlp.FusedCfg(8, 256, F, (4,)), \
        fused_mlp.FusedCfg(8, 256, F, (4,))


@pytest.mark.parametrize("compute,tol", [(torch.float32, 1e-5), (torch.bfloat16, 8e-3)])
def test_k1_forward_matches_pallas(interpret_mode, compute, tol):
    params, model, pts, dirs, jcfg, cfg = k1_setup()
    jd = jnp.bfloat16 if compute == torch.bfloat16 else jnp.float32
    # N=300 is not a multiple of the tile: the JAX side pads, the port masks
    ref = np.asarray(jfused_mlp.fused_nerf_apply(params, jcfg, pts, dirs, 256, jd))
    before = fused_mlp.fused_mlp_cuda.launches
    with torch.no_grad():
        out = fused_mlp.fused_nerf_apply(model, cfg, torch.from_numpy(pts),
                                         torch.from_numpy(dirs), compute)
        other = fused_mlp.fused_nerf_apply(
            model, cfg, torch.from_numpy(pts), torch.from_numpy(dirs),
            torch.float32 if compute == torch.bfloat16 else torch.bfloat16)
    assert fused_mlp.fused_mlp_cuda.launches == before  # CPU tensors take the plain version
    assert out.shape == (300, 4) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)
    # the port run in the other mode is outside the bound
    assert np.abs(other.numpy() - ref).max() > tol


def test_k1_gradients_match_pallas(interpret_mode):
    params, model, pts, dirs, jcfg, cfg = k1_setup(N=128)
    g_ref = jax.grad(
        lambda p, x: jnp.sum(jfused_mlp.fused_nerf_apply(p, jcfg, x, dirs, 128, jnp.float32) ** 2),
        (0, 1),
    )(params, pts)
    pts_t = torch.from_numpy(pts).requires_grad_(True)
    out = fused_mlp.fused_nerf_apply(model, cfg, pts_t, torch.from_numpy(dirs))
    (out**2).sum().backward()
    sd_grads = params_to_torch_state_dict(jax.tree.map(np.asarray, g_ref[0]), prefix="")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), sd_grads[name], atol=1e-3, err_msg=name)
    np.testing.assert_allclose(pts_t.grad.numpy(), np.asarray(g_ref[1]), atol=1e-3)


def test_k1_plain_matches_module_and_gating():
    """The plain version is the module's own forward in f32 (the kernel's
    function, not a second network), and supports_fusion gates as in JAX."""
    from scade_tpu_torch.ops import Embedder, positional_encoding

    _, model, pts, dirs, _, cfg = k1_setup(N=50)
    x = torch.cat([positional_encoding(torch.from_numpy(pts), Embedder(num_freqs=4,
                                                                        max_freq_log2=3.0)),
                   torch.from_numpy(dirs)], -1)
    with torch.no_grad():
        np.testing.assert_allclose(
            fused_mlp.fused_mlp_plain(fused_mlp.flat_weights(model), cfg,
                                      torch.from_numpy(pts), torch.from_numpy(dirs)).numpy(),
            model(x).numpy(), atol=1e-6, rtol=0,
        )
    emb = Embedder(num_freqs=4, max_freq_log2=3.0)
    ncfg = NeRFConfig(use_viewdirs=True)
    assert fused_mlp.supports_fusion(ncfg, emb, None, 0)
    assert not fused_mlp.supports_fusion(ncfg, Embedder(identity=True), None, 0)
    assert not fused_mlp.supports_fusion(ncfg, emb, None, 4)
    assert not fused_mlp.supports_fusion(NeRFConfig(use_viewdirs=False), emb, None, 0)
    assert not fused_mlp.supports_fusion(ncfg, emb, Embedder(num_freqs=4), 0)


def test_wrappers_refuse_cpu_tensors():
    """The kernel launchers take CUDA tensors only: no silent CPU path."""
    _, model, pts, dirs, _, cfg = k1_setup(N=8)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_mlp_cuda(fused_mlp.flat_weights(model), cfg, torch.from_numpy(pts),
                                 torch.from_numpy(dirs))
    with pytest.raises(ValueError, match="CUDA"):
        fused_sampling.sample_pdf_cuda(torch.zeros(2, 5), torch.zeros(2, 4), torch.zeros(2, 3))


def dyadic_weights(rng, R, M):
    """Weights whose CDF every framework builds bit for bit: w + 1e-5 lands
    on multiples of 2^-12 and each row of them sums to a power of two, so
    the normalization and every partial sum are exact in any order."""
    k = rng.integers(1, 64, (R, M - 1))
    total = 1 << int(np.ceil(np.log2(k.sum(-1).max())))
    k[:, -1] += total - k.sum(-1)
    v = (k * 2.0**-12).astype(np.float32)
    w = (v - np.float32(1e-5)).astype(np.float32)
    assert ((w + np.float32(1e-5)) == v).all()
    return w


@pytest.mark.parametrize("M", [63, 191])
def test_k2_end_to_end_and_gradient(M):
    """fused_sample_pdf from the weights, forward and backward, against the
    JAX package's Pallas kernel (which interprets on the CPU), with the edge
    draws of tests/test_fused_sampling.py and u = 1 (every CDF entry <= u).
    Weights are dyadic (see dyadic_weights): with random weights the two
    frameworks' CDF sums differ by ulps, which the lookup amplifies
    (test_torch_ops.py::test_sample_pdf_live holds that law at rtol 1e-4)."""
    rng = np.random.default_rng(10 + M)
    # strictly ascending bins: at tied bins the JAX max-VJP splits a gradient
    # that the gather gives to one of them (both are subgradients)
    bins = (0.5 + np.cumsum(rng.uniform(0.005, 0.06, (128, M)), -1)).astype(np.float32)
    w = dyadic_weights(rng, 128, M)
    u = rng.uniform(0, 1, (128, 32)).astype(np.float32)
    u[:, :5] = [0.0, 1e-8, 1.0 - 1e-7, 0.5, 1.0]

    @jax.jit
    def value_and_grads(b, w_, u_):
        out, vjp = jax.vjp(jfused_sampling.fused_sample_pdf, b, w_, u_)
        return out, vjp(jnp.ones_like(out))[:2]

    ref, (gb, gw) = jax.tree.map(np.asarray, value_and_grads(bins, w, u))
    before = fused_sampling.sample_pdf_cuda.launches
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(bins).requires_grad_(True)
    got = fused_sampling.fused_sample_pdf(bt, wt, torch.from_numpy(u))
    assert fused_sampling.sample_pdf_cuda.launches == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=2e-6, rtol=1e-6)

    # gradients reach ~1e3 where a draw lands in a narrow interval; the
    # backward's sums run in other orders, so they agree to f32 ulps
    got.sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), gw, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), gb, atol=1e-5, rtol=1e-5)
