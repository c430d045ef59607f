"""The port's renderer against scade_tpu's render_rays and the upstream golden.

Same weights on both sides, deterministic draws (generator/key None) and a
shared ``cached_u``; both packages run with their kernels' dispatch on and
off (the JAX package's Pallas kernels in interpret mode; on the CPU the port
takes its kernels' plain versions). Tolerances are those of
tests/test_render_golden.py: colours and weights are tight, while sample
positions (z_vals, pred_hyp, z_std, depth) pass through the inverse CDF,
where ~1e-6 of weight noise moves an interpolated position by ~1e-3 on a
[0.5, 6] ray.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from conftest import load_golden
from scade_tpu.models.nerf import nerf_init, params_to_torch_state_dict
from scade_tpu.ops import fused_mlp as jfused_mlp
from scade_tpu.render import renderer as jrenderer
from scade_tpu_torch.models.nerf import NeRF
from scade_tpu_torch.render import renderer

TOL = {
    "rgb_map": 2e-5, "depth_map": 1e-3, "acc_map": 2e-5, "weights": 2e-4, "z_vals": 3e-3,
    "pred_hyp": 3e-3, "u": 1e-6, "rgb0": 2e-5, "depth0": 1e-3, "acc0": 2e-5,
    "weights0": 2e-4, "z_vals0": 1e-6, "z_std": 3e-3, "disp_map": 1e-3, "disp0": 1e-3,
}
SMALL = dict(multires=4, netwidth=64, netwidth_fine=64, n_samples=8, n_importance=16)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)
    monkeypatch.setattr(jfused_mlp.pl, "pallas_call", interp)


def load(cfg, state_dict):
    model = NeRF(cfg)
    model.load_state_dict({k.removeprefix("module."): torch.from_numpy(np.array(v))
                           for k, v in state_dict.items()}, strict=True)
    return model


def scenes(n_importance=16, seed=0, **jax_flags):
    jrc = jrenderer.make_render_config(**dict(SMALL, n_importance=n_importance), **jax_flags)
    kc, kf = jax.random.split(jax.random.PRNGKey(seed))
    pc = nerf_init(kc, jrc.nerf_coarse)
    pf = nerf_init(kf, jrc.nerf_fine) if jrc.nerf_fine is not None else pc
    jscene = jrenderer.SceneVars(pc, pf, jnp.zeros((3,)), jnp.float32(0.5), jnp.zeros((0,)))
    rc = renderer.make_render_config(**dict(SMALL, n_importance=n_importance), device="cpu")
    coarse = load(rc.nerf_coarse, params_to_torch_state_dict(jax.tree.map(np.asarray, pc)))
    fine = (load(rc.nerf_fine, params_to_torch_state_dict(jax.tree.map(np.asarray, pf)))
            if rc.nerf_fine is not None else coarse)
    scene = renderer.SceneVars(coarse, fine, torch.zeros(3), torch.tensor(0.5), torch.zeros(0))
    return jrc, jscene, rc, scene


def rays(n=32, seed=1):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def compare(ours, ref, tol=TOL):
    for k in ref:
        np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(ref[k]), atol=tol[k],
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("fused", [True, False])
def test_render_rays_matches_jax(interpret_mode, fused):
    """Both packages with their kernels' dispatch on (the JAX package's Pallas
    kernels in interpret mode) or both off."""
    jrc, jscene, rc, scene = scenes(use_fused=fused, fused_sampling=fused, fused_tile=1024)
    rc = dataclasses.replace(rc, use_fused=fused, fused_sampling=fused)
    ro, rd = rays()
    u = np.random.default_rng(2).uniform(size=(32, 16)).astype(np.float32)
    ref = jrenderer.render_rays(jscene, jrc, ro, rd, 0.1, 10.0, cached_u=jnp.asarray(u))
    ours = renderer.render_rays(scene, rc, torch.from_numpy(ro), torch.from_numpy(rd), 0.1,
                                10.0, cached_u=torch.from_numpy(u))
    assert set(ours) == set(ref)
    compare(ours, ref)


def test_single_network_branch_matches_jax():
    """n_importance == 0: two tiers of P_depth draws, with the fix of the
    reference's undefined-u bug."""
    jrc, jscene, rc, scene = scenes(n_importance=0)
    ro, rd = rays(seed=3)
    u = np.random.default_rng(4).uniform(size=(32, 8)).astype(np.float32)
    ref = jrenderer.render_rays(jscene, jrc, ro, rd, 0.1, 10.0, cached_u=jnp.asarray(u))
    ours = renderer.render_rays(scene, rc, torch.from_numpy(ro), torch.from_numpy(rd), 0.1,
                                10.0, cached_u=torch.from_numpy(u))
    assert set(ours) == set(ref)
    # here the MLP is queried at the first tier's resampled positions, whose
    # ~1e-3 of conditioning moves the weights by ~3e-4, and the second tier
    # resamples from those weights: its draws (half of pred_hyp) agree to
    # ~1.4e-2 on a [0.1, 10] ray
    compare(ours, ref, dict(TOL, weights=1e-3, pred_hyp=3e-2))


def k1_calls(monkeypatch) -> list:
    """Whether the points wanted a gradient, for each call of K1's wrapper
    the renderer makes."""
    wants_grad = []
    k1 = renderer.fused_nerf_apply
    monkeypatch.setattr(renderer, "fused_nerf_apply", lambda model, cfg, pts, *args: (
        wants_grad.append(pts.requires_grad) or k1(model, cfg, pts, *args)))
    return wants_grad


def test_single_network_second_pass_runs_k1_only_on_points_without_a_gradient(monkeypatch):
    """Single-network mode queries the MLP a second time at points drawn
    from the coarse weights. While training they carry a gradient, which
    K1's backward does not give, so that pass runs the plain MLP, and the
    renderer says the step is not all on the kernels."""
    _, _, rc, scene = scenes(n_importance=0)
    wants_grad = k1_calls(monkeypatch)
    ro, rd = (torch.from_numpy(x) for x in rays(seed=3))
    assert renderer.render_rays(scene, rc, ro, rd, 0.1, 10.0)["rgb_map"].requires_grad
    assert wants_grad == [False]
    with torch.no_grad():
        renderer.render_rays(scene, rc, ro, rd, 0.1, 10.0)
    assert wants_grad == [False] * 3
    assert not renderer.on_kernels(rc)
    assert renderer.on_kernels(renderer.make_render_config(**SMALL, device="cpu"))


def test_coarse_and_fine_passes_run_k1_whatever_their_points_want(monkeypatch):
    """Only single-network mode's second pass leaves K1. Rays that carry a
    gradient still send both passes of the default mode to K1, whose
    backward raises for it on the card (tests/test_torch_cuda.py) and, on
    the CPU, gives the plain recompute's."""
    _, _, rc, scene = scenes()
    wants_grad = k1_calls(monkeypatch)
    ro, rd = (torch.from_numpy(x) for x in rays(seed=3))
    ro.requires_grad_()
    out = renderer.render_rays(scene, rc, ro, rd, 0.1, 10.0)
    assert wants_grad == [True, True]
    (g,) = torch.autograd.grad(out["rgb_map"].sum(), ro)  # the fine pass alone
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_render_golden():
    g = load_golden("render_rays_e2e")
    rc = renderer.make_render_config(multires=4, netwidth=64, netwidth_fine=64, n_samples=8,
                                     n_importance=16, perturb=False, device="cpu")
    sd = {"coarse": {}, "fine": {}}
    for k in g.files:
        if k.startswith("sd_"):
            which, name = k[3:].split(".", 1)
            sd[which][name] = g[k]
    scene = renderer.SceneVars(load(rc.nerf_coarse, sd["coarse"]), load(rc.nerf_fine, sd["fine"]),
                               torch.from_numpy(g["bb_center"]),
                               torch.from_numpy(np.array(g["bb_scale"])), torch.zeros(0))
    with torch.no_grad():
        out = renderer.render_rays(scene, rc, torch.from_numpy(g["rays_o"]),
                                   torch.from_numpy(g["rays_d"]), float(g["near"]),
                                   float(g["far"]))
    for key, atol in TOL.items():
        if "out_" + key in g.files:
            np.testing.assert_allclose(out[key].numpy(), g["out_" + key], atol=atol, rtol=1e-4,
                                       err_msg=key)


def test_render_ray_batch_chunks_and_per_ray_bounds():
    _, _, rc, scene = scenes()
    ro, rd = rays(n=37, seed=5)
    near = np.linspace(0.1, 0.3, 37).astype(np.float32)
    far = np.full(37, 8.0, np.float32)
    ro_t, rd_t = torch.from_numpy(ro), torch.from_numpy(rd)
    with torch.no_grad():
        whole = renderer.render_rays(scene, rc.test_mode(), ro_t, rd_t,
                                     torch.from_numpy(near)[:, None],
                                     torch.from_numpy(far)[:, None])
        tiled = renderer.render_ray_batch(scene, rc.test_mode(), ro_t, rd_t,
                                          torch.from_numpy(near), torch.from_numpy(far),
                                          chunk=16, outputs=("rgb_map", "pred_hyp"))
    assert set(tiled) == {"rgb_map", "pred_hyp"}
    for k in tiled:
        np.testing.assert_allclose(tiled[k].numpy(), whole[k].numpy(), atol=1e-6, rtol=0)


def test_render_image_matches_jax():
    jrc, jscene, rc, scene = scenes()
    intr = np.array([6.0, 6.0, 4.0, 3.0], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.05, -0.02, 0.1]
    ref = jrenderer.render_image(jscene, jrc, 6, 8, intr, c2w, 0.1, 6.0, chunk=16,
                                 outputs=("rgb_map", "depth_map"))
    ours = renderer.render_image(scene, rc, 6, 8, intr, c2w, 0.1, 6.0, chunk=16,
                                 outputs=("rgb_map", "depth_map"))
    assert ours["rgb_map"].shape == (6, 8, 3) and ours["depth_map"].shape == (6, 8)
    compare(ours, ref)


def test_stochastic_path_law():
    """With a generator: jittered, sorted, finite, and reproducible per seed."""
    _, _, rc, scene = scenes()
    ro, rd = (torch.from_numpy(a) for a in rays())

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return renderer.render_rays(scene, rc, ro, rd, 0.1, 10.0, generator=gen)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a["pred_hyp"], b["pred_hyp"])
    assert not torch.equal(a["z_vals0"], c["z_vals0"])  # jitter moved the strata
    z = a["z_vals"]
    assert (z[:, 1:] >= z[:, :-1]).all() and z.shape == (32, 24)
    assert all(torch.isfinite(v).all() for v in a.values())
    assert ((a["u"] >= 0) & (a["u"] < 1)).all()
