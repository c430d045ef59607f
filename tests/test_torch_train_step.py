"""The port's train step against scade_tpu's step arithmetic: equal weights, a
fixed batch, deterministic draws and a shared P_depth u, two steps across a
freeze_ss boundary; loss, gradients and post-step state against jax.grad of
the same loss plus optax Adam.

The initial density head is shrunk on both sides (smooth_density), so that the
inverse CDF is well conditioned; with spiky random-init weights the fine
samples of either framework sit ~1e-3 from a float64 run's and the fine
gradients differ by percents on both sides (see test_torch_render.py).

Tolerances: the loss 1e-5 relative; gradients 1e-4 of each tensor's largest
entry (measured 2e-6: f32 sums in other orders). Adam's first steps move
each parameter by about lr * sign(g), so a gradient entry within roundoff of
zero may move the opposite way on the two sides: post-step parameters agree
to 1e-6 where the JAX gradient was above 1e-3 of its tensor's largest entry
at every step so far, and to 2 lr per step everywhere. The Adam arithmetic
itself is held to optax's at 1e-7 on shared gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scade_tpu.models.nerf import params_to_torch_state_dict
from scade_tpu.ops.losses import compute_space_carving_loss as j_sc_loss
from scade_tpu.ops.losses import img2mse as j_img2mse
from scade_tpu.render import renderer as jrenderer
from scade_tpu.train import step as jstep
from scade_tpu_torch.render.renderer import make_render_config
from scade_tpu_torch.train import step

H = W = 16
N_TRAIN, N_REL, K = 2, 3, 4
SMALL = dict(multires=4, netwidth=64, netwidth_fine=64, n_samples=8, n_importance=16)


def tiny_scene_np(seed=0):
    rng = np.random.default_rng(seed)
    intr = np.broadcast_to(np.array([8.0, 8.0, 8.0, 8.0], np.float32), (N_REL, 4)).copy()
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (N_REL, 4, 4)).copy()
    poses[:, :3, 3] = rng.normal(size=(N_REL, 3)) * 0.05
    return dict(
        images=rng.uniform(size=(N_REL, H, W, 3)).astype(np.float32),
        poses=poses,
        intrinsics=intr,
        hyps=rng.uniform(1.0, 5.0, size=(N_TRAIN, K, H, W, 1)).astype(np.float32),
        near=np.float32(0.1), far=np.float32(10.0),
        bb_center=np.zeros(3, np.float32), bb_scale=np.float32(0.5),
    )


def port_scene(d):
    return step.SceneTensors(**{k: torch.as_tensor(np.array(v)) for k, v in d.items()})


def jax_scene(d):
    return jstep.SceneTensors(**{k: jnp.asarray(v) for k, v in d.items()})


def port_state_like(jstate, rc, tc):
    state = step.create_train_state(0, rc, tc, N_REL)
    for model, which in ((state.model_coarse, "coarse"), (state.model_fine, "fine")):
        sd = params_to_torch_state_dict(jax.tree.map(np.asarray, jstate.params[which]), prefix="")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        state.scales.copy_(torch.from_numpy(np.array(jstate.scales)))
        state.shifts.copy_(torch.from_numpy(np.array(jstate.shifts)))
    return state


def smooth_density(jstate):
    """Shrinks the initial density head so that the termination weights are
    smooth: the inverse CDF is then well conditioned and the fine samples sit
    at the same positions on both sides to ~1e-6, not ~1e-3."""
    params = jax.tree.map(lambda x: x, jstate.params)
    for which in ("coarse", "fine"):
        head = dict(params[which]["alpha_linear"])
        head["kernel"] = head["kernel"] * 0.05
        params[which] = dict(params[which], alpha_linear=head)
    return jstate._replace(params=params)


def make_jax_step(jrc, tc, jscene):
    """One step of scade_tpu/train/step.py's arithmetic on a given batch with
    deterministic draws: the body of its step_fn after sample_ray_batch."""
    nerf_opt, ss_opt = jstep.make_optimizers(tc)

    def loss_fn(diff, step_count, batch, u):
        rays_o, rays_d, target_s, target_h, sc_mask, img_i = batch
        sv = jrenderer.SceneVars(diff["params"]["coarse"], diff["params"]["fine"],
                                 jscene.bb_center, jscene.bb_scale, jnp.zeros((0,)))
        out = jrenderer.render_rays(sv, jrc, rays_o, rays_d, jscene.near, jscene.far,
                                    key=None, cached_u=u)
        loss = j_img2mse(out["rgb_map"], target_s)
        th = target_h * diff["scales"][img_i] + diff["shifts"][img_i]
        sc = j_sc_loss(out["pred_hyp"], th, is_joint=tc.is_joint, mask=sc_mask,
                       norm_p=tc.norm_p, threshold=tc.space_carving_threshold)
        active = step_count + 1 > tc.warm_start_nerf
        loss = loss + jnp.where(active, tc.space_carving_weight, 0.0) * sc
        return loss + j_img2mse(out["rgb0"], target_s)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))  # compiled once for both steps
    return lambda jstate, batch, u: jax_step(nerf_opt, ss_opt, grad_fn, tc, jstate, batch, u)


def jax_step(nerf_opt, ss_opt, grad_fn, tc, jstate, batch, u):
    diff = {"params": jstate.params, "scales": jstate.scales, "shifts": jstate.shifts}
    loss, grads = grad_fn(diff, jstate.step, batch, u)
    updates, opt_state = nerf_opt.update(grads["params"], jstate.opt_state, jstate.params)
    params = optax.apply_updates(jstate.params, updates)
    ss_params = {"scales": jstate.scales, "shifts": jstate.shifts}
    ss_updates, ss_opt_state = ss_opt.update(
        {"scales": grads["scales"], "shifts": grads["shifts"]}, jstate.ss_opt_state, ss_params)
    frozen = jstate.step + 1 >= tc.freeze_ss
    ss_updates = jax.tree.map(lambda v: jnp.where(frozen, jnp.zeros_like(v), v), ss_updates)
    ss_new = optax.apply_updates(ss_params, ss_updates)
    new = jstep.TrainState(params, opt_state, ss_new["scales"], ss_new["shifts"], ss_opt_state,
                           jstate.step + 1)
    return new, loss, grads


def as_state_dict(params):
    return params_to_torch_state_dict(jax.tree.map(np.asarray, params), prefix="")


def test_two_steps_match_jax_across_freeze_boundary():
    tc = step.TrainConfig(n_rand=32, scaleshift_lr=1e-2, freeze_ss=2)
    jtc = jstep.TrainConfig(n_rand=32, scaleshift_lr=1e-2, freeze_ss=2)
    jrc = jrenderer.make_render_config(**SMALL)
    rc = make_render_config(**SMALL, device="cpu")
    d = tiny_scene_np()
    jscene, scene = jax_scene(d), port_scene(d)
    jstate = jstep.create_train_state(jax.random.PRNGKey(0), jrc, jtc, n_images=N_REL)
    jstate = smooth_density(jstate)
    state = port_state_like(jstate, rc, tc)
    rng = np.random.default_rng(7)
    clear = {}  # entries whose gradient was clear of roundoff at every step so far
    run_jax_step = make_jax_step(jrc, jtc, jscene)

    for i in range(2):
        jbatch = jstep.sample_ray_batch(jax.random.PRNGKey(10 + i), jscene, H, W, N_TRAIN, jtc)
        batch = step.RayBatch(*[torch.from_numpy(np.array(x)) if x is not None else None
                                for x in jbatch])
        u = rng.uniform(size=(32, 16)).astype(np.float32)
        scales_before = state.scales.detach().clone()
        jnew, jloss, jgrads = run_jax_step(jstate, jbatch, jnp.asarray(u))
        grads, g_scales, g_shifts, metrics = step.compute_grads(
            state, scene, batch, rc, tc, cached_u=torch.from_numpy(u))
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)

        names = [n for n, _ in state.model_coarse.named_parameters()]
        jg = {"coarse": as_state_dict(jgrads["params"]["coarse"]),
              "fine": as_state_dict(jgrads["params"]["fine"])}
        ported = dict(zip([("coarse", n) for n in names] + [("fine", n) for n in names], grads))
        for (which, name), g in ported.items():
            ref = jg[which][name]
            np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                       err_msg=f"{which}.{name}")
        for g, ref in ((g_scales, jgrads["scales"]), (g_shifts, jgrads["shifts"])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())

        step.apply_grads(state, grads, g_scales, g_shifts, tc, N_TRAIN, metrics)
        jstate = jnew
        assert state.step == int(jstate.step) == i + 1
        lr = step.staircase_lr(tc, i)
        for which, model in (("coarse", state.model_coarse), ("fine", state.model_fine)):
            ref_p = as_state_dict(jstate.params[which])
            for name, p in model.named_parameters():
                big = np.abs(jg[which][name]) > 1e-3 * np.abs(jg[which][name]).max()
                clear[which, name] = clear.get((which, name), True) & big
                diff = np.abs(p.detach().numpy() - ref_p[name])
                assert diff.max() <= 2 * lr * (i + 1), f"{which}.{name}"
                assert diff[clear[which, name]].max(initial=0.0) <= 1e-6, f"{which}.{name}"
        np.testing.assert_allclose(state.scales.detach().numpy(), np.asarray(jstate.scales),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(state.shifts.detach().numpy(), np.asarray(jstate.shifts),
                                   atol=1e-6, rtol=0)
        if i == 0:
            assert not torch.equal(state.scales.detach(), scales_before)
        else:  # frozen: the value stays, the moments still advance
            assert torch.equal(state.scales.detach(), scales_before)
            assert state.ss_opt.count == 2
        np.testing.assert_allclose(state.ss_opt.nu[0].numpy(),
                                   np.asarray(jstate.ss_opt_state[0].nu["scales"]),
                                   rtol=2e-3, atol=0)


def test_adam_update_matches_optax():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    tc = step.TrainConfig(lrate=1e-2, decay_step=2, decay_rate=0.5)
    opt = optax.adam(learning_rate=jstep.staircase_lr(jstep.TrainConfig(
        lrate=1e-2, decay_step=2, decay_rate=0.5)))
    jp, jopt = jnp.asarray(p0), None
    jopt = opt.init(jp)
    p = torch.from_numpy(p0.copy())
    state = step.AdamState.zeros_like([p])
    for i in range(4):
        g = rng.normal(size=(5, 7)).astype(np.float32) * 10.0 ** (i - 2)
        upd, jopt = opt.update(jnp.asarray(g), jopt, jp)
        jp = optax.apply_updates(jp, upd)
        step.adam_update([p], [torch.from_numpy(g)], state,
                         step.adam_feed(step.staircase_lr(tc, state.count), state.count + 1, "cpu"))
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(state.nu[0].numpy(), np.asarray(jopt[0].nu), rtol=1e-6)
    assert [step.staircase_lr(tc, c) for c in range(4)] == pytest.approx(
        [float(jstep.staircase_lr(jstep.TrainConfig(lrate=1e-2, decay_step=2,
                                                    decay_rate=0.5))(c)) for c in range(4)])


def test_pixel_sampling_laws():
    gen = torch.Generator().manual_seed(0)
    for mode in ("stratified", "choice", "iid"):
        tc = step.TrainConfig(n_rand=32, pixel_sampling=mode)
        pix = step.select_pixels(gen, H, W, tc).numpy()
        assert pix.shape == (32,) and pix.min() >= 0 and pix.max() < H * W
        if mode != "iid":
            assert len(np.unique(pix)) == 32, mode
    # one pixel per stratum, also when n_rand does not divide H*W
    for hh, ww in ((16, 16), (15, 20)):
        tc = step.TrainConfig(n_rand=32)
        b = np.arange(33, dtype=np.int64) * (hh * ww) // 32
        for _ in range(20):
            pix = step.select_pixels(gen, hh, ww, tc).numpy()
            assert len(np.unique(pix)) == 32
            assert (pix >= b[:-1]).all() and (pix < b[1:]).all()
    with pytest.raises(ValueError):
        step.select_pixels(gen, H, W, step.TrainConfig(pixel_sampling="sorted"))


def test_batch_gather_and_masks():
    scene = port_scene(tiny_scene_np())
    gen = torch.Generator().manual_seed(1)
    tc = step.TrainConfig(n_rand=32, mask_corners=True)
    b = step.sample_ray_batch(gen, scene, H, W, N_TRAIN, tc)
    assert b.rays_o.shape == (32, 3) and b.target_s.shape == (32, 3)
    assert b.target_h.shape == (K, 32, 1) and b.sc_mask.shape == (32,)
    assert 0 <= int(b.img_i) < N_TRAIN
    rows = torch.arange(H)[:, None].expand(H, W).reshape(-1)
    cols = torch.arange(W)[None, :].expand(H, W).reshape(-1)
    corner = step._corner_mask(rows, cols, H, W, n_pix=4)
    edge = step._edge_mask(rows, cols, H, W, n_pix=2)
    assert int((corner == 0).sum()) == 4 * 16 and int((edge == 0).sum()) == H * W - 12 * 12
    b = step.sample_ray_batch(gen, scene, H, W, N_TRAIN, step.TrainConfig(n_rand=32))
    assert b.sc_mask is None


def test_train_step_runs_gates_and_freezes():
    rc = make_render_config(**SMALL, device="cpu")
    scene = port_scene(tiny_scene_np())
    for tc in (step.TrainConfig(n_rand=32, scaleshift_lr=1e-2),
               step.TrainConfig(n_rand=32, scaleshift_lr=1e-2, warm_start_nerf=10),
               step.TrainConfig(n_rand=32, scaleshift_lr=1e-2, freeze_ss=1)):
        state = step.create_train_state(0, rc, tc, N_REL)
        before = [p.detach().clone() for p in state.nerf_params()]
        scales = state.scales.detach().clone()
        fn = step.make_train_step(rc, tc, H, W, N_TRAIN)
        metrics = fn(state, scene, torch.Generator().manual_seed(3))
        assert state.step == 1 and np.isfinite(float(metrics["loss"]))
        assert np.isfinite(float(metrics["psnr"])) and np.isfinite(float(metrics["psnr0"]))
        assert any(not torch.equal(a, p) for a, p in zip(before, state.nerf_params()))
        expect = float(metrics["img_loss"]) + float(metrics["img_loss0"])
        if tc.warm_start_nerf:
            assert float(metrics["space_carving_loss"]) == 0.0
            assert float(metrics["loss"]) == pytest.approx(expect, abs=1e-6)
        else:
            assert float(metrics["loss"]) > expect
        moved = not torch.equal(state.scales.detach(), scales)
        assert moved == (tc.warm_start_nerf == 0 and tc.freeze_ss > 1)
        assert metrics["lr"] == pytest.approx(5e-4)


def test_train_config_defaults_match_jax():
    ours = dataclasses.asdict(step.TrainConfig())
    theirs = dataclasses.asdict(jstep.TrainConfig())
    assert ours == theirs
