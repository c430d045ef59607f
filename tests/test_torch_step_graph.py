"""The NeRF train step replayed as CUDA graphs (``train/step.py::TrainStep``).

On the CPU: Adam with its scalars as 0-d tensors (``AdamFeed``, what a
captured step reads) is the scalar form bit for bit, at counts where XLA's
power and the exact one part ways (2,958, 3,606) and far out (400,000); the
feed's writer writes ``staircase_lr`` and the bias corrections of
``adam_scalars``; ``apply_grads`` with feeds equals it without; a launch
captured into a graph counts nowhere at the capture and once at each
replay (``_kernels.tally``); ``capture_key`` is a pure function of the
tensors and the step's host decisions; off the card, with ranks, with the
``choice`` pixel law or where the renderer does not run the whole step on
the kernels (``renderer.on_kernels``: the plain path, a camera latent) the
step runs eagerly and counts no capture.

On the card (skipped without one), at the ScanNet cell's shapes (8x256
nets, 64 + 128 samples, 1,024 rays, K=20, 20 views at 468x624, both kernels
on, f32): steps through the graphs are bit-equal to as many eager steps
(parameters, both Adams' moments, every metric) across the capture, and
across the learning rate's decay, space carving's start and scale/shift's
freeze, each of which captures again; a replaced state captures again and
never replays the old graphs, while values written in place are read by
the replay, and another generator captures again; the kernels' launch
counters advance as the eager step's (2, 2, 1, 2 a step) and by nothing at
a capture, and in a replay by as many of each kernel as the device trace
shows; replayed steps run under
``torch.cuda.set_sync_debug_mode("error")``. The file imports neither JAX
nor scade_tpu.
"""

import copy
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from scade_tpu_torch import _kernels
from scade_tpu_torch.ops import fused_mlp, fused_sampling
from scade_tpu_torch.ops.arith import f32, fma
from scade_tpu_torch.parallel.dist import Ranks
from scade_tpu_torch.render import renderer
from scade_tpu_torch.train import step

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


def bc_of(b: float, count: int) -> float:
    """1 - b^count in float32, b^count float32(b) raised exactly and rounded."""
    return float(np.float32(1.0 - np.float32(np.float64(np.float32(b)) ** count)))


# --- CPU -------------------------------------------------------------------


def scalar_adam(params, grads, state, lr, apply):
    """Adam as the eager step ran it before its scalars moved to the
    device: f32(-lr) a Python float, the bias corrections 0-d tensors."""
    state.count += 1
    flat = lambda ts: torch.cat([t.reshape(-1) for t in ts])  # noqa: E731
    g = flat(torch.zeros_like(p) if g is None else g for p, g in zip(params, grads))
    mu = fma(g, f32(1.0 - 0.9), flat(state.mu) * f32(0.9))
    nu = fma(g * g, f32(1.0 - 0.999), flat(state.nu) * f32(0.999))
    for ts, x in ((state.mu, mu), (state.nu, nu)):
        for t, c in zip(ts, x.split([t.numel() for t in ts])):
            t.copy_(c.view_as(t))
    if apply:
        bc1, bc2 = (torch.tensor(bc_of(b, state.count)) for b in (0.9, 0.999))
        den = torch.sqrt((nu / bc2).double()).float().add_(f32(1e-8)).mul_(bc1)
        new = fma(mu / den, f32(-lr), flat(params))
        for p, c in zip(params, new.split([p.numel() for p in params])):
            p.copy_(c.view_as(p))


@pytest.mark.parametrize("apply", [True, False])
@pytest.mark.parametrize("count", [1, 2, 2958, 3606, 400000])
def test_adam_update_with_a_feed_is_the_scalar_form(count, apply):
    gen = torch.Generator().manual_seed(count)
    shapes = [(7, 5), (5,), (3, 1)]
    params = [torch.randn(s, generator=gen) for s in shapes]
    grads = [torch.randn(s, generator=gen) for s in shapes[:2]] + [None]
    moments = [(torch.randn(s, generator=gen) * 1e-3, torch.rand(s, generator=gen) * 1e-6)
               for s in shapes]
    lr = 5e-4 * 0.1 ** (count // 400000)
    states = [step.AdamState([m.clone() for m, _ in moments], [v.clone() for _, v in moments],
                             count - 1) for _ in range(2)]
    ps = [[p.clone() for p in params] for _ in range(2)]
    scalar_adam(ps[0], grads, states[0], lr, apply)
    feed = step.adam_feed(lr, count, "cpu")
    assert feed.neg_lr.dtype == torch.float64 and feed.bc1.dtype == torch.float32
    step.adam_update(ps[1], grads, states[1], feed, apply=apply)
    assert states[0].count == states[1].count == count
    for a, b in zip(ps[0] + states[0].mu + states[0].nu, ps[1] + states[1].mu + states[1].nu):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(ps[0], params)) == (not apply)


@pytest.mark.parametrize("start", [1, 160, 2950, 20000, 399990])
def test_feed_writes_the_learning_rate_and_bias_corrections(start):
    tc = step.TrainConfig()
    feed = step.adam_feed(float("nan"), 1, "cpu")
    for count in range(start, start + 20):
        lr = step.staircase_lr(tc, count - 1)
        assert lr == tc.lrate * tc.decay_rate ** (count // tc.decay_step)
        step.write_feed(feed, lr, count)
        neg_lr, bc1, bc2 = feed
        assert neg_lr.dtype == torch.float64 and bc1.dtype == bc2.dtype == torch.float32
        assert float(neg_lr) == f32(-lr) and float(bc1) == bc_of(0.9, count)
        assert float(bc2) == bc_of(0.999, count)
        assert step.adam_scalars(lr, count) == (f32(-lr), bc_of(0.9, count), bc_of(0.999, count))
        made = step.adam_feed(lr, count, "cpu")
        assert all(torch.equal(a, b) for a, b in zip(made, feed))
    if start >= 20000:  # both corrections are 1 by then
        assert float(feed.bc1) == float(feed.bc2) == 1.0


def test_a_captured_launch_counts_at_each_replay_and_not_at_capture(monkeypatch):
    def launcher():
        pass

    def other():
        pass

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    launcher.launches = other.launches = launcher.kept = 0
    _kernels.count_launch(launcher)
    _kernels.count_launch(launcher, "kept")  # a second counter of the same launcher
    assert (launcher.launches, launcher.kept) == (1, 1)
    capturing[0] = True
    _kernels.count_launch(launcher)  # captured with no tally open: counted nowhere
    with _kernels.tally() as outer:
        _kernels.count_launch(launcher)
        with _kernels.tally() as inner:
            _kernels.count_launch(launcher)
            _kernels.count_launch(launcher, "kept")
            _kernels.count_launch(other)
    assert (launcher.launches, launcher.kept, other.launches) == (1, 1, 0)
    assert outer == [(launcher, "launches")]
    assert inner == [(launcher, "launches"), (launcher, "kept"), (other, "launches")]
    for _ in range(3):
        _kernels.count_replay(inner)
    assert (launcher.launches, launcher.kept, other.launches) == (4, 4, 3)


SMALL = dict(multires=4, netwidth=64, netwidth_fine=64, n_samples=8, n_importance=16)


def tiny(tc=None, seed=0):
    from test_torch_sync_free_step import N_REL, tiny_scene

    tc = tc or step.TrainConfig(n_rand=40)
    rc = renderer.make_render_config(**SMALL, device="cpu")
    return rc, tc, tiny_scene(seed), step.create_train_state(seed, rc, tc, N_REL)


def test_apply_grads_with_feeds_is_apply_grads():
    from test_torch_sync_free_step import H, N_TRAIN, W

    rc, tc, scene, state = tiny(step.TrainConfig(n_rand=40, scaleshift_lr=1e-3, decay_step=3))
    for i in range(6):
        gen = torch.Generator().manual_seed(i)
        batch = step.sample_ray_batch(gen, scene, H, W, N_TRAIN, tc)
        grads, g_s, g_sh, metrics = step.compute_grads(state, scene, batch, rc, tc, generator=gen)
        other = copy.deepcopy(state)
        feeds = (step.adam_feed(0.0, 1, "cpu"), step.adam_feed(0.0, 1, "cpu"))
        step.write_feed(feeds[0], step.staircase_lr(tc, other.opt.count), other.opt.count + 1)
        step.write_feed(feeds[1], tc.scaleshift_lr, other.ss_opt.count + 1)
        got = step.apply_grads(other, grads, g_s, g_sh, tc, N_TRAIN, dict(metrics),
                               feeds=feeds)
        want = step.apply_grads(state, grads, g_s, g_sh, tc, N_TRAIN, dict(metrics))
        assert list(got) == list(want)
        for k in want:
            assert got[k] == want[k] if k == "lr" else torch.equal(got[k], want[k]), k
        for a, b in zip(state.nerf_params() + [state.scales, state.shifts] + state.opt.mu
                        + state.opt.nu + state.ss_opt.mu + state.ss_opt.nu,
                        other.nerf_params() + [other.scales, other.shifts] + other.opt.mu
                        + other.opt.nu + other.ss_opt.mu + other.ss_opt.nu):
            assert torch.equal(a, b)
        assert (other.step, other.opt.count, other.ss_opt.count) == (
            state.step, state.opt.count, state.ss_opt.count) == (i + 1, i + 1, i + 1)


def _replace_param(state, scene):
    state.model_fine.pts_linears[0].weight.data = state.model_fine.pts_linears[0].weight.clone()


def _replace_moment(state, scene):
    state.opt.nu[3] = state.opt.nu[3].clone()


def _replace_scales(state, scene):
    state.scales = state.scales.detach().clone().requires_grad_(True)


def _replace_hyps(state, scene):
    scene.hyps = scene.hyps.clone()


def _reshape_images(state, scene):
    scene.images = scene.images.view(scene.images.shape[0], -1, 3)


def _stop_space_carving(state, scene):
    state.step = 3  # warm_start_nerf 5: active from the sixth step


def _freeze(state, scene):
    state.step = 9  # freeze_ss 10: frozen from the tenth


def _new_generator(state, scene):
    pass


CHANGES = {"param": _replace_param, "moment": _replace_moment, "scales": _replace_scales,
           "hyps": _replace_hyps, "images_shape": _reshape_images,
           "space_carving": _stop_space_carving, "frozen": _freeze,
           "generator": _new_generator}


@pytest.mark.parametrize("change", list(CHANGES))
def test_capture_key_is_a_pure_function(change):
    tc = step.TrainConfig(n_rand=40, warm_start_nerf=5, freeze_ss=10)
    _, _, scene, state = tiny(tc)
    state.step = 5
    gen = torch.Generator()
    key = step.capture_key(state, scene, gen, tc)
    assert step.capture_key(state, scene, gen, tc) == key
    # the same tensors in a new state and scene object: the same key
    assert step.capture_key(copy.copy(state), copy.copy(scene), gen, tc) == key
    CHANGES[change](state, scene)
    if change == "generator":
        gen = torch.Generator()
    assert step.capture_key(state, scene, gen, tc) != key


def test_step_runs_eagerly_off_the_card_and_where_not_capturable():
    rc, tc, scene, state = tiny()
    from test_torch_sync_free_step import H, N_TRAIN, W

    assert renderer.on_kernels(rc) and step.capturable(rc, tc)
    assert not step.capturable(rc, step.TrainConfig(pixel_sampling="choice"))
    plain = renderer.make_render_config(**SMALL, use_fused=False, fused_sampling=False,
                                        device="cpu")
    assert not renderer.on_kernels(plain) and not step.capturable(plain, tc)
    # a camera latent: the plain MLP, whose encoding copies from the host
    latent = renderer.make_render_config(**SMALL, input_ch_cam=4, device="cpu")
    assert latent.use_fused and not renderer.on_kernels(latent)
    assert not step.capturable(latent, tc)
    # single-network mode: its second pass is plain while training, and the
    # plain recompute's encoding copies from the host
    single = renderer.make_render_config(**dict(SMALL, n_importance=0), device="cpu")
    assert not step.capturable(single, tc)
    # the step asks the renderer: with a pixel law that allows graphs, they agree
    assert all(step.capturable(c, tc) == renderer.on_kernels(c)
               for c in (rc, plain, latent, single))
    assert not step.make_train_step(latent, tc, H, W, N_TRAIN).graphed
    assert not step.make_train_step(rc, tc, H, W, N_TRAIN, ranks=Ranks(0, 2)).graphed
    step_fn = step.make_train_step(rc, tc, H, W, N_TRAIN)
    assert step_fn.graphed
    other = copy.deepcopy(state)
    for i in range(3):
        gen = torch.Generator().manual_seed(i)
        got = step_fn(state, scene, gen)
        want = step_fn.eager(other, scene, gen.manual_seed(i))
        assert all(torch.equal(got[k], want[k]) for k in want if k != "lr")
    assert step_fn.captures == step_fn.replays == 0
    assert all(torch.equal(a, b) for a, b in zip(state.nerf_params(), other.nerf_params()))


# --- the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def cell(cuda, tc):
    from host_syncs import H, N_TRAIN, N_VAL, W, ring_scene

    scene = ring_scene(cuda, seed=4)
    rc = renderer.make_render_config()
    state = step.create_train_state(0, rc, tc, n_images=N_TRAIN + N_VAL)
    with torch.no_grad():  # a scale and shift of their own for every view
        g = torch.Generator(device=cuda).manual_seed(5)
        n = N_TRAIN + N_VAL
        state.scales.copy_(1.0 + 0.2 * torch.rand(n, 1, generator=g, device=cuda))
        state.shifts.copy_(0.1 * torch.randn(n, 1, generator=g, device=cuda))
    return rc, scene, state, step.make_train_step(rc, tc, H, W, N_TRAIN)


def counters():
    """The kernels' launch counters, then K1's forwards that kept what its
    backward reads."""
    return (fused_mlp.fused_mlp_cuda.launches, fused_sampling.sample_pdf_cuda.launches,
            fused_sampling.sample_pdf_backward_cuda.launches,
            fused_mlp.fused_mlp_backward_cuda.launches, fused_mlp.fused_mlp_cuda.kept)


def leaves(st):
    return (st.nerf_params() + [st.scales, st.shifts] + st.opt.mu + st.opt.nu + st.ss_opt.mu
            + st.ss_opt.nu)


def run(fn, state, scene, seeds, gen):
    """The steps of ``seeds``, ``gen`` reseeded for each as the loop does (a
    step's graphs draw from the generator they were captured with): every
    step's metrics (cloned) and launches."""
    metrics, launches = [], []
    for s in seeds:
        before = counters()
        gen.manual_seed((7 << 32) + s)
        m = fn(state, scene, gen)
        metrics.append({k: v if k == "lr" else v.clone() for k, v in m.items()})
        launches.append(tuple(a - b for a, b in zip(counters(), before)))
    torch.cuda.synchronize()
    return metrics, launches


# (steps, TrainConfig, captures, replays): the defaults; the learning rate's
# decay at counts 2 and 5, space carving from step 2 (before it, no draw
# carries a gradient: K2's backward does not run), scale/shift frozen from
# step 4, each a new key
CASES = {"defaults": (6, dict(scaleshift_lr=1e-3), 1, 5),
         "boundaries": (8, dict(scaleshift_lr=1e-3, decay_step=3, warm_start_nerf=2,
                                freeze_ss=5), 3, 5)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graph_steps_equal_eager_steps(cuda, case, monkeypatch):
    steps, kw, captures, replays = CASES[case]
    tc = step.TrainConfig(**kw)
    rc, scene, state, step_fn = cell(cuda, tc)
    ref = copy.deepcopy(state)
    gen = torch.Generator(device=cuda)
    want, eager_launches = run(step_fn.eager, ref, scene, range(steps), gen)
    at_capture = []
    capture = step_fn._capture

    def counted(*a, **k):
        before = counters()
        capture(*a, **k)
        at_capture.append(tuple(a - b for a, b in zip(counters(), before)))

    monkeypatch.setattr(step_fn, "_capture", counted)
    got, launches = run(step_fn, state, scene, range(steps), gen)
    assert step_fn.captures == captures and step_fn.replays == replays
    assert at_capture == [(0, 0, 0, 0, 0)] * captures
    assert launches == eager_launches
    assert launches[-4:] == [(2, 2, 1, 2, 2)] * 4  # both passes keep for the backward
    assert (state.step, state.opt.count, state.ss_opt.count) == (steps,) * 3
    for i, (a, b) in enumerate(zip(got, want)):
        assert list(a) == list(b)
        for k in b:
            assert a[k] == b[k] if k == "lr" else torch.equal(a[k], b[k]), (i, k)
    for i, (a, b) in enumerate(zip(leaves(state), leaves(ref))):
        assert torch.equal(a, b), i


@pytest.mark.cuda
def test_a_replaced_state_captures_again(cuda):
    tc = step.TrainConfig(scaleshift_lr=1e-3)
    rc, scene, state, step_fn = cell(cuda, tc)
    gen = torch.Generator(device=cuda)
    run(step_fn, state, scene, range(3), gen)
    assert (step_fn.captures, step_fn.replays) == (1, 2)
    # values written in place: the same key, and the replay reads them
    ref = copy.deepcopy(state)
    with torch.no_grad():
        for p, q in zip(state.nerf_params(), ref.nerf_params()):
            p.mul_(0.5)
            q.mul_(0.5)
    got, _ = run(step_fn, state, scene, [3], gen)
    want, _ = run(step_fn.eager, ref, scene, [3], gen)
    assert (step_fn.captures, step_fn.replays) == (1, 3)
    assert torch.equal(got[0]["loss"], want[0]["loss"])
    # a copy, as a checkpoint load makes: an eager step, then a capture
    loaded = copy.deepcopy(state)
    ref = copy.deepcopy(state)
    got, _ = run(step_fn, loaded, scene, [4, 5, 6], gen)
    want, _ = run(step_fn.eager, ref, scene, [4, 5, 6], gen)
    assert (step_fn.captures, step_fn.replays) == (2, 5)
    for a, b in zip(got, want):
        assert all(a[k] == b[k] if k == "lr" else torch.equal(a[k], b[k]) for k in b)
    for a, b in zip(leaves(loaded), leaves(ref)):
        assert torch.equal(a, b)
    # another generator: an eager step, then a capture
    run(step_fn, loaded, scene, [7, 8], torch.Generator(device=cuda))
    assert (step_fn.captures, step_fn.replays) == (3, 6)


@pytest.mark.cuda
def test_replayed_steps_read_nothing_from_the_card(cuda):
    tc = step.TrainConfig()
    rc, scene, state, step_fn = cell(cuda, tc)
    gen = torch.Generator(device=cuda)
    run(step_fn, state, scene, range(2), gen)  # eager, then the capture
    torch.cuda.set_sync_debug_mode("error")
    try:
        for s in range(2, 6):
            gen.manual_seed((7 << 32) + s)
            step_fn(state, scene, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (step_fn.captures, step_fn.replays) == (1, 5)


# the kernel each counter's launcher runs once a call, in counters()' order
KERNELS = ("fused_mlp_kernel", "sample_pdf_kernel", "sample_pdf_backward_kernel",
           "k1_backward_delta_kernel")


@pytest.mark.cuda
def test_a_replay_counts_the_kernels_it_runs(cuda, tmp_path):
    tc = step.TrainConfig()
    rc, scene, state, step_fn = cell(cuda, tc)
    gen = torch.Generator(device=cuda)
    run(step_fn, state, scene, range(2), gen)  # eager, then the capture
    before = counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        gen.manual_seed((7 << 32) + 2)
        step_fn(state, scene, gen)
        torch.cuda.synchronize()
    advanced = tuple(a - b for a, b in zip(counters(), before))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        names = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    ran = tuple(sum(bool(re.search(rf"\b{k}\b", n)) for n in names) for k in KERNELS)
    assert (step_fn.captures, step_fn.replays) == (1, 2)
    assert advanced[:4] == ran == (2, 2, 1, 2) and advanced[4] == 2
