"""The port's spans (``utils/profiling.py::span``) and where the train steps
open them.

With no profiler recording, a span calls nothing of the profiler. Under
``profiling.trace`` the spans reach the Chrome trace with their names, their
nesting and the step number as the range's argument. A tiny NeRF step and a
tiny prior step on the CPU open their phase spans once a step, in order,
inside the step span; every host op of a step outside its phase spans is
the NeRF's batch sampling, before the forward, or a ``detach``, which
launches nothing. On the card (tests marked ``cuda``), at least 98% of a
traced step's device time is launched inside a phase span or one of
autograd's ``evaluate_function`` ranges, the NeRF's step op by op and
replayed from its CUDA graphs alike. The file imports neither JAX nor
scade_tpu, so the card tests run with

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import json

import numpy as np
import pytest
import torch

from scade_tpu_torch.prior import losses as L
from scade_tpu_torch.prior import model as prior_model
from scade_tpu_torch.prior import train as prior_train
from scade_tpu_torch.render.renderer import make_render_config
from scade_tpu_torch.train import step as nerf_step
from scade_tpu_torch.utils import profiling
from scade_tpu_torch.utils.profiling import span

NERF_PHASES = ("scade.train.forward", "scade.train.backward", "scade.train.adam")
PRIOR_PHASES = ("scade.prior.forward", "scade.prior.criterion", "scade.prior.backward",
                "scade.prior.optimizer")
STEP = {"nerf": "scade.train.step", "prior": "scade.prior.step"}
PHASES = {"nerf": NERF_PHASES, "prior": PRIOR_PHASES}
BACKWARD = "autograd::engine::evaluate_function"
LAUNCHES_NOTHING = {"aten::detach", "detach"}
CHEAP = "_meanstd-tanh_msgil-normal_"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def events_of(logdir) -> list:
    """The trace's complete events, less the copies of the host's ranges
    that the profiler puts on the card's timeline."""
    with open(logdir / profiling.TRACE_FILE) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]


def named(events, name) -> list:
    return sorted((e for e in events if e["name"] == name), key=lambda e: e["ts"])


def within(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def step_arg(e):
    return e["args"].get("Concrete Inputs")


# ---------------------------------------------------------------------------
# tiny steps
# ---------------------------------------------------------------------------

H = W = 16
N_TRAIN, N_REL, K = 2, 3, 4
SMALL = dict(multires=4, netwidth=64, netwidth_fine=64, n_samples=8, n_importance=16)


def nerf_scene(device, h=H, w=W, n_train=N_TRAIN, k=K, seed=0):
    n_rel = n_train + 1
    rng = np.random.default_rng(seed)
    intr = np.broadcast_to(np.array([w / 2, h / 2, w / 2, h / 2], np.float32), (n_rel, 4))
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (n_rel, 4, 4)).copy()
    poses[:, :3, 3] = rng.normal(size=(n_rel, 3)) * 0.05
    d = dict(images=rng.uniform(size=(n_rel, h, w, 3)), poses=poses, intrinsics=intr,
             hyps=rng.uniform(1.0, 5.0, size=(n_train, k, h, w, 1)), near=0.1, far=10.0,
             bb_center=np.zeros(3), bb_scale=0.5)
    return nerf_step.SceneTensors(**{name: torch.as_tensor(np.array(v, np.float32), device=device)
                                     for name, v in d.items()})


def nerf_steps(n, device="cpu", fused=True, rc_args=SMALL, n_rand=32, scene_args=None,
               eager=False):
    """A closure running ``n`` train steps of a fresh tiny state (with
    ``eager``, op by op where the step would replay CUDA graphs)."""
    rc = make_render_config(**rc_args, device=device, use_fused=fused, fused_sampling=fused)
    tc = nerf_step.TrainConfig(n_rand=n_rand)
    scene = nerf_scene(device, **(scene_args or {}))
    state = nerf_step.create_train_state(0, rc, tc, scene.images.shape[0])
    fn = nerf_step.make_train_step(rc, tc, scene.images.shape[1], scene.images.shape[2],
                                   scene.hyps.shape[0])
    gen = torch.Generator(device=device).manual_seed(3)
    call = fn.eager if eager else fn

    def run(k=n):
        for _ in range(k):
            call(state, scene, gen)

    return run


def prior_steps(n, device="cpu", compute_dtype=None, B=2, S=32):
    """A closure running ``n`` SGD steps of a fresh tiny prior."""
    cfg = prior_model.PriorConfig(d_latent=8).with_small()
    m = prior_model.build_prior_model(cfg, "v2", "enc")
    prior_model.init_weights_(m, torch.Generator().manual_seed(0))
    m.to(device)
    shifts = {k: v.to(device) for k, v in prior_model.zero_shifts_for(m).items()}
    g = torch.Generator(device=device).manual_seed(1)
    batch = {"rgb": torch.rand((B, 3, S, S), generator=g, device=device) * 2 - 1,
             "depth": torch.rand((B, 1, S, S), generator=g, device=device) * 8.5 + 0.5,
             "planes": torch.zeros((B, S, S), dtype=torch.long, device=device),
             "focal_length": torch.full((B,), 200.0, device=device),
             "quality_flg": torch.full((B,), 2, dtype=torch.int32, device=device)}
    z = torch.randn((B, 8), generator=g, device=device)
    tc = prior_train.PriorTrainConfig(loss_mode=CHEAP, compute_dtype=compute_dtype)
    opt = prior_train.PriorOptimizer(m, tc)

    def run(k=n):
        for _ in range(k):
            draws = L.draw_criterion(g, batch, tc.loss_mode)
            prior_train.train_step(m, opt, shifts, batch, z, draws, tc)

    return run


def traced(run, logdir) -> list:
    with profiling.trace(str(logdir)):
        run()
    return events_of(logdir)


@pytest.fixture(scope="module")
def cpu_traces(tmp_path_factory):
    """Two traced steps of each kind on the CPU, fused NeRF and f32 prior."""
    out = {}
    for kind, run in (("nerf", nerf_steps(2)), ("prior", prior_steps(2))):
        out[kind] = traced(run, tmp_path_factory.mktemp(kind))
    return out


# ---------------------------------------------------------------------------
# the primitive
# ---------------------------------------------------------------------------

def test_span_off_calls_no_profiler(monkeypatch):
    """With no profiler recording, a span (and a whole train step) calls
    neither the profiler's ranges nor NVTX, and every span is one shared
    context."""
    def boom(*a, **k):
        raise AssertionError("called into the profiler")

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", boom)
    assert not torch.autograd._profiler_enabled()
    assert span("scade.a") is span("scade.b", step=3)
    with span("scade.a", step=3):
        with span("scade.b"):
            pass
    nerf_steps(1)()


def test_span_on_nests_in_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with span("scade.outer", step=5):
            with span("scade.inner"):
                torch.ones(8, 8) @ torch.ones(8, 8)
            with span("scade.inner"):
                pass
    ev = events_of(tmp_path)
    [outer], inner = named(ev, "scade.outer"), named(ev, "scade.inner")
    assert len(inner) == 2 and all(within(i, outer) for i in inner)
    assert inner[0]["ts"] + inner[0]["dur"] <= inner[1]["ts"]
    assert step_arg(outer) == ["5"] and not any(step_arg(i) for i in inner)
    assert any(e["name"] == "aten::mm" and within(e, inner[0]) for e in ev)
    assert {outer["cat"], inner[0]["cat"]} == {"user_annotation"}


# ---------------------------------------------------------------------------
# the steps' spans on the CPU
# ---------------------------------------------------------------------------

def check_step_spans(ev, kind):
    """Each step span holds each phase span once, in order, with the step's
    number; returns the step spans."""
    steps = named(ev, STEP[kind])
    assert len(steps) == 2
    numbers = [step_arg(s) for s in steps]
    assert numbers[0] != numbers[1] and all(len(n) == 1 for n in numbers)
    for s, number in zip(steps, numbers):
        phases = [named([e for e in ev if within(e, s)], p) for p in PHASES[kind]]
        assert all(len(p) == 1 for p in phases), [len(p) for p in phases]
        phases = [p[0] for p in phases]
        assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(phases, phases[1:]))
        assert all(step_arg(p) == number for p in phases)
    return steps


@pytest.mark.parametrize("fused", [True, False])
def test_nerf_step_spans(cpu_traces, tmp_path, fused):
    """Forward, backward and Adam once a step, in order, inside the step
    span; K1's recompute, twice a step (coarse and fine) inside the
    backward, only where the fused path runs."""
    ev = cpu_traces["nerf"] if fused else traced(nerf_steps(2, fused=False), tmp_path)
    recompute = named(ev, "scade.k1.recompute")
    steps = check_step_spans(ev, "nerf")
    if not fused:
        assert recompute == []
        return
    assert len(recompute) == 4
    backward = named(ev, "scade.train.backward")
    for r in recompute:
        assert sum(within(r, b) for b in backward) == 1
        assert any(e["name"] == "aten::mm" and within(e, r) for e in ev)
    assert [sum(within(r, s) for r in recompute) for s in steps] == [2, 2]


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_prior_step_spans(cpu_traces, tmp_path, compute_dtype):
    """Forward, criterion, backward and optimizer once a step, in order,
    inside the step span, numbered by the optimizer's count; the model's
    convolutions in the forward, SGD in the optimizer; the criterion's
    draws before each step, unnumbered."""
    ev = (cpu_traces["prior"] if compute_dtype is None
          else traced(prior_steps(2, compute_dtype=compute_dtype), tmp_path))
    steps = check_step_spans(ev, "prior")
    assert [step_arg(s) for s in steps] == [["0"], ["1"]]
    draws = named(ev, "scade.prior.draws")
    assert len(draws) == 2 and not any(step_arg(d) for d in draws)
    assert all(d["ts"] + d["dur"] <= s["ts"] for d, s in zip(draws, steps))
    forward, optimizer = named(ev, "scade.prior.forward"), named(ev, "scade.prior.optimizer")
    assert any(e["name"] == "aten::conv2d" and within(e, forward[0]) for e in ev)
    assert any(e["name"].startswith("Optimizer.step") and within(e, optimizer[0]) for e in ev)


@pytest.mark.parametrize("kind", ["nerf", "prior"])
def test_phase_spans_tile_the_step(cpu_traces, kind):
    """Every host op of a step lies inside one of its phase spans, but for
    the NeRF's batch sampling (before its forward) and detaches."""
    ev = cpu_traces[kind]
    ops = [e for e in ev if e.get("cat") == "cpu_op"]
    for s in named(ev, STEP[kind]):
        phases = [p for name in PHASES[kind] for p in named(ev, name) if within(p, s)]
        first = min(p["ts"] for p in phases)
        loose = [o for o in ops if within(o, s) and not any(within(o, p) for p in phases)]
        stray = {o["name"] for o in loose if o["name"] not in LAUNCHES_NOTHING
                 and (kind == "prior" or o["ts"] >= first)}
        assert not stray, stray


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def phase_coverage(ev, kind):
    """(share of the trace's device time launched inside a phase span, the
    prior's draws or an ``evaluate_function`` range on the launching
    thread, device ms launched inside K1's recompute)."""
    launch = {e["args"]["correlation"]: e for e in ev
              if e.get("cat") in LAUNCH_CATS and "correlation" in e["args"]}
    phases = PHASES[kind] + ("scade.prior.draws",)
    ranges = [e for e in ev if e["name"] in phases or e["name"].startswith(BACKWARD)]
    recompute = named(ev, "scade.k1.recompute")
    total = covered = k1 = 0.0
    for op in (e for e in ev if e.get("cat") in DEVICE_CATS):
        at = launch.get(op["args"].get("correlation"))
        total += op["dur"]
        if at is None:
            continue
        if any(within(at, r) for r in ranges):
            covered += op["dur"]
        if any(within(at, r) for r in recompute):
            k1 += op["dur"]
    assert total > 0
    return covered / total, k1 / 1e3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["nerf", "prior", "nerf_replayed"])
def test_phase_spans_cover_the_device_time(cuda, tmp_path, kind):
    """One traced step after two warm ones: the NeRF at the published widths
    (8x256, multires 9, 64 + 128 samples, 1,024 rays) on a 64x64 scene with
    K=20, op by op and replayed from its CUDA graphs, and the tiny prior at
    B=2 and 64x64 with its draws. At least 98% of the device time is
    launched inside a phase span, the draws' span or an
    ``evaluate_function`` range; in the eager NeRF, K1's recompute launches
    kernels on autograd's device thread inside its span; a replay launches
    its graphs inside the phase spans and opens neither K1's span nor
    autograd's ranges."""
    if kind.startswith("nerf"):
        run = nerf_steps(3, "cuda", rc_args=dict(multires=9, multires_views=0), n_rand=1024,
                         scene_args=dict(h=64, w=64, n_train=4, k=20), eager=kind == "nerf")
    else:
        run = prior_steps(3, "cuda", S=64)
    run(2)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        run(1)
        torch.cuda.synchronize()
    ev = events_of(tmp_path)
    share, k1_ms = phase_coverage(ev, kind[:4] if kind.startswith("nerf") else kind)
    print(f"{kind}: {100 * share:.2f}% of the device time inside phase spans "
          f"or evaluate_function ranges; K1 recompute {k1_ms:.3f} ms")
    assert share >= 0.98
    recompute = named(ev, "scade.k1.recompute")
    if kind == "nerf":
        [s] = named(ev, STEP[kind])
        assert len(recompute) == 2 and all(r["tid"] != s["tid"] for r in recompute)
        assert k1_ms > 0
    elif kind == "nerf_replayed":
        assert recompute == [] and not any(e["name"].startswith(BACKWARD) for e in ev)
