"""Where the NeRF train step waits for the card, and the host's own time a step.

Runs ``train/step.py``'s step at the ScanNet cell's shapes (8x256 nets,
64 + 128 samples, 1,024 stratified rays, K=20, 18 + 2 views at 468x624, both
kernels on, f32) on the card, as ``train/loop.py`` drives it (a generator
reseeded each step), on a scene of random views made on the card, and
reports under ``replayed`` the step as it runs (its CUDA graphs replayed,
``TrainStep``; the first three steps, which build the kernels and capture,
come before any measurement) and under ``eager`` the same step op by op
(``TrainStep.eager``):

- ``syncs``: every host-device synchronization of ``--steps`` steps, from
  ``torch.cuda.set_sync_debug_mode("warn")``, by call site (the innermost
  frame in this repository, and the innermost frame at all), with its count
  a step;
- ``host_ms``: the host's own time a step, untraced: a long sleep kernel is
  queued first, so that the card is ahead of the host and a step that reads
  nothing from the card never waits for it; the wall time of one call of
  the step function (the median of ``--reps``; the backward's launches run
  on autograd's device thread while this one waits), and the process's CPU
  time a call (its mean: this clock may tick in 10 ms); a step that reads
  from the card waits for the sleep at its first read, and its wall time
  says so; and the wall time of a call that finds the card idle;
- ``burst_wall_ms``: the wall time of each of 6 steps called back to back
  behind one sleep, which rises once the card's launch queue is full;
- ``loop_ms``: ms a step of ``--loop`` steps of the closed loop, from a
  synchronize to a synchronize, with the process's CPU time a step and the
  wall time of each call (a call that finds the launch queue full waits
  for the card; one that does not takes the host's time);
- ``launches``: the device operations of one step (``torch.profiler``);

and under ``graphs`` the step's captures and replays.

Usage, from a checkout's root on a machine with a card:

    python3 tools/host_syncs.py [--steps 3] [--reps 20] [--loop 200] [--out FILE]

The last line of output is the JSON of the report (also written to
``--out``, by default ``chiprun_out/host_syncs.json``).
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import statistics
import sys
import time
import traceback
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from scade_tpu_torch.render.renderer import make_render_config  # noqa: E402
from scade_tpu_torch.train import step as S  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N_TRAIN, N_VAL, K = 468, 624, 18, 2, 20
SLEEP_CYCLES = 1_000_000_000  # ~0.5 s at the H100's clock: longer than any step's dispatch


def ring_scene(dev, seed: int) -> S.SceneTensors:
    """Random views on a ring of radius 2.5 at height 0.4 looking at the
    origin, K uniform hypotheses in [0.5, 5.5] a train view."""
    n = N_TRAIN + N_VAL
    rng = np.random.default_rng(seed)
    poses = []
    for a in np.linspace(0.0, 2 * np.pi, n, endpoint=False) + rng.uniform(0, 0.1, n):
        eye = np.array([2.5 * np.cos(a), 0.4, 2.5 * np.sin(a)])
        back = eye / np.linalg.norm(eye)
        right = np.cross([0.0, 1.0, 0.0], back)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(back, right), back, eye
        poses.append(c2w)
    g = torch.Generator(device=dev).manual_seed(seed)
    return S.SceneTensors(
        images=torch.rand((n, H, W, 3), generator=g, device=dev),
        poses=torch.from_numpy(np.stack(poses).astype(np.float32)).to(dev),
        intrinsics=torch.tensor([[577.9, 577.9, W / 2.0, H / 2.0]], device=dev).repeat(n, 1),
        hyps=torch.rand((N_TRAIN, K, H, W, 1), generator=g, device=dev).mul_(5.0).add_(0.5),
        near=torch.tensor(0.1, device=dev), far=torch.tensor(6.0, device=dev),
        bb_center=torch.zeros(3, device=dev), bb_scale=torch.tensor(1.0 / 3.0, device=dev))


def site(stack) -> dict:
    """The innermost frame of this repository and the innermost frame."""
    ours = [f for f in stack if f.filename.startswith(ROOT) and "host_syncs.py" not in f.filename]
    where = ours[-1] if ours else stack[-1]
    return {"repo": f"{os.path.relpath(where.filename, ROOT)}:{where.lineno} {where.line}",
            "innermost": f"{stack[-1].filename}:{stack[-1].lineno}"}


def measure(one, args) -> dict:
    """The syncs, host time, burst, closed loop and device operations of the
    step ``one`` calls (see the module's docstring)."""
    calls = []

    def record(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith("called a synchronizing CUDA operation"):
            calls.append(site(traceback.extract_stack()[:-1]))

    shown = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(args.steps):
                one()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = shown
    torch.cuda.synchronize()
    by_site = collections.Counter(c["repo"] for c in calls)
    inner = {c["repo"]: c["innermost"] for c in calls}
    syncs = [{"site": k, "per_step": v / args.steps, "innermost": inner[k]}
             for k, v in by_site.most_common()]

    # the closed loop first: the profiler below leaves the launches slower
    torch.cuda.synchronize()
    calls_ms = []
    t0, c0 = time.perf_counter(), time.process_time()
    for _ in range(args.loop):
        t1 = time.perf_counter()
        one()
        calls_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / args.loop
    loop_cpu_ms = (time.process_time() - c0) * 1e3 / args.loop

    cpu, wall = 0.0, []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0, c0 = time.perf_counter(), time.process_time()
        one()
        cpu += time.process_time() - c0
        wall.append((time.perf_counter() - t0) * 1e3)
    idle = []  # the same with the card idle at the call's start
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        idle.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    burst = []
    for _ in range(6):
        t0 = time.perf_counter()
        one()
        burst.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return {
        "syncs": syncs, "syncs_per_step": len(calls) / args.steps,
        "host_ms": {"wall_median": statistics.median(wall), "wall": wall,
                    "process_cpu_mean": cpu * 1e3 / args.reps,
                    "wall_median_card_idle": statistics.median(idle)},
        "burst_wall_ms": burst, "launches": launches, "loop_ms": loop_ms,
        "loop_process_cpu_ms": loop_cpu_ms,
        "loop_call_ms": dict(zip(("p10", "median", "p90"),
                                 np.percentile(calls_ms, [10, 50, 90]).tolist())),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--loop", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "host_syncs.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("host_syncs: needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = ring_scene(dev, args.seed)
    rc = make_render_config()
    tc = S.TrainConfig()
    state = S.create_train_state(args.seed, rc, tc, n_images=N_TRAIN + N_VAL)
    step_fn = S.make_train_step(rc, tc, H, W, N_TRAIN)
    gen = torch.Generator(device=dev)
    i = 0

    def one(fn):
        nonlocal i
        i += 1
        gen.manual_seed(((args.seed + 1) << 32) + i)
        return fn(state, scene, gen)

    for _ in range(3):  # builds the kernels and every cached table; then the capture
        one(step_fn)
    torch.cuda.synchronize()
    report = {"device": torch.cuda.get_device_name(0), "steps": args.steps}
    # the step as it runs (its CUDA graphs replayed), then op by op
    for mode, fn in (("replayed", step_fn), ("eager", step_fn.eager)):
        report[mode] = measure(functools.partial(one, fn), args)
    report["graphs"] = {"captures": step_fn.captures, "replays": step_fn.replays}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
