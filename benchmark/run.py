"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Finds the workload in ``BENCHMARK.json``, its configuration, traffic and
cell files, and the driver the traffic names (``harness/manifest.py``).
Then: set-up (the driver builds the program's state from the seed and runs
its first steps, which warm up every shape the window uses); with
``--trace 0`` a window of ``--seconds`` of the closed loop, timed on the
host clock and ended by a synchronize, which gives the end-to-end metrics;
with ``--trace 1`` ``trace_steps`` steps of the same loop timed on the
host clock, then as many under ``torch.profiler``, which give the
per-layer metrics, the device's busy time and a breakdown. After the window the process must hold no JAX module,
the program's state is let go, and the plain reference judges what set-up
recorded (``correct``). The last line of standard output is the result's
JSON; the numbers compared, each with its limit, are the last lines of
standard error and the result's last key.

Needs an NVIDIA card: without one it exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH)


@dataclasses.dataclass
class Context:
    """What a driver is handed: the seed, the device and the cell's files."""

    workload: str
    seed: int
    device: object
    config: dict
    traffic: dict
    cell: dict


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _finite(x):
    """A JSON-safe number: infinity as 1e308, NaN as None."""
    if isinstance(x, float) and not math.isfinite(x):
        return None if math.isnan(x) else math.copysign(1e308, x)
    return x


def window(driver, run, seconds: float, block: int = 25) -> tuple:
    """The closed loop for ``seconds`` of host time, then a synchronize:
    (steps, seconds from the first step's start to the device's end, the
    host's ms a step over each block of ``block`` steps)."""
    steps, t0 = 0, time.perf_counter()
    stamps = [t0]
    while True:
        driver.step(run)
        steps += 1
        now = time.perf_counter()
        if steps % block == 0:
            stamps.append(now)
        if now - t0 >= seconds:
            break
    driver.sync(run)
    blocks = [(b - a) * 1e3 / block for a, b in zip(stamps, stamps[1:])]
    return steps, time.perf_counter() - t0, blocks


def traced(driver, run, wl, ctx) -> tuple:
    """``trace_steps`` steps untraced, timed from a synchronize to a
    synchronize; then under the profiler ``trace_warm_steps`` steps and
    ``trace_steps`` steps in a ``bench.window`` range. The per-layer
    metrics, the device block's busy and window seconds, and the breakdown.
    The profiler records every host operation, which stretches a step on
    the host but not the device's work: shares of the step's time take the
    untraced steps' time as their denominator."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness.trace import STEP, WINDOW, Trace

    spans = getattr(driver, "spans", None)
    n = ctx.traffic["trace_steps"]
    driver.sync(run)
    t0 = time.perf_counter()
    for _ in range(n):
        driver.step(run)
    driver.sync(run)
    untraced_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with (spans() if spans else contextlib.nullcontext()):
                for _ in range(ctx.traffic["trace_warm_steps"]):
                    driver.step(run)
                driver.sync(run)
                with record_function(WINDOW):
                    for _ in range(n):
                        with record_function(STEP):
                            driver.step(run)
                    driver.sync(run)
        prof.export_chrome_trace(path)
        trace = Trace.from_file(path)
    counts = wl.counts()
    work = {}
    for info in run.work[-n:]:
        for k, v in counts.work(ctx.config, info).items():
            work[k] = work.get(k, 0.0) + v
    mctx = MetricContext(steps=trace.steps, work=work, untraced_s=untraced_s * trace.steps / n)
    metrics = {}
    for m in wl.per_layer:
        value = wl.metric_reader(m["name"]).read(trace, mctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, trace.busy_us() / 1e6, trace.window_us / 1e6, trace.breakdown()


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric's reader gets besides the trace: the steps
    traced, the work they did (operations and bytes from
    ``counts/<config>.py``, summed over those steps), and the host seconds
    as many steps took untraced just before."""

    steps: int
    work: dict
    untraced_s: float


def main(argv=None, root: str = BENCH, require=None) -> int:
    args = parse_args(argv)
    sys.path[:0] = [p for p in (CHECKOUT, root) if p not in sys.path]
    from harness import device as devmod
    from harness import judge, manifest

    devmod.cache_env(CHECKOUT)
    wl = manifest.load(root, args.workload)
    (require or devmod.require_devices)(wl.chips)
    import torch

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    ctx = Context(args.workload, args.seed, dev, wl.config, wl.traffic, wl.cell)
    driver = wl.driver()
    run = driver.setup(ctx)
    driver.sync(run)
    setup_s = time.perf_counter() - T0
    e2e_units = {m["name"]: m["unit"] for m in wl.end_to_end}
    if args.trace:
        metrics, busy_s, window_s, breakdown = traced(driver, run, wl, ctx)
        attempted = 2 * ctx.traffic["trace_steps"] + ctx.traffic["trace_warm_steps"]
    else:
        attempted, seconds, blocks = window(driver, run, args.seconds)
        sys.stderr.write("window ms a step by block of 25 steps: "
                         + " ".join(f"{b:.1f}" for b in blocks) + "\n")
        name = wl.cell["per_step_metric"]
        per_step = seconds / attempted * {"s": 1.0, "ms": 1e3}[e2e_units[name]]
        metrics = {name: {"value": per_step, "unit": e2e_units[name]},
                   "setup_s": {"value": setup_s, "unit": e2e_units["setup_s"]}}
    info = devmod.describe(dev, wl.chips)
    if args.trace:
        info.update(busy_s=busy_s, window_s=window_s)
    bad = devmod.forbidden_modules()
    if bad:
        sys.stderr.write(f"forbidden modules loaded: {bad}\n")
        return 3
    failed = run.failed
    record, inputs = driver.finish(run)
    del run
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.judge_run(ctx, record, inputs)
    limits = wl.cell["limits"]
    correct = failed == 0 and judge.verdict(checks, limits)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": info}
    if args.trace:
        result["breakdown"] = breakdown
    result["checks"] = {k: {kk: _finite(vv) for kk, vv in v.items()}
                        for k, v in judge.block(checks, limits).items()}
    limit = devmod.power_limit()
    if limit:
        sys.stderr.write(f"card: {limit}\n")
    for text in judge.lines(checks, limits):
        sys.stderr.write(text + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
