"""The readers of the program's own spans (``scade.*``, opened through
``scade_tpu_torch/utils/profiling.py::span``) on a small synthetic trace,
whose answers are worked out by hand, and on the same trace without those
spans, as a program that opens none gives it."""

import json
import os

import pytest

from conftest import BENCH
from harness import manifest
from harness.trace import Trace

# name: [(start, end)], thread; two steps of 500 us
SPANS = {
    "scade.train.forward": ([(10, 110), (510, 610)], 1),
    "scade.train.backward": ([(110, 310), (610, 810)], 1),
    "scade.train.adam": ([(310, 410), (810, 910)], 1),
    "scade.prior.forward": ([(10, 110), (510, 610)], 1),
    "scade.prior.optimizer": ([(310, 410), (810, 910)], 1),
}
# correlation, launch time, launching thread, kernel start, duration
KERNELS = [(1, 50, 1, 60, 30), (2, 560, 1, 570, 30),  # forward
           (5, 250, 2, 280, 20),  # autograd's device thread: not the backward span's
           (6, 350, 1, 350, 10), (7, 850, 1, 850, 10)]  # Adam / optimizer
# a replayed backward: one cudaGraphLaunch inside each backward span, its
# kernels tied to it by its correlation: correlation, launch time, thread,
# [(kernel start, duration)]
GRAPHS = [(3, 120, 1, [(200, 30), (230, 10)]), (4, 620, 1, [(700, 40)])]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid,
            "args": args}


def _events(spans=True):
    ev = [_x("user_annotation", "bench.window", 0, 1000),
          _x("user_annotation", "bench.step", 0, 500),
          _x("user_annotation", "bench.step", 500, 500)]
    if spans:
        ev += [_x("user_annotation", name, a, b - a, tid)
               for name, (ranges, tid) in SPANS.items() for a, b in ranges]
    for c, launch, tid, ts, dur in KERNELS:
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", launch, 2, tid, correlation=c))
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{c}", "ts": ts, "dur": dur, "pid": 0,
                   "tid": 7, "args": {"correlation": c}})
    for c, launch, tid, kernels in GRAPHS:
        ev.append(_x("cuda_runtime", "cudaGraphLaunch", launch, 5, tid, correlation=c))
        ev += [{"ph": "X", "cat": "kernel", "name": f"g{c}.{i}", "ts": ts, "dur": dur, "pid": 0,
                "tid": 7, "args": {"correlation": c}} for i, (ts, dur) in enumerate(kernels)]
    return ev


def _trace(tmp_path, spans):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events(spans)}))
    return Trace.from_file(str(path))


class Ctx:
    steps = 2
    untraced_s = 800e-6
    work = {}


def _read(name, trace):
    return manifest.load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                                "test_span_metric_" + name.replace(".", "_")).read(trace, Ctx())


# Idle gaps: 0-60, 90-200, 240-280, 300-350, 360-570, 600-700, 740-850,
# 860-1000 (820 us). The backward spans overlap 90 + 40 + 10 + 90 + 70 = 300
# of them, the optimizer spans 40 + 50 + 40 + 50 = 180.
@pytest.mark.parametrize("name,value", [
    ("train.forward_ms", 0.030), ("train.backward_ms", 0.040), ("train.adam_ms", 0.010),
    ("train.backward_idle_share", 100 * 300 / 820),
    ("prior.forward_ms", 0.030), ("prior.optimizer_ms", 0.010),
    ("prior.optimizer_idle_share", 100 * 180 / 820),
])
def test_span_reader(tmp_path, name, value):
    assert _read(name, _trace(tmp_path, True)) == pytest.approx(value)
    assert _read(name, _trace(tmp_path, False)) is None
