"""Each per-layer metric's reader on a small synthetic trace, whose answers
are worked out by hand."""

import json
import os

import pytest

from conftest import BENCH
from harness import manifest, peaks
from harness.trace import Trace

K1 = "void (anonymous namespace)::fused_mlp_kernel<float, 256>(float const*, float const*)"
K2 = "(anonymous namespace)::sample_pdf_kernel(float const*, long long)"
K2B = "(anonymous namespace)::sample_pdf_backward_kernel(float const*, long long)"
K1B = "void (anonymous namespace)::k1_backward_dw_kernel<256>(float const*, int)"
BWD = "autograd::engine::evaluate_function: "


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid,
            "args": args}


def _events():
    ev = [_x("user_annotation", "bench.window", 0, 1000),
          _x("user_annotation", "bench.step", 0, 500),
          _x("user_annotation", "bench.step", 500, 500),
          _x("user_annotation", "bench.criterion", 100, 100),
          _x("cpu_op", "aten::mul", 110, 10, **{"Sequence number": 7}),
          _x("cpu_op", "aten::item", 330, 270),
          _x("cpu_op", BWD + "MulBackward0", 600, 50, tid=2, **{"Sequence number": 7}),
          _x("cpu_op", BWD + "AddmmBackward0", 700, 50, tid=2, **{"Sequence number": 9})]
    launches = [(1, 115, 1), (2, 610, 2), (3, 710, 2), (4, 50, 1), (5, 300, 1), (6, 720, 2)]
    ev += [_x("cuda_runtime", "cudaLaunchKernel", ts, 2, tid=tid, correlation=c)
           for c, ts, tid in launches]
    kernels = [(1, "k_mul", 130, 20), (2, "k_mul_backward", 620, 30), (3, K1B, 720, 40),
               (4, K1, 60, 40), (5, K2, 310, 10), (6, K2B, 770, 10)]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d, "pid": 0, "tid": 7,
            "args": {"correlation": c}} for c, n, ts, d in kernels]
    return ev


@pytest.fixture(scope="module")
def trace(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    return Trace.from_file(str(path))


class Ctx:
    steps = 2
    untraced_s = 800e-6
    work = {"k1_flops": 20e-6 * peaks.TF32_FLOPS, "k1_bytes": 1.0,
            "k1_backward_flops": 10e-6 * peaks.TF32_FLOPS, "k1_backward_bytes": 1.0,
            "k2_bytes": 5e-6 * peaks.HBM_BYTES_PER_S, "model_flops": 0.1 * 1e-3 * peaks.TF32_FLOPS}


def _read(name, trace):
    return manifest.load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                                "test_metric_" + name.replace(".", "_")).read(trace, Ctx())


@pytest.mark.parametrize("name,value", [
    ("prior.backward_ms", 0.040), ("prior.criterion_ms", 0.025),
    ("device.idle_share.train", 81.25), ("device.idle_share.prior", 81.25),
    ("device.idle_share.render", 81.25),
    ("k1_roofline.train", 50.0), ("k2_roofline.train", 25.0),
    ("k1_backward_roofline.train", 25.0),
    ("k1_roofline.render", 50.0), ("k2_roofline.render", 50.0),  # no K2 backward in a render
    ("train.mfu", 12.5), ("prior.mfu", 12.5), ("render.mfu", 12.5),
])
def test_reader(trace, name, value):
    assert _read(name, trace) == pytest.approx(value)


def test_window_steps_and_busy_time(trace):
    assert (trace.t0, trace.t1, trace.steps) == (0, 1000, 2)
    assert trace.busy_us() == 150


def test_breakdown(trace):
    b = trace.breakdown()
    assert b["device_ops"][0] == [K1, 40e-6]
    assert b["idle_gaps"][0] == ["aten::item", 300e-6]
    assert [round(g[1] * 1e6) for g in b["idle_gaps"][:3]] == [300, 220, 160]


def test_readers_find_nothing_without_device_ops(trace):
    empty = Trace([e for e in _events() if e["cat"] != "kernel"])
    for name in ("prior.backward_ms", "prior.criterion_ms", "k1_roofline.train",
                 "k2_roofline.train", "k1_backward_roofline.train", "k1_roofline.render",
                 "k2_roofline.render", "device.idle_share.train", "device.idle_share.render",
                 "train.mfu", "render.mfu"):
        assert _read(name, empty) is None, name
