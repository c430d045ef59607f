"""The operations and bytes the rooflines and MFU divide by, against the
figures they were derived from by hand."""

import json
import os

import pytest

from conftest import BENCH
from harness import manifest, peaks


def _counts(name):
    return manifest.load_module(os.path.join(BENCH, "counts", f"{name}.py"),
                                "test_counts_" + name.replace("-", "_"))


def _config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as fp:
        return json.load(fp)


def test_nerf_multiply_adds():
    c = _counts("scade-scannet")
    assert c.nerf_macs(8, 256, 63) == 590_336  # multires 10's 63-wide encoding
    assert c.nerf_macs(8, 256, 57) == 587_264  # the configuration's multires 9


def test_k1_operations_and_bound():
    c, config = _counts("scade-scannet"), _config("scade-scannet")
    work = c.work(config, {})
    points = 1024 * 64 + 1024 * 192
    assert points == 262_144
    assert work["k1_flops"] == 2 * 587_264 * points  # 3.0790e11
    assert 2 * 590_336 * points == pytest.approx(3.095e11, rel=1e-3)
    assert peaks.bound_s(work["k1_flops"], work["k1_bytes"]) * 1e3 == pytest.approx(0.622,
                                                                                    abs=1e-3)
    assert peaks.bound_by(work["k1_flops"], work["k1_bytes"]) == "operations"
    assert work["model_flops"] == 3 * work["k1_flops"]


def test_k2_byte_bounds():
    c = _counts("scade-scannet")
    forward = c.k2_bytes(1024, 63, 128) + c.k2_bytes(1024, 191, 128)
    backward = c.k2_backward_bytes(1024, 191, 128)
    assert forward / peaks.HBM_BYTES_PER_S * 1e6 == pytest.approx(1.24, abs=0.01)
    assert backward / peaks.HBM_BYTES_PER_S * 1e6 == pytest.approx(1.01, abs=0.01)
    work = c.work(_config("scade-scannet"), {})
    assert work["k2_bytes"] == forward + backward


def test_prior_step_operations():
    c, config = _counts("leres-cimle-rx101"), _config("leres-cimle-rx101")
    assert c.work(config, {"batch": 4})["model_flops"] / 1e9 == pytest.approx(3480.29, abs=0.01)
    assert c.work(config, {"batch": 2})["model_flops"] * 2 == c.work(config, {"batch": 4})[
        "model_flops"]


def test_k1_backward_operations_and_bound():
    c, config = _counts("scade-scannet"), _config("scade-scannet")
    # input gradients: the trunk's layers 1-7, density, feature, the view
    # layer's 256 feature columns, RGB
    assert c.input_grad_macs(8, 256) == 7 * 65_536 + 256 + 65_536 + 128 * 256 + 3 * 128 == 557_696
    assert 587_264 + 557_696 == 2 * 587_264 - (2 * 57 * 256 + 3 * 128)
    work = c.work(config, {})
    assert work["k1_backward_flops"] == 2 * 1_144_960 * 262_144  # 6.0029e11
    bound = peaks.bound_s(work["k1_backward_flops"], work["k1_backward_bytes"])
    assert bound * 1e3 == pytest.approx(1.2127, abs=1e-4)
    assert peaks.bound_by(work["k1_backward_flops"], work["k1_backward_bytes"]) == "operations"


def test_render_view_counts():
    c, config = _counts("scade-scannet"), _config("scade-scannet")
    rays = 468 * 624
    assert rays == 292_032 and -(-rays // 16_384) == 18  # 18 chunks, 36 launches of each kernel
    work = c.work(config, {"rays": rays, "chunk": 16_384})
    assert work["k1_flops"] == 2 * 587_264 * rays * 256 == pytest.approx(8.781e13, rel=1e-4)
    assert work["model_flops"] == work["k1_flops"]  # a render runs the forward only
    assert peaks.bound_s(work["k1_flops"], work["k1_bytes"]) == pytest.approx(0.17739, abs=1e-5)
    # both calls a chunk: bins, weights and samples a ray; the shared draws once a call
    assert work["k2_bytes"] == rays * (63 + 62 + 128 + 191 + 190 + 128) * 4 + 36 * 128 * 4
    assert peaks.bound_s(0.0, work["k2_bytes"]) * 1e3 == pytest.approx(0.2657, abs=1e-4)
