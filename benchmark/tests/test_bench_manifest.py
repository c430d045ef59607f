"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import os
import re

import pytest

from conftest import BENCH

CHECKOUT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as fp:
        return json.load(fp)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and all(PATH.match(p) for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200


def test_entries_have_just_their_keys(bench):
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in bench["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in bench["workloads"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def _reports(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def test_every_cell_reports_what_its_layer_metrics_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        reported = [m for m in bench["per_layer"] if _reports(m, w["name"])]
        assert reported, w["name"]
        assert _reports(e2e["setup_s"], w["name"])
        assert any(_reports(m, w["name"]) for n, m in e2e.items() if n != "setup_s")
        for m in reported:
            assert _reports(e2e[m["moves"]], w["name"]), (m["name"], w["name"])


def test_names_resolve_to_files(bench):
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(CHECKOUT, c["file"])) as fp:
            config = json.load(fp)
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert all(k in config for k in c["reduced"])
        assert os.path.isfile(os.path.join(BENCH, "counts", f"{c['name']}.py"))
        assert os.path.isfile(os.path.join(BENCH, "reference", f"{config['reference']}.py"))
    for w in bench["workloads"]:
        with open(os.path.join(BENCH, "traffic", f"{w['traffic']}.json")) as fp:
            traffic = json.load(fp)
        assert os.path.isfile(os.path.join(BENCH, "drivers", f"{traffic['driver']}.py"))
        with open(os.path.join(BENCH, "cells", f"{w['name']}.json")) as fp:
            cell = json.load(fp)
        assert cell["limits"] and cell["per_step_metric"] in {m["name"] for m in
                                                              bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py"))


def test_every_config_is_used_and_the_file_is_small(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    assert os.path.getsize(os.path.join(CHECKOUT, "BENCHMARK.json")) <= 64 * 1024
