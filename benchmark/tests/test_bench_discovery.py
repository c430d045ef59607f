"""A cell, a configuration, a traffic mix and a per-layer metric that exist
only as files in a temporary folder are found by name and run, with no
change to the harness."""

import json
import os

from harness import manifest

DRIVER = '''
import time

class Run:
    failed = 0
    def __init__(self):
        self.steps, self.work = 0, []

def setup(ctx):
    return Run()

def step(run):
    run.steps += 1
    run.work.append({"n": 2})
    time.sleep(0.001)

def sync(run):
    pass

def finish(run):
    return {"steps": run.steps}, None

def judge_run(ctx, record, inputs):
    return {"steps_seen": 0.0 if record["steps"] > 0 else 1.0}
'''
METRIC = '''
def read(trace, ctx):
    return float(ctx.work["units"]) / max(ctx.steps, 1)
'''
COUNTS = '''
def work(config, step):
    return {"units": config["size"] * step["n"]}
'''


def _write(root, rel, text):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fp:
        fp.write(text if isinstance(text, str) else json.dumps(text))


def _bench(tmp):
    root = os.path.join(tmp, "benchmark")
    _write(tmp, "BENCHMARK.json", {
        "command": ["python3", "benchmark/run.py"], "paths": ["benchmark"], "run_seconds": 1,
        "configs": [{"name": "demo-config", "source": "https://example.org/demo",
                     "file": "benchmark/configs/demo-config.json", "reduced": [], "why": "demo"}],
        "workloads": [{"name": "demo-cell", "config": "demo-config", "traffic": "demo-mix",
                       "chips": 1, "why": "demo"}],
        "end_to_end": [{"name": "demo_ms", "unit": "ms", "better": "lower", "bound": 0.05,
                        "source": "host_clock"},
                       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                        "source": "host_clock"}],
        "per_layer": [{"name": "demo.units", "unit": "1", "better": "higher",
                       "source": "program_counter", "layer": "demo", "moves": "demo_ms"}]})
    _write(root, "configs/demo-config.json", {"name": "demo-config", "size": 3, "reduced": []})
    _write(root, "traffic/demo-mix.json", {"driver": "demo_driver", "trace_warm_steps": 1,
                                           "trace_steps": 2})
    _write(root, "cells/demo-cell.json", {"per_step_metric": "demo_ms",
                                          "limits": {"steps_seen": 0.0}})
    _write(root, "drivers/demo_driver.py", DRIVER)
    _write(root, "metrics/demo.units.py", METRIC)
    _write(root, "counts/demo-config.py", COUNTS)
    return root


def test_load_finds_everything_by_name(tmp_path):
    root = _bench(str(tmp_path))
    wl = manifest.load(root, "demo-cell")
    assert wl.config["size"] == 3 and wl.traffic["driver"] == "demo_driver"
    assert [m["name"] for m in wl.end_to_end] == ["demo_ms", "setup_s"]
    assert [m["name"] for m in wl.per_layer] == ["demo.units"]
    assert wl.counts().work(wl.config, {"n": 2}) == {"units": 6}
    assert hasattr(wl.driver(), "judge_run")


def test_run_drives_a_cell_it_has_never_seen(tmp_path, capsys):
    import run

    root = _bench(str(tmp_path))
    assert run.main(["--workload", "demo-cell", "--seed", "2147483999", "--seconds", "0.05",
                     "--trace", "0"], root=root, require=lambda n: None) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] >= 1
    assert set(result["metrics"]) == {"demo_ms", "setup_s"}
    assert list(result)[-1] == "checks"
    assert run.main(["--workload", "demo-cell", "--seed", "5", "--seconds", "0.05",
                     "--trace", "1"], root=root, require=lambda n: None) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["metrics"] == {"demo.units": {"value": 6.0, "unit": "1"}}
    assert "window_s" in result["device"] and "breakdown" in result
