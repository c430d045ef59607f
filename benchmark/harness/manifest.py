"""Finds what a workload names, by name, as files under the benchmark's root.

``BENCHMARK.json`` (beside the benchmark's folder) lists the workloads,
configurations and metrics. Everything that belongs to one of them is a
file of its own:

- ``configs/<config>.json``: a configuration's sizes as run, its source,
  ``reduced`` and ``assumed``, its precision flags and its reference;
- ``traffic/<traffic>.json``: a traffic mix's parameters and the driver
  that generates it;
- ``cells/<workload>.json``: a cell's limits for the comparison that
  decides ``correct``, and what it expects of the program's counters;
- ``drivers/<driver>.py``: set-up, the closed loop's step, and the
  comparison with the plain reference, for one kind of traffic;
- ``metrics/<metric>.py``: ``read(trace, ctx)`` of one per-layer metric;
- ``counts/<config>.py``: ``work(config, step)``, the operations and bytes
  of a step, worked out from shapes.

A later change adds a cell, a configuration or a metric by adding files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional


def load_module(path: str, name: str):
    """The module in the file ``path``, imported under ``name``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _json(path: str) -> dict:
    with open(path) as fp:
        return json.load(fp)


@dataclasses.dataclass
class Workload:
    """One cell, with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    cell: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str

    def driver(self):
        name = self.traffic["driver"]
        return load_module(os.path.join(self.root, "drivers", f"{name}.py"), f"bench_driver_{name}")

    def counts(self):
        name = self.config["name"]
        return load_module(os.path.join(self.root, "counts", f"{name}.py"),
                           f"bench_counts_{name.replace('-', '_')}")

    def metric_reader(self, name: str):
        return load_module(os.path.join(self.root, "metrics", f"{name}.py"),
                           "bench_metric_" + name.replace(".", "_").replace("-", "_"))


def reports(metric: dict, workload: str, end_to_end: Dict[str, dict]) -> bool:
    """Whether ``workload`` reports ``metric``: its ``workloads`` list where
    it has one, else every workload that reports the end-to-end metric it
    moves (for an end-to-end metric without a list: every workload)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return reports(end_to_end[moves], workload, end_to_end)


def load(root: str, workload: str, manifest: Optional[str] = None) -> Workload:
    """The workload ``workload`` of the manifest (by default
    ``BENCHMARK.json`` in the folder above ``root``)."""
    manifest = manifest or os.path.join(os.path.dirname(os.path.abspath(root)), "BENCHMARK.json")
    bench = _json(manifest)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {manifest}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, "configs", f"{w['config']}.json"))
    if config.get("name") != w["config"] or w["config"] not in configs:
        raise ValueError(f"configs/{w['config']}.json does not hold the configuration "
                         f"{w['config']!r} of the manifest")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return Workload(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=_json(os.path.join(root, "traffic", f"{w['traffic']}.json")),
        cell=_json(os.path.join(root, "cells", f"{workload}.json")),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, workload, e2e)],
        per_layer=[m for m in bench["per_layer"] if reports(m, workload, e2e)],
        root=root,
    )
