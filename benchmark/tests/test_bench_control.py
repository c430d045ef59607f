"""On the card, at each cell's own size: the control (the nearest precision
below the configuration's, in the program's place) fails the comparison
that decides ``correct`` on three seeds. Run with
``python -m pytest benchmark/tests -m cuda`` on the card."""

import json
import os

import pytest

import readings
from conftest import BENCH
from harness import judge

SEEDS = (7001, 7002, 2147483711)


def _limits(workload):
    with open(os.path.join(BENCH, "cells", f"{workload}.json")) as fp:
        return json.load(fp)["limits"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["scannet-train", "prior-step", "scannet-render"])
def test_control_is_not_correct(cuda, workload):
    limits = _limits(workload)
    for seed, checks, _ in readings.readings(workload, "control", SEEDS):
        assert not judge.verdict(checks, limits), (seed, checks)
