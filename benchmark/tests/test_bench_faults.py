"""Whole runs of each cell at tiny sizes on the CPU, the look for a card
skipped: a sound program comes out correct, and each fault a driver plants
in the program's timed path (a step that leaves the state unchanged, half
of the batch left out with the mean taken over the rest, the recache's
answer altered where it is made) comes out not correct."""

import contextlib
import json

import pytest
import torch

import run
from harness import manifest
from tiny import tiny_copy

CELLS = {"scannet-train": ("unchanged", "half_batch"),
         "prior-step": ("unchanged", "half_batch", "answer")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_copy(str(tmp_path_factory.mktemp("bench")))


def _run(root, workload, fault, capsys):
    driver = manifest.load(root, workload).driver()
    patch = driver.FAULTS[fault]() if fault else contextlib.nullcontext()
    with patch:
        assert run.main(["--workload", workload, "--seed", "2147483650", "--seconds", "0.2",
                         "--trace", "0"], root=root, require=lambda n: None) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in CELLS.items()
                                            for f in (None,) + fs])
def test_fault_turns_correct_false(root, workload, fault, capsys):
    result = _run(root, workload, fault, capsys)
    assert result["correct"] is (fault is None), result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


def test_every_planted_fault_is_tested(root):
    for workload, faults in CELLS.items():
        assert set(manifest.load(root, workload).driver().FAULTS) == set(faults)
