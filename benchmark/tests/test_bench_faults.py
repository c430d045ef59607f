"""Whole runs of each cell at tiny sizes on the CPU, the look for a card
skipped: a sound program comes out correct, and each fault a driver plants
in the program's timed path (a step that leaves the state unchanged, half
of the batch left out with the mean taken over the rest, the recache's
answer altered where it is made, a render chunk's answers lost, the fine
pass fed the coarse samples only) comes out not correct; so does the
render's control, whose TF32 the reference emulates on any device."""

import contextlib
import json

import pytest
import torch

import readings
import run
from harness import judge, manifest
from tiny import tiny_copy

CELLS = {"scannet-train": ("unchanged", "half_batch"),
         "prior-step": ("unchanged", "half_batch", "answer"),
         "scannet-render": ("chunk_lost", "coarse_only")}


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


def test_render_control_is_not_correct(root):
    limits = manifest.load(root, "scannet-render").cell["limits"]
    for seed, checks, _ in readings.readings("scannet-render", "control", (2147483651, 11),
                                             root=root, require=lambda n: None):
        assert not judge.verdict(checks, limits), (seed, checks)
