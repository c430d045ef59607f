"""Data parallelism in the port (``--multihost``, ``parallel/dist.py``): the
CLI on 2 gloo processes on the CPU against 1 process, at the small config of
tests/test_multihost.py (width 16, 4+8 samples, multires 2, N_rand 16, 2
steps, on a 32x48 synthetic scene).

Every rank draws the whole step's batch and its draws and renders its block
of rays, so 2 ranks train what 1 process trains. The two differ only in the
order of f32 sums: each rank's grads and metrics are partial sums, added
across ranks. Tolerance: max abs 1e-5 on the losses and the parameters after
2 steps (Adam moves a parameter by at most lr = 5e-4 a step), and on the
first step's grads as applied, summed over the ranks, 1e-5 of their largest
(Adam is blind to the grads' scale, so only they show a wrong 1/world); the
ranks' parameters are bit-equal; a test view rendered over 2 ranks scores what 1
process scores within 1e-6 relative (a ray renders alone).
"""

import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from scade_tpu_torch import cli
from scade_tpu_torch.parallel import dist
from scade_tpu_torch.train import step

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SMALL = ["--N_samples", "4", "--N_importance", "8", "--multires", "2", "--netwidth", "16",
         "--netwidth_fine", "16", "--N_rand", "16", "--chunk", "2048", "--num_hypothesis", "2",
         "--cimle_dir", "dump", "--device", "cpu"]
TRAIN = ["--num_iterations", "2", "--i_weights", "2", "--i_print", "1", "--i_img", "1000000"]
TOL = 1e-5
GRAD_REL = 1e-5
METRICS_REL = 1e-6


def first_grads_spy(step_module, into: list):
    """Wraps ``step_module.apply_grads`` so that ``into`` receives the first
    step's grads (NeRF params, scales, shifts) as the step applies them."""
    apply = step_module.apply_grads

    def wrapped(state, grads, g_scales, g_shifts, *args, **kwargs):
        if not into:
            wrt = state.nerf_params() + [state.scales, state.shifts]
            into.append(torch.cat([(torch.zeros_like(p) if g is None else g.detach()).flatten()
                                   for g, p in zip((*grads, g_scales, g_shifts), wrt)]))
        return apply(state, grads, g_scales, g_shifts, *args, **kwargs)
    return wrapped


# One rank: the CLI's main with the functions that write files wrapped, so
# the rank records what it wrote; then its parameters and first grads.
WORKER = """
import json, os, sys, torch
torch.set_num_threads(1)
from scade_tpu_torch import cli
from scade_tpu_torch.eval import evaluate
from scade_tpu_torch.train import loop, step
sys.path.insert(0, sys.argv[1])
out, argv = sys.argv[2], sys.argv[3:]
from test_torch_parallel import first_grads_spy
rank = int(os.environ.get("RANK", os.environ.get("SCADE_PROCESS_ID", "0")))
grads = []
step.apply_grads = first_grads_spy(step, grads)
wrote = []
def spy(name, fn):
    def wrapped(*a, **k):
        wrote.append(name)
        return fn(*a, **k)
    return wrapped
loop.save_checkpoint = spy("tar", loop.save_checkpoint)
loop.Writer = spy("tb", loop.Writer)
loop.write_images_with_metrics = spy("test_images", loop.write_images_with_metrics)
evaluate.write_images_with_metrics = spy("test_images", evaluate.write_images_with_metrics)
json.dump = spy("json", json.dump)
state = cli.main("scannet", argv)
if argv[0] == "train":
    params = {f"{w}.{n}": t.detach().clone() for w, m in (("coarse", state.model_coarse),
              ("fine", state.model_fine)) for n, t in m.state_dict().items()}
    torch.save(params, os.path.join(out, f"rank{rank}.pt"))
    torch.save(grads[0], os.path.join(out, f"rank{rank}_grads.pt"))
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    f.write(repr(wrote))
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_synthetic_scene.py"),
                    str(root / "scene"), "--H", "32", "--W", "48", "--K", "2", "--n_train", "2",
                    "--n_val", "1", "--n_test", "1", "--n_video", "0"],
                   check=True, capture_output=True)
    return root


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def common(root, expname):
    return ["--data_dir", str(root), "--scene_id", "scene", "--ckpt_dir", str(root / "ckpt"),
            "--expname", expname, *SMALL]


def two_ranks(root, name, argv, torchrun=False):
    """``argv`` through the CLI on 2 gloo ranks, each in its own working
    directory (the TB root is relative to it). Returns per rank (its output,
    what it wrote, its working directory)."""
    out = root / f"out_{name}"
    out.mkdir()
    worker = out / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    port = free_port()
    if torchrun:
        cwd = root / f"cwd_{name}"
        cwd.mkdir()
        cmds = [([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                  "--master_addr", "localhost", "--master_port", str(port), str(worker),
                  TESTS, str(out), *argv, "--multihost"], env, cwd)]
    else:
        cmds = []
        for rank in range(2):
            cwd = root / f"cwd_{name}_{rank}"
            cwd.mkdir()
            cmds.append(([sys.executable, str(worker), TESTS, str(out), *argv, "--multihost"],
                         dict(env, SCADE_COORDINATOR=f"localhost:{port}", SCADE_NUM_PROCESSES="2",
                              SCADE_PROCESS_ID=str(rank)), cwd))
    procs = [subprocess.Popen(c, env=e, cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c, e, d in cmds]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = []
    for rank in range(2):
        with open(out / f"rank{rank}.json") as f:
            wrote = eval(f.read())
        ranks.append(dict(wrote=wrote, out=out, cwd=cmds[0 if torchrun else rank][2]))
    return "\n".join(logs), ranks


def scalars(path):
    return [json.loads(x) for x in open(path).read().splitlines()]


@pytest.mark.parametrize("flags", [[], ["--is_joint", "true", "--mask_corners", "true"]],
                         ids=["default", "joint_corners"])
def test_two_ranks_train_as_one_process(root, monkeypatch, flags):
    name = "joint" if flags else "plain"
    monkeypatch.chdir(root)
    grads = []
    monkeypatch.setattr(step, "apply_grads", first_grads_spy(step, grads))
    one = cli.main("scannet", ["train", *common(root, f"one_{name}"), *TRAIN, *flags])
    log, ranks = two_ranks(root, name, ["train", *common(root, f"two_{name}"), *TRAIN, *flags])
    assert "multihost: rank 0/2 on cpu, gloo" in log and "multihost: rank 1/2" in log
    assert "Training data-parallel over 2 ranks, 8 rays a rank" in log

    p0, p1 = (torch.load(ranks[0]["out"] / f"rank{r}.pt") for r in range(2))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)  # every rank took the same step
    ref = {f"{w}.{n}": t for w, m in (("coarse", one.model_coarse), ("fine", one.model_fine))
           for n, t in m.state_dict().items()}
    assert max((p0[k] - ref[k]).abs().max().item() for k in ref) <= TOL
    g0, g1 = (torch.load(ranks[0]["out"] / f"rank{r}_grads.pt") for r in range(2))
    assert torch.equal(g0, g1)
    assert (g0 - grads[0]).abs().max().item() <= GRAD_REL * grads[0].abs().max().item()
    tar = torch.load(root / "ckpt" / f"two_{name}" / "000002.tar")
    for w, key in (("coarse", "network_fn_state_dict"), ("fine", "network_fine_state_dict")):
        for n, t in tar[key].items():
            assert torch.equal(t, p0[f"{w}.{n.removeprefix('module.')}"])

    # the logged losses are the whole batch's
    a = scalars(root / "runs" / f"one_{name}" / "scalars.jsonl")
    b = scalars(ranks[0]["cwd"] / "runs" / f"two_{name}" / "scalars.jsonl")
    assert [(x["tag"], x["step"]) for x in a] == [(x["tag"], x["step"]) for x in b]
    for x, y in zip(a, b):
        for k, v in x.get("values", {"": x.get("value")}).items():
            w = y.get("values", {"": y.get("value")})[k]
            assert abs(v - w) <= TOL, (x["tag"], x["step"], v, w)

    # only rank 0 writes: args.json, the .tar, the TB scalars, the test images
    assert sorted(set(ranks[0]["wrote"])) == ["json", "tar", "tb", "test_images"]
    assert ranks[1]["wrote"] == [] and os.listdir(ranks[1]["cwd"]) == []
    assert sorted(os.listdir(root / "ckpt" / f"two_{name}")) == [
        "000002.tar", "args.json", "test_images_scene"]


def test_sharded_test_scores_as_one_process(root, monkeypatch):
    """``test --multihost``: each view's rays split over 2 ranks, the maps
    gathered on every rank, rank 0 writing (launched by torchrun)."""
    monkeypatch.chdir(root)
    cli.main("scannet", ["train", *common(root, "shard"), *TRAIN])
    mean, result_dir = cli.main("scannet", ["test", *common(root, "shard")])
    single = dict(mean.as_dict())
    os.rename(result_dir, str(result_dir) + "_one")
    log, ranks = two_ranks(root, "test", ["test", *common(root, "shard")], torchrun=True)
    assert "Rendering sharded over 2 ranks" in log
    assert ranks[0]["wrote"] == ["test_images"] and ranks[1]["wrote"] == []
    lines = open(os.path.join(result_dir, "metrics.txt")).read().splitlines()
    sharded = {k: float(v) for k, v in (ln.split(": ") for ln in lines)}
    assert list(sharded) == list(single)
    for k, v in single.items():
        if math.isnan(v):
            assert math.isnan(sharded[k])
        else:
            assert math.isclose(sharded[k], v, rel_tol=METRICS_REL, abs_tol=0.0), (k, v)


def test_test_opt_runs_on_rank_0_only(root, monkeypatch):
    monkeypatch.chdir(root)
    cam = ["--input_ch_cam", "2"]
    cli.main("scannet", ["train", *common(root, "opt"), *TRAIN, *cam])
    log, ranks = two_ranks(root, "opt", ["test_opt", *common(root, "opt"), *cam])
    assert "process 1: test_opt runs on process 0 only; exiting" in log
    assert "process 0: test_opt runs" not in log
    assert ranks[1]["wrote"] == [] and ranks[0]["wrote"] == ["test_images"]
    run = root / "ckpt" / "opt"
    assert np.isfinite(np.loadtxt(run / "test_latent_codes_scene" / "0.txt")).all()
    assert "psnr" in (run / "test_images_with_optimization_scene" / "metrics.txt").read_text()


def test_rays_must_split_evenly_over_ranks(root, monkeypatch):
    """A rank's block must be even; a run whose N_rand is not rounds it up
    and warns, as the JAX loop does over its devices: 2 ranks at N_rand 15
    train what 1 process trains at 16."""
    ranks = dist.Ranks(1, 2)
    assert ranks.block(16) == slice(8, 16)
    with pytest.raises(ValueError, match="evenly"):
        ranks.block(15)
    monkeypatch.chdir(root)
    one = cli.main("scannet", ["train", *common(root, "even"), *TRAIN])
    log, ranks = two_ranks(root, "odd", ["train", *common(root, "odd"), *TRAIN,
                                         "--N_rand", "15"])
    assert "WARNING: N_rand=15 not divisible by 2 devices; rounding up to 16" in log
    assert "Training data-parallel over 2 ranks, 8 rays a rank" in log
    p0, p1 = (torch.load(ranks[0]["out"] / f"rank{r}.pt") for r in range(2))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    ref = {f"{w}.{n}": t for w, m in (("coarse", one.model_coarse), ("fine", one.model_fine))
           for n, t in m.state_dict().items()}
    assert max((p0[k] - ref[k]).abs().max().item() for k in ref) <= TOL


def test_multihost_needs_a_launcher(root, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "SCADE_COORDINATOR"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        dist.init_from_env("cpu")
    assert dist.current() is None and dist.is_primary()
    with pytest.raises(SystemExit, match="expname is required for multihost"):
        cli.main("scannet", ["train", "--multihost", "--device", "cpu"])
