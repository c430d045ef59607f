"""Prior training over ranks (``prior/train.py --data_parallel``) on the CPU:
2 gloo processes against 1 process and against the JAX package.

- Global-batch BatchNorm: a (4, 6, 5, 7) batch split over 2 ranks inside
  ``dist.global_batch`` gives the single-process BatchNorm's output, input
  grads, parameter grads (summed over the ranks) and running statistics on
  the whole batch.
- The plane loss's normalizer, every image's count of groups, counted
  over the global batch: the five-loss criterion's per-image totals on a
  112×128 batch with planes (the model-free case; at the 64 crop no plane
  reaches the loss's 9,000 pixels) over 2 ranks against 1 process and JAX.
- One SGD step at global B=4 (64 crop, ``PriorConfig(d_latent=8)
  .with_small()``, the five-loss default on quality-3 images) from the JAX
  package's seeded weights, on the JAX package's own draws (fed as
  tests/test_torch_prior_train.py::test_train_step_matches_jax feeds them):
  2 ranks (each its block of images, z and draws) against the port's
  1-process step and against ``make_train_step``.
- The CLI: ``--data_parallel --dataset multi`` on 2 ranks for 2 epochs
  against the 1-process run, on a 3-source corpus cut to 12 examples by
  ``--sample_ratio 0.8`` (no remainder); then, in the same two processes,
  1 epoch of all 15 examples with zero z (``--debug_mode``), whose
  remainder batch of 3 does not split over 2 ranks and is dropped.

Tolerances (measured values from one CPU run of this file):
- BatchNorm: output and grads 1e-5 of their largest magnitude (measured
  1.7e-7), running statistics 1e-6 of theirs (measured 9.5e-8), equal on
  both ranks;
- the criterion's totals over 2 ranks: 1e-6 of their largest against 1
  process (measured 0), 1e-5 against JAX (measured 7.7e-8); each rank's own
  count instead moves them by more than 1e-3 (measured 2.2e-2);
- the step's loss and its parts: 1e-5 relative, against 1 process
  (measured 1.2e-7) and against JAX (measured 3.5e-7);
- parameters and BatchNorm statistics after the step: against 1 process
  test_prior_dp.py's rtol 2e-4 / atol 1e-6 (measured: largest
  |Δ| / (atol + rtol·|ref|) 0.054), equal on both ranks; against JAX
  test_torch_prior_train.py's bound on the update, 1e-3 of the largest
  update (measured 5.8e-4; JAX's own 8-device step meets
  test_prior_dp.py's bound against its 1-device one, but two frameworks'
  f32 steps differ by more), statistics 1e-4 of their largest (measured
  2.1e-6);
- the CLI over 6 steps: the cached z equal, the visit order equal, the
  ranks' checkpoints equal; against the 1-process run the first step's
  loss 1e-5 relative (measured equal), every step's 2e-3 (measured
  3.1e-4 at the 6th), the checkpoint's parameters 1e-2 of the largest
  change over the run (measured 2.7e-3) and its statistics 2e-3 of their
  largest (measured 3.2e-4). Both runs are f32, and this model's steps
  amplify a reordered sum about tenfold a step (at B=4 the train-mode
  BatchNorms subtract the mean of nearly uniform gradients): the same
  1-process run on 1 thread against 4, which sums in another order and
  nothing else, differs by 7.9e-4 in the 6th step's loss, 6.3e-3 of the
  change in the parameters and 1.1e-3 in the statistics. The bounds sit
  above that witness.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scade_tpu.prior import train as jtrain
from scade_tpu.prior.losses import criterion as jcriterion
from scade_tpu_torch.prior import blocks, losses, train
from test_torch_prior_losses import jax_criterion_draws, nchw, scene, seeded_planes
from test_torch_prior_train import batch_np, jax_prior, port_prior, seeded_shifts, shift_dims, \
    state_of

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
D_LATENT = 8

# One rank of the BatchNorm and step checks: reads the case the test wrote,
# runs its block under the process group, writes what it computed.
STEP_WORKER = """
import os, sys, torch
torch.set_num_threads(1)
from scade_tpu_torch.parallel import dist
from scade_tpu_torch.prior import blocks, losses, model, train
case = torch.load(sys.argv[1], weights_only=False)
ranks, device, backend = dist.init_from_env("cpu")
mine = ranks.block(4)
bn = blocks.BatchNorm2d(6)
bn.load_state_dict(case["bn_state"])
x = case["bn_x"][mine].clone().requires_grad_(True)
with dist.global_batch(ranks):
    y = bn(x)
(y * case["bn_w"][mine]).sum().backward()
bn_out = dict(y=y.detach(), x_grad=x.grad, w_grad=bn.weight.grad, b_grad=bn.bias.grad,
              state=bn.state_dict())
crit = {}
for name, ctx in (("global", dist.global_batch(ranks)), ("local", dist.global_batch(None))):
    with ctx:
        crit[name] = losses.criterion(case["crit_pred"][mine],
                                      train.rows_of(case["crit_batch"], mine),
                                      losses.DEFAULT_LOSS_MODE,
                                      train.draws_of(case["crit_draws"], mine))[1]
m = model.build_prior_model(case["cfg"])
m.load_state_dict(case["init"], strict=True)
tc = train.PriorTrainConfig()
opt = train.PriorOptimizer(m, tc)
total, loss_dict = train.train_step(
    m, opt, case["shifts"], train.rows_of(case["batch"], mine), case["z"][mine],
    train.draws_of(case["draws"], mine), tc, ranks)
torch.save(dict(bn=bn_out, crit=crit, total=float(total),
                losses={k: float(v) for k, v in loss_dict.items()}, state=m.state_dict()),
           os.path.join(sys.argv[2], f"rank{ranks.rank}.pt"))
dist.destroy()
"""

# One rank of the CLI: prior.train.main, once for each run of the spec (its
# argv, its output directory and its coordinator's port), with the functions
# that write files wrapped, so the rank records what each run wrote.
CLI_WORKER = """
import json, os, sys, torch
torch.set_num_threads(1)
from scade_tpu_torch.prior import train
rank = int(os.environ["SCADE_PROCESS_ID"])
wrote = []
def spy(name, fn):
    def wrapped(*a, **k):
        wrote.append(name)
        return fn(*a, **k)
    return wrapped
train.save_checkpoint = spy("pth", train.save_checkpoint)
train.write_loss_jsonl = spy("jsonl", train.write_loss_jsonl)
adain = train.compute_adain_stats
def adain_spy(*a, **k):
    if a[4] is not None:
        wrote.append("mean_var")
    return adain(*a, **k)
train.compute_adain_stats = adain_spy
for run in json.load(open(sys.argv[1])):
    os.environ["SCADE_COORDINATOR"] = f"localhost:{run['port']}"
    wrote.clear()
    res = train.main(run["argv"])
    out = run["out"]
    torch.save(res["model"].state_dict(), os.path.join(out, f"rank{rank}.pt"))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(dict(wrote=wrote, losses=res["losses"], z=res["z"].tolist(),
                       order=res["order"]), f)
"""


def cli_spec(path, runs):
    """Writes the CLI worker's spec: each run's output directory and argv,
    and a port of its own for its process group → the spec's path."""
    with open(path, "w") as f:
        json.dump([dict(out=str(out), argv=argv, port=free_port()) for out, argv in runs], f)
    return str(path)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(worker: str, args, out_dir, world=2):
    """``worker`` as ``world`` gloo ranks (SCADE_COORDINATOR); → the Popen
    handles, still running."""
    path = os.path.join(out_dir, "worker.py")
    with open(path, "w") as f:
        f.write(worker)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               SCADE_COORDINATOR=f"localhost:{port}", SCADE_NUM_PROCESSES=str(world))
    return [subprocess.Popen([sys.executable, path, *args], cwd=out_dir, text=True,
                             env=dict(env, SCADE_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT) for r in range(world)]


def wait(procs):
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return "\n".join(logs)


def rel_err(got, ref):
    return (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


# ---------------------------------------------------------------------------
# the BatchNorm and the step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    """The JAX step, the case for the ranks (started first, so they run while
    JAX and the 1-process step do), then the 1-process port step."""
    out = tmp_path_factory.mktemp("prior_dp_step")
    jm, variables = jax_prior("enc", "v2")
    shifts = seeded_shifts(shift_dims("enc"))
    b = batch_np(4, seed=21)
    b["quality_flg"] = np.full((4,), 3, np.int32)  # opens the PWN edge loss
    z = np.random.default_rng(22).standard_normal((4, D_LATENT)).astype(np.float32)
    key = jax.random.PRNGKey(23)
    draws = jax_criterion_draws(key, b)
    init = state_of(variables["params"], variables["batch_stats"], "enc", "v2")
    rng = np.random.default_rng(24)
    bn = blocks.BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 6).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
    bn_x = torch.from_numpy((3.0 + 2.0 * rng.standard_normal((4, 6, 5, 7))).astype(np.float32))
    bn_w = torch.from_numpy(rng.standard_normal((4, 6, 5, 7)).astype(np.float32))
    tshifts = {k: torch.from_numpy(v) for k, v in shifts.items()}
    tbatch = train.batch_to_torch(b, "cpu")
    cjb, ctb, cpred = scene(4, 112, 128, seed=25, quality=3, invalid_rows=6,
                            planes=seeded_planes(4, 112, 128, seed=26))
    ckey = jax.random.PRNGKey(27)
    cdraws = jax_criterion_draws(ckey, cjb)
    case = dict(cfg=port_prior(variables, "enc", "v2").cfg, init=init, shifts=tshifts,
                batch=tbatch, z=torch.from_numpy(z), draws=draws, bn_state=bn.state_dict(),
                bn_x=bn_x, bn_w=bn_w, crit_pred=nchw(cpred), crit_batch=ctb, crit_draws=cdraws)
    torch.save(case, out / "case.pt")
    procs = launch(STEP_WORKER, [str(out / "case.pt"), str(out)], str(out))

    tc = jtrain.PriorTrainConfig(d_latent=D_LATENT)
    opt = jtrain.make_prior_optimizer(variables["params"], tc)
    params, stats, _, total, loss_dict = jtrain.make_train_step(jm, tc, opt)(
        jax.tree.map(jnp.array, variables["params"]),
        jax.tree.map(jnp.array, variables["batch_stats"]), opt.init(variables["params"]),
        {k: jnp.asarray(v) for k, v in shifts.items()}, {k: jnp.asarray(v) for k, v in b.items()},
        jnp.asarray(z), key)
    jax_out = dict(total=float(total), losses={k: float(v) for k, v in loss_dict.items()},
                   state=state_of(params, stats, "enc", "v2"))

    m = port_prior(variables, "enc", "v2")
    ptc = train.PriorTrainConfig()
    one_total, one_losses = train.train_step(m, train.PriorOptimizer(m, ptc), tshifts, tbatch,
                                             torch.from_numpy(z), draws, ptc)
    one = dict(total=float(one_total), losses={k: float(v) for k, v in one_losses.items()},
               state=m.state_dict())

    crit_one = losses.criterion(nchw(cpred), ctb, losses.DEFAULT_LOSS_MODE, cdraws)[1]
    crit_jax = np.asarray(jcriterion(ckey, jnp.asarray(cpred), {k: jnp.asarray(v) for k, v in
                                                                 cjb.items()},
                                     losses.DEFAULT_LOSS_MODE)[1])
    x = bn_x.clone().requires_grad_(True)
    bn.train()
    y = bn(x)
    (y * bn_w).sum().backward()
    bn_one = dict(y=y.detach(), x_grad=x.grad, w_grad=bn.weight.grad, b_grad=bn.bias.grad,
                  state=bn.state_dict())

    log = wait(procs)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(jax=jax_out, one=one, ranks=ranks, init=init, bn_one=bn_one, log=log,
                params={n for n, _ in m.named_parameters()}, crit_one=crit_one,
                crit_jax=crit_jax)


def test_global_batchnorm_equals_one_process(step_case):
    one, (r0, r1) = step_case["bn_one"], (r["bn"] for r in step_case["ranks"])
    y = torch.cat([r0["y"], r1["y"]])
    xg = torch.cat([r0["x_grad"], r1["x_grad"]])
    assert rel_err(y, one["y"]) <= 1e-5
    assert rel_err(xg, one["x_grad"]) <= 1e-5
    assert rel_err(r0["w_grad"] + r1["w_grad"], one["w_grad"]) <= 1e-5
    assert rel_err(r0["b_grad"] + r1["b_grad"], one["b_grad"]) <= 1e-5
    for k, v in one["state"].items():
        assert torch.equal(r0["state"][k], r1["state"][k]), k
        if v.is_floating_point():
            assert rel_err(r0["state"][k], v) <= 1e-6, k
        else:
            assert torch.equal(r0["state"][k], v), k


def test_plane_loss_counts_the_global_batch(step_case):
    """The plane loss divides by every image's count of groups (losses.py
    :690): over 2 ranks inside ``global_batch`` the per-image totals of the
    five-loss criterion (quality 3, planes of 9,000+ pixels at 112×128, on
    the JAX package's draws) are 1 process's and JAX's; with each rank's
    count alone they are not."""
    r0, r1 = (r["crit"] for r in step_case["ranks"])
    one = step_case["crit_one"]
    got = torch.cat([r0["global"], r1["global"]])
    assert rel_err(got, one) <= 1e-6
    assert np.abs(got.numpy() - step_case["crit_jax"]).max() <= 1e-5 * np.abs(
        step_case["crit_jax"]).max()
    assert rel_err(torch.cat([r0["local"], r1["local"]]), one) > 1e-3


def test_two_rank_step_equals_one_process_and_jax(step_case):
    r0, r1 = step_case["ranks"]
    one, jx, init = step_case["one"], step_case["jax"], step_case["init"]
    assert r0["losses"] == r1["losses"] and r0["total"] == r1["total"]
    assert one["losses"]["pairwise-normal-regress-edge_loss"] > 0
    for ref in (one, jx):
        assert abs(r0["total"] - ref["total"]) <= 1e-5 * abs(ref["total"])
        assert sorted(r0["losses"]) == sorted(ref["losses"])
        for k, v in ref["losses"].items():
            assert abs(r0["losses"][k] - v) <= 1e-5 * abs(v), k
    moved = max((jx["state"][n] - init[n]).abs().max().item() for n in step_case["params"])
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
        if not v.is_floating_point():
            continue
        torch.testing.assert_close(v, one["state"][k], rtol=2e-4, atol=1e-6, msg=k)
        if k in step_case["params"]:
            assert (v - jx["state"][k]).abs().max().item() <= 1e-3 * moved, k
        else:
            assert rel_err(v, jx["state"][k]) <= 1e-4, k


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SOURCES = {"taskonomy": 3, "diml_ganet": 5, "3d-ken-burns": 2}


def write_corpus(root, rng):
    import cv2

    for name, n in SOURCES.items():
        d = root / name
        (d / "annotations").mkdir(parents=True)
        (d / "imgs").mkdir()
        annos = []
        yy, xx = np.mgrid[0:40, 0:48]
        for i in range(n):
            depth = (2000 + 100 * xx + 60 * yy + rng.integers(0, 400, (40, 48))).astype(np.uint16)
            rgb = np.stack([(depth // 40) % 256, (3 * xx) % 256, (5 * yy) % 256], -1)
            anno = {"rgb_path": f"{name}/imgs/{i}.png"}
            cv2.imwrite(str(root / anno["rgb_path"]), rgb.astype(np.uint8))
            key = "disp_path" if name == "diml_ganet" else "depth_path"
            anno[key] = f"{name}/imgs/{i}_d.png"
            cv2.imwrite(str(root / anno[key]), depth)
            annos.append(anno)
        with open(d / "annotations" / "train_annotations.json", "w") as f:
            json.dump(annos, f)


def cli_flags(root, log, *extra):
    return ["--dataset", "multi", "--dataroot", str(root / "corpus"), "--dataset_list",
            *SOURCES, "--log_dir", str(log), "--small_model", "--image_size", "64",
            "--d_latent", str(D_LATENT), "--batchsize", "4", "--num_samples", "4",
            "--mini_batch_size", "2", "--device", "cpu", "--seed_num", "3", *extra]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both 2-rank runs, one after the other in one launch; the 1-process
    run meanwhile."""
    root = tmp_path_factory.mktemp("prior_dp_cli")
    (root / "corpus").mkdir()
    write_corpus(root / "corpus", np.random.default_rng(5))
    flags = {"match": ["--epochs", "2", "--sample_ratio", "0.8"],
             "remainder": ["--epochs", "1", "--debug_mode", "--adain_subset", "2"]}
    dirs = {name: root / name for name in flags}
    for out in dirs.values():
        out.mkdir()
    spec = cli_spec(root / "spec.json", [
        (dirs[name], cli_flags(root, dirs[name] / "log", *extra, "--loss_jsonl",
                               str(dirs[name] / "losses.jsonl"), "--data_parallel"))
        for name, extra in flags.items()])
    procs = launch(CLI_WORKER, [spec], str(root))
    one = train.main(cli_flags(root, root / "one", *flags["match"],
                               "--loss_jsonl", str(root / "one.jsonl")))
    log = wait(procs)
    ranks = {name: [json.load(open(out / f"rank{r}.json")) for r in range(2)]
             for name, out in dirs.items()}
    return dict(root=root, one=one, log=log, ranks=ranks, dirs=dirs)


def test_cli_two_ranks_train_as_one_process(cli_runs):
    one, (r0, r1) = cli_runs["one"], cli_runs["ranks"]["match"]
    out = cli_runs["dirs"]["match"]
    assert "data-parallel over 2 ranks" in cli_runs["log"]
    assert "12 training examples" in cli_runs["log"]
    assert r0["order"] == r1["order"] == one["order"]
    assert r0["order"]["source"][:3] == list(SOURCES)  # round-robin
    np.testing.assert_array_equal(np.array(r0["z"], np.float32), one["z"])
    assert r0["z"] == r1["z"]
    recs = [json.loads(x) for x in open(out / "losses.jsonl")]
    ref_recs = [json.loads(x) for x in open(cli_runs["root"] / "one.jsonl")]
    assert [(r["step"], r["epoch"]) for r in recs] == [(i, i // 3) for i in range(6)]
    errs = [abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
            for a, b in zip(recs, ref_recs)]
    assert len(errs) == 6 and errs[0] <= 1e-5 and max(errs) <= 2e-3, errs
    ck = torch.load(out / "log" / "epoch1_step0.pth")["model_state_dict"]
    s0, s1 = (torch.load(out / f"rank{r}.pt") for r in range(2))
    assert all(torch.equal(s0[k], s1[k]) and torch.equal(s0[k], ck[k]) for k in ck)
    init = train.build_model(train.parse_args(cli_flags(cli_runs["root"], "x")), "cpu").state_dict()
    ref = one["model"].state_dict()
    params = {n for n, _ in one["model"].named_parameters()}
    moved = max((ref[n] - init[n]).abs().max().item() for n in params)
    perr = max((ck[k] - ref[k]).abs().max().item() for k in params) / moved
    serr = max(rel_err(ck[k], v) for k, v in ref.items()
               if k not in params and v.is_floating_point())
    assert perr <= 1e-2 and serr <= 2e-3, (perr, serr)
    # only rank 0 wrote: the AdaIn statistics, the checkpoints, the losses
    assert r0["wrote"] == ["mean_var", "jsonl", "pth", "jsonl", "pth"] and r1["wrote"] == []
    assert sorted(os.listdir(out / "log")) == ["epoch0_step0.pth", "epoch1_step0.pth",
                                               "mean_var_adain.npy"]


def test_cli_drops_the_remainder_batch(cli_runs):
    """15 examples in batches of 4: the last batch of 3 does not split over
    2 ranks and is dropped, as tools/train_prior.py drops it."""
    r0, r1 = cli_runs["ranks"]["remainder"]
    out = cli_runs["dirs"]["remainder"]
    assert "15 training examples" in cli_runs["log"]
    assert len(r0["z"]) == 15 and r0["z"] == r1["z"]
    recs = [json.loads(x) for x in open(out / "losses.jsonl")]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert r1["wrote"] == [] and "pth" in r0["wrote"]
    assert np.isfinite(r0["losses"]).all()


def test_batch_that_does_not_split_is_refused(tmp_path):
    """``--batchsize`` must divide over the ranks (tools/train_prior.py
    :250-252); checked before any data is read."""
    spec = cli_spec(tmp_path / "spec.json", [
        (tmp_path, ["--dataset", "multi", "--dataroot", "none", "--batchsize", "3",
                    "--data_parallel", "--device", "cpu"])])
    procs = launch(CLI_WORKER, [spec], str(tmp_path))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode != 0 for p in procs)
    assert "--batchsize 3 not divisible by the 2-device data axis" in "".join(logs)


def test_ranks_count_their_hosts(monkeypatch):
    """The sampler's replicas are the hosts: the distinct names of the
    ranks' hosts, whichever launcher started them."""
    from scade_tpu_torch.parallel import dist

    names = ["a", "a", "b", "b", "c", "c"]
    monkeypatch.setattr(dist.dist, "all_gather_object",
                        lambda out, obj: out.__setitem__(slice(None), names))
    assert dist.Ranks(3, 6).hosts() == 3
    names[:] = ["a"] * 6
    assert dist.Ranks(0, 6).hosts() == 1


def test_draws_follow_the_generator_in_lockstep():
    """Two generators of one seed give one rank's block of the global draws
    whichever rank asks: the draws depend on the global batch only."""
    b = train.batch_to_torch(batch_np(4, seed=30), "cpu")
    d1 = losses.draw_criterion(torch.Generator().manual_seed(7), b, losses.DEFAULT_LOSS_MODE)
    d2 = losses.draw_criterion(torch.Generator().manual_seed(7), b, losses.DEFAULT_LOSS_MODE)
    block = slice(2, 4)
    for k in d1:
        for a, c in zip(train.draws_of(d1, block)[k], train.draws_of(d2, block)[k]):
            assert torch.equal(a, c) and a.shape[0] == 2
