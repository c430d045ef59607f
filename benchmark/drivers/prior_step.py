"""Traffic: the cIMLE prior's fine-tune loop of SGD steps, as
``prior/train.py``'s trainer drives ``train_step`` between two recaches.

Set-up makes the scene's views (already resized to the crop, as
``FinetuneDataset`` leaves them) and the weights on the card from the seed,
builds the program's model and optimizer, runs the AdaIn init
(``compute_adain_stats``) and one ``recache_z`` over the views, with z
draws the benchmark makes, then one epoch of steps (every batch size the
window meets). Step i takes the next batch of ``batchsize`` views in the
trainer's order (the last batch of an epoch holds the rest), their cached
z, and the criterion's draws from ``L.draw_criterion`` with a generator
reseeded for the step; at the end of an epoch the loop reads the epoch's
mean loss to the host, as the trainer does.

The comparison: the reference (``reference/prior.py``, a network and
criterion written apart from the program's) builds its model from the
same weights, works out its own AdaIn statistics from the same
views and z draws, and follows the first ``check_steps`` steps with the z
the program cached (the program's own state: the choice among the
candidates is an argmin that one rounding can flip). The recache is held
by itself on one view drawn from the seed: the program's choice has to be
one of that view's candidates, and its loss under the reference within
``recache_gap`` of the least of the candidates' (see ``harness/judge.py``
for the rest).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from harness import device as devmod
from harness import judge
from reference import prior as ref
from reference.prior_net import from_config
from scade_tpu_torch.prior import losses as L
from scade_tpu_torch.prior import train as P
from scade_tpu_torch.prior.model import backbone_config, build_prior_model

RGB_MEANS = (0.485, 0.456, 0.406)
RGB_VARS = (0.229, 0.224, 0.225)


def step_seed(seed: int, i: int) -> int:
    return ((seed + 1) << 32) + i


def _seeds(seed: int) -> Dict[str, int]:
    s = np.random.SeedSequence(seed).generate_state(6) & 0x7FFFFFFF
    return dict(zip(("views", "weights", "adain", "recache", "loop", "sample"), map(int, s)))


def make_views(config: dict, seed: int, device) -> dict:
    """The views as the trainer's batches hold them (NCHW), made on the card:
    uniform 8-bit RGB resized bilinearly to the crop and normalized; depth in
    mm with the top 8 rows invalid, scaled to 60000 and rounded as uint16,
    its disparity likewise, both resized nearest and normalized to max 10
    with the invalid pixels at -1; no planes; the dataset's focal length and
    quality."""
    c, N, S = config, config["views"], config["image_size"]
    H, W = c["raw_H"], c["raw_W"]
    g = torch.Generator(device=device).manual_seed(seed)
    rgb8 = torch.randint(0, 256, (N, 3, H, W), generator=g, device=device)
    rgb = F.interpolate(rgb8.float() / 255.0, size=(S, S), mode="bilinear", align_corners=False)
    rgb = (rgb - torch.tensor(RGB_MEANS, device=device)[:, None, None]) / torch.tensor(
        RGB_VARS, device=device)[:, None, None]
    mm = torch.randint(500, 5500, (N, 1, H, W), generator=g, device=device).double()
    mm[:, :, :8] = 0
    depth = mm / 1000.0
    invalid = depth < 1e-8

    def u16(x):
        return torch.floor(x / x.amax((1, 2, 3), keepdim=True).clamp_min(1e-8) * 60000)

    depth = u16(depth)
    disp = torch.where(invalid, 0.0, 1.0 / (depth + 1e-8))
    disp = u16(disp)

    def crop(x):
        x = F.interpolate(x, size=(S, S), mode="nearest")
        return x / (x.amax((1, 2, 3), keepdim=True) + 1e-8) * 10.0

    bad = F.interpolate(invalid.double(), size=(S, S), mode="nearest") > 0
    out = {"rgb": rgb.contiguous()}
    for name, x in (("depth", crop(depth)), ("disp", crop(disp))):
        out[name] = torch.where(bad | (x > 1e7) | (x < 0), -1.0, x).float()
    out["planes"] = torch.zeros((N, S, S), dtype=torch.long, device=device)
    out["focal_length"] = torch.full((N,), c["focal_length"], device=device)
    out["quality_flg"] = torch.full((N,), c["quality_flg"], dtype=torch.int32, device=device)
    return out


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's state by the port's fresh-start law (lecun-normal
    convolutions and linears, zero biases; BatchNorm 1, 0 and running
    statistics 0, 1), the normals from one draw on the card."""
    with torch.device("meta"):
        model = from_config(config)
    convs = [(n, m) for n, m in model.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    z = torch.randn(sum(m.weight.numel() for _, m in convs),
                    generator=torch.Generator(device=device).manual_seed(seed), device=device)
    out, k = {}, 0
    for n, m in convs:
        w = m.weight
        out[f"{n}.weight"] = z[k:k + w.numel()].view(w.shape).mul_(1.0 / math.sqrt(w[0].numel()))
        k += w.numel()
    for name, t in model.state_dict().items():
        if name not in out:
            out[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    for n, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            out[f"{n}.weight"].fill_(1.0)
            out[f"{n}.running_var"].fill_(1.0)
    return out


def batches_of(views: dict, size: int) -> List[dict]:
    """The trainer's batches of an epoch: ``size`` views in order, the rest last."""
    n = views["rgb"].shape[0]
    return [{k: v[s:min(s + size, n)] for k, v in views.items()} for s in range(0, n, size)]


class ZStream:
    """``draw_z(n)``: the next n rows of a tensor the benchmark drew."""

    def __init__(self, z: torch.Tensor):
        self.z, self.k = z, 0

    def __call__(self, n: int) -> torch.Tensor:
        out = self.z[self.k:self.k + n]
        self.k += n
        return out


def _inputs(config: dict, seeds: Dict[str, int], device) -> dict:
    """Everything both sides are handed, made from the seed."""
    n_adain = min(config["adain_subset"], config["views"])
    sets = config["num_samples"] // config["mini_batch_size"]
    g = torch.Generator(device=device)
    return {
        "views": make_views(config, seeds["views"], device),
        "z_adain": torch.randn((n_adain, config["mini_batch_size"], config["d_latent"]),
                               generator=g.manual_seed(seeds["adain"]), device=device),
        "z_recache": torch.randn((config["views"] * sets * config["mini_batch_size"],
                                  config["d_latent"]),
                                 generator=g.manual_seed(seeds["recache"] ^ 0x5A5A5A5A),
                                 device=device),
        "sample": int(np.random.default_rng(seeds["sample"]).integers(config["views"])),
    }


@dataclasses.dataclass
class Run:
    ctx: object
    seeds: Dict[str, int]
    inputs: dict
    model: object = None
    opt: object = None
    tc: object = None
    shifts: dict = None
    batches: List[dict] = None
    zcache: torch.Tensor = None
    generator: torch.Generator = None
    i: int = 0
    failed: int = 0
    totals: list = dataclasses.field(default_factory=list)
    work: List[dict] = dataclasses.field(default_factory=list)
    record: dict = dataclasses.field(default_factory=dict)


def setup(ctx) -> Run:
    c, dev = ctx.config, ctx.device
    devmod.set_precision(c)
    seeds = _seeds(ctx.seed)
    run = Run(ctx, seeds, _inputs(c, seeds, dev))
    cfg = backbone_config(c["backbone"], d_latent=c["d_latent"])
    cfg = dataclasses.replace(cfg, layers=tuple(c["layers"]))
    with torch.device(dev):
        model = build_prior_model(cfg, c["version"], c["cimle_version"])
    w0 = make_weights(c, seeds["weights"], dev)
    model.load_state_dict(w0, strict=True)
    run.model = model
    run.tc = P.PriorTrainConfig(
        base_lr=c["base_lr"], mlp_lr=c["mlp_lr"], scale_decoder_lr=c["scale_decoder_lr"],
        weight_decay=c["weight_decay"], grad_clip=c["grad_clip"], num_samples=c["num_samples"],
        mini_batch_size=c["mini_batch_size"], refresh_z=c["refresh_z"],
        compute_dtype=None if c["compute_dtype"] == "float32" else c["compute_dtype"],
        loss_mode=c["loss_mode"])
    views = run.inputs["views"]
    n_adain = run.inputs["z_adain"].shape[0]
    run.shifts = P.compute_adain_stats(
        model, batches_of({k: v[:n_adain] for k, v in views.items()}, 1),
        ZStream(run.inputs["z_adain"].reshape(-1, c["d_latent"])), run.tc.mini_batch_size)
    run.batches = batches_of(views, c["batchsize"])
    zcache = P.recache_z(model, run.shifts, run.tc, run.batches, ZStream(run.inputs["z_recache"]),
                         torch.Generator(device=dev).manual_seed(seeds["recache"]))
    run.zcache = torch.from_numpy(zcache).to(dev)
    run.record["z_sample"] = run.zcache[run.inputs["sample"]].clone()
    run.opt = P.PriorOptimizer(model, run.tc)
    run.generator = torch.Generator(device=dev)
    names = [n for n, _ in model.named_parameters()]
    losses = []
    for k in range(ctx.traffic["setup_epochs"] * len(run.batches)):
        if k == 0:  # the first step's prediction, as the step computes it
            with _capture(run.record):
                total = step(run)
        else:
            total = step(run)
        if k < ctx.traffic["check_steps"]:
            losses.append(float(total))
        if k == 0:  # the gradient as the optimizer got it: clipped, in p.grad
            run.record["grad_norms"] = judge.norms({n: p.grad for n, p in
                                                    model.named_parameters()})
        if k + 1 == ctx.traffic["check_steps"]:
            run.record["change_norms"] = judge.norms({n: p.detach() - w0[n] for n, p in
                                                      zip(names, model.parameters())})
    run.record["losses"] = losses
    run.record["zcache"] = run.zcache.clone()
    del w0
    return run


@contextlib.contextmanager
def _capture(record: dict):
    inner = P.prior_apply

    def prior_apply(*args, **kwargs):
        out = inner(*args, **kwargs)
        record["depth"] = out.detach().float().clone()
        return out

    with mock.patch.object(P, "prior_apply", prior_apply):
        yield


def step(run: Run):
    """One SGD step of the loop on the next batch; the epoch's mean loss read
    to the host after its last batch."""
    b = run.i % len(run.batches)
    run.i += 1
    batch = run.batches[b]
    B = batch["rgb"].shape[0]
    start = b * run.ctx.config["batchsize"]
    run.generator.manual_seed(step_seed(run.seeds["loop"], run.i))
    draws = L.draw_criterion(run.generator, batch, run.tc.loss_mode)
    total, _ = P.train_step(run.model, run.opt, run.shifts, batch,
                            run.zcache[start:start + B], draws, run.tc)
    run.totals.append(total)
    run.work.append({"batch": B})
    if b == len(run.batches) - 1:
        mean = torch.stack(run.totals).mean().item()
        run.failed += not math.isfinite(mean)
        run.totals = []
    return total


def sync(run: Run) -> None:
    if run.ctx.device.type == "cuda":
        torch.cuda.synchronize(run.ctx.device)
    if run.totals:
        run.failed += not math.isfinite(torch.stack(run.totals).mean().item())
        run.totals = []


@contextlib.contextmanager
def spans():
    """A ``bench.criterion`` range around each call of the criterion as
    ``prior/train.py`` looks it up."""
    inner = L.criterion

    def criterion(*args, **kwargs):
        with torch.profiler.record_function("bench.criterion"):
            return inner(*args, **kwargs)

    with mock.patch.object(L, "criterion", criterion):
        yield


def finish(run: Run):
    record, inputs = run.record, run.inputs
    run.model = run.opt = run.shifts = run.batches = run.zcache = run.inputs = None
    return record, inputs


def judge_run(ctx, record: dict, inputs: dict) -> Dict[str, float]:
    """The reference's numbers against the record, computed in the
    precision the configuration states (cuDNN's TF32 on, cuBLAS's off):
    at initialization this model's depth output moves by 15-23% between
    TF32 and float32 convolutions of the same weights, so a float32
    reference would measure the configuration's own precision (PERF.md)."""
    c, dev = ctx.config, ctx.device
    seeds = _seeds(ctx.seed)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    devmod.set_precision(c)
    try:
        net = ref.build(c, dev)
        w0 = make_weights(c, seeds["weights"], dev)
        net.load_state_dict(w0, strict=True)
        views = inputs["views"]
        shifts = ref.adain_shifts(net, views["rgb"][:inputs["z_adain"].shape[0]],
                                  inputs["z_adain"])
        gap = recache_gap(c, seeds, net, shifts, views, inputs, record["z_sample"])
        batches = batches_of(views, c["batchsize"])
        n = ctx.traffic["check_steps"]
        order = [batches[i % len(batches)] for i in range(n)]
        starts = [(i % len(batches)) * c["batchsize"] for i in range(n)]
        zs = [record["zcache"][s:s + b["rgb"].shape[0]] for s, b in zip(starts, order)]
        gen = torch.Generator(device=dev)
        drawn = [ref.draws(gen.manual_seed(step_seed(seeds["loop"], i + 1)), b, c["loss_mode"])
                 for i, b in enumerate(order)]
        losses, first, depth = ref.train(net, shifts, c, order, zs, drawn)
        change = judge.norms({k: p.detach() - w0[k] for k, p in net.named_parameters()})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    checks = judge.training_checks(record, losses, judge.norms(first), change)
    checks["recache_gap"] = gap
    checks["depth_gap"] = float((record["depth"] - depth).double().norm()
                                / depth.double().norm().clamp_min(1e-30))
    return checks


def recache_gap(c: dict, seeds: Dict[str, int], net, shifts, views: dict, inputs: dict,
                chosen: torch.Tensor) -> float:
    """The sampled view's candidates replayed from the same draws: the
    reference's loss of the program's choice over the least of theirs, less 1
    (infinity where the choice is none of the candidates)."""
    j, mini = inputs["sample"], c["mini_batch_size"]
    sets = c["num_samples"] // mini
    gen = torch.Generator(device=views["rgb"].device).manual_seed(seeds["recache"])
    stream = ZStream(inputs["z_recache"])
    cands, totals = [], []
    for b, batch in enumerate(batches_of(views, c["batchsize"])):
        B = batch["rgb"].shape[0]
        rep = {k: v.repeat_interleave(mini, 0) for k, v in batch.items()}
        for _ in range(sets):
            z = stream(B * mini)
            drawn = ref.draws(gen, rep, c["loss_mode"])
            r = j - b * c["batchsize"]
            if not 0 <= r < B:
                continue
            rows = slice(r * mini, (r + 1) * mini)
            totals.append(ref.view_totals(net, shifts, {k: v[rows] for k, v in rep.items()},
                                          z[rows], {k: tuple(t[rows] for t in v)
                                                    for k, v in drawn.items()}, c["loss_mode"]))
            cands.append(z[rows])
    cands, totals = torch.cat(cands), torch.cat(totals).double()
    hit = [i for i in range(cands.shape[0]) if torch.equal(cands[i], chosen)]
    if not hit:
        return math.inf
    best = totals.min()
    return float((totals[hit[0]] - best) / best.abs().clamp_min(1e-30))


def control_record(ctx):
    """The control: the program with its own bfloat16 path (autocast) in
    place of the configuration's float32."""
    return finish(setup(dataclasses.replace(ctx, config=dict(ctx.config,
                                                               compute_dtype="bfloat16"))))


def _unchanged():
    def step(self, ranks=None):
        self.count += 1

    return mock.patch.object(P.PriorOptimizer, "step", step)


def _half_batch():
    inner = P.loss_fn

    def loss_fn(*args, **kwargs):
        _, loss_dict, total_raw = inner(*args, **kwargs)
        return total_raw[: max(1, total_raw.shape[0] // 2)].mean(), loss_dict, total_raw

    return mock.patch.object(P, "loss_fn", loss_fn)


def _answer():
    """The recache keeps each view's worst candidate."""
    inner, loss = P.recache_z, P.loss_fn

    def negated(*args, **kwargs):
        total, loss_dict, total_raw = loss(*args, **kwargs)
        return total, loss_dict, -total_raw

    def recache_z(*args, **kwargs):
        with mock.patch.object(P, "loss_fn", negated):
            return inner(*args, **kwargs)

    return mock.patch.object(P, "recache_z", recache_z)


# Faults planted in the program, each of which has to turn ``correct`` false.
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "answer": _answer}
