"""Traffic: the NeRF's closed training loop, as ``train/loop.py::train_nerf``
drives the step function of ``train/step.py::make_train_step``.

Step i reseeds one generator on the card with ``loop.step_seed(seed, i)``
and calls the step function on the scene's tensors; every ``i_print`` steps
the loop reads the step's metrics to the host. Set-up makes the scene and
the weights on the card from the seed, builds the program's training state
with them, and runs the first ``setup_steps`` steps of the loop (warming up
every shape the window uses). The window continues the loop from there.

The comparison: the reference (``reference/nerf.py``) follows the first
``check_steps`` steps from the same weights, scene and step seeds (see
``harness/judge.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List
from unittest import mock

import numpy as np
import torch

from harness import device as devmod
from harness import judge
from reference import nerf as ref
from scade_tpu_torch.ops import fused_mlp, fused_sampling
from scade_tpu_torch.render.renderer import make_render_config
from scade_tpu_torch.train import step as S


def step_seed(seed: int, i: int) -> int:
    """Step i's generator seed, by ``train/loop.py``'s law: (seed + 1) in the
    high 32 bits, the step in the low 32."""
    return ((seed + 1) << 32) + i


def _seeds(seed: int) -> Dict[str, int]:
    """Independent 31-bit seeds for the scene, the weights and the loop
    (``step_seed`` shifts the loop's seed by 32 bits into a 64-bit seed)."""
    s = np.random.SeedSequence(seed).generate_state(3) & 0x7FFFFFFF
    return {"scene": int(s[0]), "weights": int(s[1]), "loop": int(s[2])}


def setup_of(config: dict) -> ref.NerfSetup:
    c = config
    return ref.NerfSetup(
        H=c["H"], W=c["W"], n_train=c["n_train"], netdepth=c["netdepth"], netwidth=c["netwidth"],
        multires=c["multires"], skips=tuple(c["skips"]), n_samples=c["N_samples"],
        n_importance=c["N_importance"], n_rand=c["N_rand"], lrate=c["lrate"],
        decay_step=c["decay_step"], decay_rate=c["decay_rate"], scaleshift_lr=c["scaleshift_lr"],
        freeze_ss=c["freeze_ss"], space_carving_weight=c["space_carving_weight"])


def _look_at(eye: np.ndarray) -> np.ndarray:
    back = eye / np.linalg.norm(eye)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(back, right), back, eye
    return c2w.astype(np.float32)


def make_scene(config: dict, seed: int, device) -> dict:
    """A ScanNet-shaped scene: train then val views on a ring around a
    room-sized box, random images, K uniform depth hypotheses a train view."""
    c = config
    n = c["n_train"] + c["n_val"]
    rng = np.random.default_rng(seed)
    angles = np.linspace(0.0, 2 * np.pi, n, endpoint=False) + rng.uniform(0, 0.1, n)
    poses = np.stack([_look_at(np.array([2.5 * np.cos(a), 0.4, 2.5 * np.sin(a)]))
                      for a in angles])
    g = torch.Generator(device=device).manual_seed(seed)
    H, W, K = c["H"], c["W"], c["num_hypothesis"]
    return {
        "images": torch.rand((n, H, W, 3), generator=g, device=device),
        "poses": torch.from_numpy(poses).to(device),
        "intrinsics": torch.tensor([[577.9, 577.9, W / 2.0, H / 2.0]], device=device).repeat(n, 1),
        "hyps": torch.rand((c["n_train"], K, H, W, 1), generator=g, device=device).mul_(5.0)
                     .add_(0.5),
        "near": torch.tensor(0.1, device=device),
        "far": torch.tensor(6.0, device=device),
        "bb_center": torch.zeros(3, device=device),
        "bb_scale": torch.tensor(1.0 / 3.0, device=device),
    }


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Both networks' weights by the published init (xavier-uniform, gain
    sqrt(2) before a ReLU, 1 on the heads; zero biases), from one draw on
    the card; scales 1 and shifts 0 for every view."""
    s = setup_of(config)
    shapes = ref.layer_shapes(s)
    total = 2 * sum(o * i for o, i in shapes.values())
    u = torch.rand(total, generator=torch.Generator(device=device).manual_seed(seed),
                   device=device)
    out, k = {}, 0
    for net in ("coarse", "fine"):
        for name, (o, i) in shapes.items():
            gain = math.sqrt(2.0) if name.startswith(("pts_", "views_")) else 1.0
            bound = gain * math.sqrt(6.0 / (i + o))
            out[f"{net}.{name}.weight"] = (u[k:k + o * i].view(o, i) * 2.0 - 1.0) * bound
            out[f"{net}.{name}.bias"] = torch.zeros(o, device=device)
            k += o * i
    n = config["n_train"] + config["n_val"]
    out["scales"] = torch.full((n, 1), float(config["scale_init"]), device=device)
    out["shifts"] = torch.full((n, 1), float(config["shift_init"]), device=device)
    return out


@dataclasses.dataclass
class Run:
    ctx: object
    seeds: Dict[str, int]
    scene: dict
    w0: Dict[str, torch.Tensor]
    state: object
    st: object
    step_fn: object
    generator: torch.Generator
    i: int = 0
    failed: int = 0
    metrics: dict = None
    work: List[dict] = dataclasses.field(default_factory=list)
    record: dict = dataclasses.field(default_factory=dict)


def _names(state) -> List[str]:
    names = [f"coarse.{n}" for n, _ in state.model_coarse.named_parameters()]
    names += [f"fine.{n}" for n, _ in state.model_fine.named_parameters()]
    return names + ["scales", "shifts"]


def _params(state) -> List[torch.Tensor]:
    return state.nerf_params() + [state.scales, state.shifts]


def launches() -> Dict[str, int]:
    """The kernels' launch counters: K1, K2, K2's backward, K1's backward."""
    return {"k1": fused_mlp.fused_mlp_cuda.launches, "k2": fused_sampling.sample_pdf_cuda.launches,
            "k2_bwd": fused_sampling.sample_pdf_backward_cuda.launches,
            "k1_bwd": fused_mlp.fused_mlp_backward_cuda.launches}


def check_launches(before: Dict[str, int], steps: int, expected: Dict[str, int]) -> None:
    """Exits unless each counter of ``expected`` rose by its count a step."""
    after = launches()
    per_step = {k: (after[k] - before[k]) / steps for k in expected}
    print("launches per step", per_step, flush=True)
    if per_step != expected:
        raise SystemExit(f"kernel launches per step {per_step} differ from {expected}")


def render_config(c: dict, device):
    """The program's render configuration as the configuration states it."""
    return make_render_config(
        multires=c["multires"], multires_views=c["multires_views"], netdepth=c["netdepth"],
        netwidth=c["netwidth"], netdepth_fine=c["netdepth_fine"], netwidth_fine=c["netwidth_fine"],
        n_samples=c["N_samples"], n_importance=c["N_importance"], perturb=c["perturb"] > 0,
        raw_noise_std=c["raw_noise_std"], use_viewdirs=c["use_viewdirs"],
        compute_dtype=torch.float32 if c["compute_dtype"] == "float32" else torch.bfloat16,
        use_fused=c["use_fused"], fused_sampling=c["use_fused"], device=device.type)


def setup(ctx) -> Run:
    c, dev = ctx.config, ctx.device
    devmod.set_precision(c)
    seeds = _seeds(ctx.seed)
    rc = render_config(c, dev)
    tc = S.TrainConfig(
        n_rand=c["N_rand"], lrate=c["lrate"], decay_step=c["decay_step"],
        decay_rate=c["decay_rate"], scaleshift_lr=c["scaleshift_lr"], scale_init=c["scale_init"],
        shift_init=c["shift_init"], freeze_ss=c["freeze_ss"], warm_start_nerf=c["warm_start_nerf"],
        space_carving_weight=c["space_carving_weight"], is_joint=c["is_joint"],
        norm_p=c["norm_p"], pixel_sampling=c["pixel_sampling"])
    scene = make_scene(c, seeds["scene"], dev)
    w0 = make_weights(c, seeds["weights"], dev)
    n_rel = c["n_train"] + c["n_val"]
    state = S.create_train_state(0, rc, tc, n_images=n_rel)
    with torch.no_grad():
        for name, p in zip(_names(state), _params(state)):
            p.copy_(w0[name])
    st = S.SceneTensors(**scene)
    run = Run(ctx, seeds, scene, w0, state, st,
              S.make_train_step(rc, tc, c["H"], c["W"], c["n_train"]),
              torch.Generator(device=dev))

    before = launches()
    losses, coarse = [], []
    for k in range(ctx.traffic["setup_steps"]):
        step(run)
        losses.append(float(run.metrics["loss"]))
        coarse.append(float(run.metrics["img_loss0"]))
        if k == 0:  # the first gradient, from Adam's first moment: mu = (1 - b1) g
            b1 = np.float32(1.0 - ref.B1)
            mus = run.state.opt.mu + run.state.ss_opt.mu
            run.record["grad_norms"] = {n: float(m.double().norm()) / float(b1)
                                        for n, m in zip(_names(state), mus)}
        if k + 1 == ctx.traffic["check_steps"]:
            run.record["change_norms"] = judge.norms(
                {n: p.detach() - w0[n] for n, p in zip(_names(state), _params(state))})
    run.record["losses"], run.record["coarse_losses"] = losses, coarse
    if dev.type == "cuda":
        check_launches(before, ctx.traffic["setup_steps"], ctx.cell["launches_per_step"])
    return run


def step(run: Run) -> None:
    """One iteration of the loop: reseed, step, and the metrics read every i_print."""
    run.i += 1
    run.generator.manual_seed(step_seed(run.seeds["loop"], run.i))
    run.metrics = run.step_fn(run.state, run.st, run.generator)
    run.work.append({})
    if run.i % run.ctx.config["i_print"] == 0:
        values = [float(v) for v in run.metrics.values()]
        run.failed += not all(math.isfinite(v) for v in values)


def sync(run: Run) -> None:
    if run.ctx.device.type == "cuda":
        torch.cuda.synchronize(run.ctx.device)
    run.failed += not math.isfinite(float(run.metrics["loss"]))


def finish(run: Run):
    """The check record and the inputs the reference needs; the program's
    state is let go."""
    record, scene = run.record, run.scene
    run.state = run.st = run.step_fn = run.metrics = run.scene = run.w0 = None
    return record, scene


def reference_record(ctx, scene: dict, tf32: bool = False) -> dict:
    """The reference's record of the first ``check_steps`` steps; with
    ``tf32`` its products in TF32 (the control)."""
    seeds = _seeds(ctx.seed)
    w0 = make_weights(ctx.config, seeds["weights"], ctx.device)
    params = {k: v.clone() for k, v in w0.items()}
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        losses, coarse, first = ref.train(params, scene, setup_of(ctx.config),
                                  [step_seed(seeds["loop"], i)
                                   for i in range(1, ctx.traffic["check_steps"] + 1)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prior
    return {"losses": losses, "coarse_losses": coarse, "grad_norms": judge.norms(first),
            "change_norms": judge.norms({k: params[k] - w0[k] for k in params})}


def judge_run(ctx, record: dict, scene: dict) -> Dict[str, float]:
    """The training numbers (``harness/judge.py``), and two that no
    discrete decision of the step touches: the first step's coarse RGB loss
    (the coarse pass precedes every inverse-CDF draw) and the first gradient
    of the coarse network's leaves (its only loss is that one; the fine
    depths it places are detached)."""
    ref_rec = reference_record(ctx, scene)  # as configured: TF32 off
    checks = judge.training_checks(record, ref_rec["losses"], ref_rec["grad_norms"],
                                   ref_rec["change_norms"])
    p, r = record["coarse_losses"][0], ref_rec["coarse_losses"][0]
    checks["coarse_loss_gap"] = abs(p - r) / max(abs(r), 1e-30)
    coarse = {n: v for n, v in ref_rec["grad_norms"].items() if n.startswith("coarse.")}
    checks["coarse_grad_gap"] = judge.norm_gap(record["grad_norms"], coarse)
    return checks


def control_record(ctx):
    """The control: the reference in the program's place, its products in
    TF32 (the nearest precision below the configuration's float32)."""
    scene = make_scene(ctx.config, _seeds(ctx.seed)["scene"], ctx.device)
    return reference_record(ctx, scene, tf32=True), scene


def _unchanged():
    def adam_update(params, grads, state, lr, apply=True):
        state.count += 1

    return mock.patch.object(S, "adam_update", adam_update)


def _half_batch():
    inner = S.sample_ray_batch

    def sample_ray_batch(generator, scene, H, W, n_train, tc):
        batch = inner(generator, scene, H, W, n_train, tc)
        return S.batch_rows(batch, slice(0, tc.n_rand // 2))

    return mock.patch.object(S, "sample_ray_batch", sample_ray_batch)


# Faults planted in the program, each of which has to turn ``correct`` false.
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch}
