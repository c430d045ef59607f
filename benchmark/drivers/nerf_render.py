"""Traffic: the test task's renders, as ``eval/evaluate.py::
render_images_with_metrics`` scores a trained scene's views.

Each step renders one whole view through that function, as the CLI's
``test`` task and the training loop's val renders call it: every ray of the
view in chunks of ``chunk`` rays, in the renderer's deterministic test mode
(evenly spaced coarse depths, K2's importance draws at evenly spaced u, no
density noise), then PSNR, SSIM and the depth RMSE against the view's
target image and depths. LPIPS has no weights here and reads NaN. Nothing is
written to disk. The steps take the scene's val views in turn.

Set-up makes the scene and both networks' weights from the seed as the
``scannet-train`` cell does (``nerf_train.make_scene``, ``make_weights``),
the val views' target depths and their valid pixels on the card, and renders
one view, which warms up every shape the window uses.

The comparison: once the window has closed, the plain reference
(``reference/nerf_render.py``) renders every ``check_rows_every``-th row of
the last view the window rendered, from a first row drawn from the seed, and
each of the four maps the program produced there (the fine and the coarse
colour, the fine and the coarse depth over far) is held against it.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from harness import device as devmod
from harness import manifest
from reference import nerf_render as ref
from scade_tpu_torch.eval import evaluate
from scade_tpu_torch.eval.lpips import LPIPSAlex
from scade_tpu_torch.models.nerf import NeRF
from scade_tpu_torch.render import renderer

HERE = os.path.dirname(os.path.abspath(__file__))
train = manifest.load_module(os.path.join(HERE, "nerf_train.py"), "bench_driver_nerf_train")

# The configuration scores without LPIPS: a weights file that never exists.
NO_LPIPS_WEIGHTS = os.path.join(HERE, "lpips-weights-absent.npz")
MAPS = ("rgb", "depth", "rgb0", "depth0")


def _own_seeds(seed: int) -> Dict[str, int]:
    """The render's own draws beside the train cell's scene and weights:
    the target depths and the first row the comparison reads."""
    s = np.random.SeedSequence([seed, 1]).generate_state(2) & 0x7FFFFFFF
    return {"targets": int(s[0]), "rows": int(s[1])}


def check_rows(ctx) -> np.ndarray:
    """Every ``check_rows_every``-th row of a view, from a first row drawn
    from the seed."""
    every = ctx.traffic["check_rows_every"]
    return np.arange(_own_seeds(ctx.seed)["rows"] % every, ctx.config["H"], every)


def views(ctx) -> dict:
    """The val views' targets, poses and intrinsics on the host, and the
    scene's bounds on the card: what the test task reads."""
    c, dev = ctx.config, ctx.device
    scene = train.make_scene(c, train._seeds(ctx.seed)["scene"], dev)
    val = slice(c["n_train"], c["n_train"] + c["n_val"])
    g = torch.Generator(device=dev).manual_seed(_own_seeds(ctx.seed)["targets"])
    shape = (c["n_val"], c["H"], c["W"])
    depths = torch.rand(shape + (1,), generator=g, device=dev).mul_(5.0).add_(0.5)
    valid = torch.rand(shape, generator=g, device=dev) < 0.9
    return {"images": scene["images"][val].cpu().numpy(), "depths": depths.cpu().numpy(),
            "valid": valid.cpu().numpy(), "poses": scene["poses"][val].cpu().numpy(),
            "intrinsics": scene["intrinsics"][val].cpu().numpy(),
            "bb_center": scene["bb_center"], "bb_scale": scene["bb_scale"],
            "near": float(scene["near"]), "far": float(scene["far"])}


@dataclasses.dataclass
class Run:
    ctx: object
    rc: object
    scene: object
    views: dict
    lpips: object
    i: int = 0
    failed: int = 0
    last: tuple = None
    work: List[dict] = dataclasses.field(default_factory=list)


def setup(ctx) -> Run:
    c, dev = ctx.config, ctx.device
    devmod.set_precision(c)
    rc = train.render_config(c, dev)
    w0 = train.make_weights(c, train._seeds(ctx.seed)["weights"], dev)
    models = []
    for net, cfg in (("coarse", rc.nerf_coarse), ("fine", rc.nerf_fine)):
        model = NeRF(cfg, device=dev)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(w0[f"{net}.{name}"])
        models.append(model)
    host = views(ctx)
    scene = renderer.SceneVars(*models, host["bb_center"], host["bb_scale"],
                               torch.zeros((0,), device=dev))
    lpips = LPIPSAlex(weights_path=NO_LPIPS_WEIGHTS).to(dev)
    run = Run(ctx, rc, scene, host, lpips)
    before = train.launches()
    step(run)
    if dev.type == "cuda":
        train.check_launches(before, 1, ctx.cell["launches_per_step"])
    return run


def step(run: Run) -> None:
    """One view of the test task, the next val view in turn."""
    c, v = run.ctx.config, run.views
    view = run.i % c["n_val"]
    run.i += 1
    mean, res = evaluate.render_images_with_metrics(
        None, [view], v["images"], v["depths"], v["valid"], v["poses"], c["H"], c["W"],
        v["intrinsics"], run.scene, run.rc, v["near"], v["far"], chunk=run.ctx.traffic["chunk"],
        lpips_fn=run.lpips, verbose=False)
    run.last = (view, res)
    run.work.append({"rays": c["H"] * c["W"], "chunk": run.ctx.traffic["chunk"]})
    scores = {k: x for k, x in mean.as_dict().items() if k != "lpips"}
    run.failed += not all(math.isfinite(x) for x in scores.values())


def sync(run: Run) -> None:
    if run.ctx.device.type == "cuda":
        torch.cuda.synchronize(run.ctx.device)


def finish(run: Run):
    """The maps of the last view at the rows the reference reads, and the
    inputs the reference needs; the program's state is let go."""
    view, res = run.last
    rows = check_rows(run.ctx)
    record = {"view": view, "rows": rows,
              "rgb": res["rgbs"][0][rows].reshape(-1, 3),
              "depth": res["depths"][0][rows].reshape(-1),
              "rgb0": res["rgbs0"][0][rows].reshape(-1, 3),
              "depth0": res["depths0"][0][rows].reshape(-1)}
    inputs = run.views
    run.scene = run.rc = run.lpips = run.last = run.views = None
    return record, inputs


def reference_maps(ctx, inputs: dict, view: int, rows: np.ndarray, linear=F.linear) -> dict:
    """The reference's maps of ``rows`` of the val view ``view``, in float32
    (``linear`` each layer), as the test task delivers them: colours clamped
    to [0, 1], depths over far."""
    c, dev = ctx.config, ctx.device
    w0 = train.make_weights(c, train._seeds(ctx.seed)["weights"], dev)
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            out = ref.render_rows(
                w0, train.setup_of(c), torch.as_tensor(rows, device=dev),
                torch.as_tensor(inputs["intrinsics"][view], device=dev),
                torch.as_tensor(inputs["poses"][view], device=dev), inputs["near"],
                inputs["far"], inputs["bb_center"], inputs["bb_scale"], linear)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prior
    far = inputs["far"]
    return {"rgb": torch.clamp(out["rgb"], 0.0, 1.0).cpu().numpy(),
            "depth": (out["depth"] / far).cpu().numpy(),
            "rgb0": torch.clamp(out["rgb0"], 0.0, 1.0).cpu().numpy(),
            "depth0": (out["depth0"] / far).cpu().numpy()}


def gaps(record: dict, reference: dict) -> Dict[str, float]:
    """For each map, the largest gap of a ray's value from the reference's
    (``<map>_max_gap``) and the root mean square of the gaps
    (``<map>_rms_gap``); infinity where the program's value is not finite."""
    checks = {}
    for key in MAPS:
        d = np.abs(np.asarray(record[key], np.float64) - np.asarray(reference[key], np.float64))
        ok = d.size > 0 and bool(np.isfinite(d).all())
        checks[f"{key}_max_gap"] = float(d.max()) if ok else math.inf
        checks[f"{key}_rms_gap"] = float(np.sqrt(np.mean(d * d))) if ok else math.inf
    return checks


def judge_run(ctx, record: dict, inputs: dict) -> Dict[str, float]:
    return gaps(record, reference_maps(ctx, inputs, record["view"], record["rows"]))


def control_record(ctx):
    """The control: the reference in the program's place for the view set-up
    renders, every layer in TF32 (the nearest precision below the
    configuration's float32)."""
    inputs, rows = views(ctx), check_rows(ctx)
    record = reference_maps(ctx, inputs, 0, rows, ref.tf32_linear)
    record.update(view=0, rows=rows)
    return record, inputs


def _chunk_lost():
    """A chunk's answers lost: the second chunk of every view carries the
    first chunk's result."""
    inner = renderer.render_ray_batch

    def render_ray_batch(scene, rc, rays_o, rays_d, near, far, chunk=32768, generator=None,
                         outputs=None):
        out = inner(scene, rc, rays_o, rays_d, near, far, chunk=chunk, generator=generator,
                    outputs=outputs)
        m = min(chunk, rays_o.shape[0] - chunk)
        for v in out.values():
            if m > 0:
                v[chunk:chunk + m] = v[:m].clone()
        return out

    return mock.patch.object(renderer, "render_ray_batch", render_ray_batch)


def _coarse_only():
    """The fine pass fed the coarse samples only: the importance draws
    left out of its union."""
    inner = renderer.merge_sorted

    def merge_sorted(a, b, va=None, vb=None):
        return a if va is None else inner(a, b, va, vb)

    return mock.patch.object(renderer, "merge_sorted", merge_sorted)


# Faults planted in the program, each of which has to turn ``correct`` false.
FAULTS = {"chunk_lost": _chunk_lost, "coarse_only": _coarse_only}
