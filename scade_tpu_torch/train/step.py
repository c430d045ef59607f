"""The SCADE train step.

Per step:
  1. pick a random train image and N_rand of its pixels (on the device),
  2. gather rgb and depth-hypothesis targets, make rays at those pixels,
  3. scale the K hypotheses by the image's learned depth scale/shift,
  4. render (coarse + fine + P_depth draws),
  5. loss = img_mse + w_sc * space_carving + img_mse0,
  6. Adam on the MLPs (staircase LR decay) and Adam on scale/shift (frozen
     after ``freeze_ss`` steps; space carving gated by ``warm_start_nerf``).

Both Adams follow optax's arithmetic bit for bit as XLA compiles it on the
CPU (eps outside the sqrt, bias corrections on the incremented count, see
``adam_update``). While frozen, scale/shift take a zero update but
their moments still advance, which ``torch.optim.Adam`` cannot express, so
the updates are written on tensors. The step updates the state in place.

Under data parallelism (``parallel/dist.py``) every rank draws the whole
step's batch from the same generator and renders its contiguous block of
rays, with the draws the whole batch would give them (``RayBlock``). Each
rank's loss is scaled by 1/world and the grads and metrics summed over the
ranks in one collective, so every rank applies the same Adam step and the
step is the one-device step (scade_tpu/train/step.py:251-270).

On a grid with a model axis (``parallel/dist.py::make_grid``,
``parallel/mesh.py``) the ranks of a data row share a block of rays and
each holds its rows of the sharded layers and of their Adam moments. The
loss is scaled by 1/n_data; a sharded tensor's grad is summed over the data
group; a replicated one's (the heads, scales, shifts) is summed over every
rank and divided by n_model, which in exact arithmetic is the data group's
sum and leaves the copies on a data row's ranks bit-equal by construction:
every rank takes the same all-reduced value, whether or not the ranks'
own backwards agree to the last bit.

On one device the step with the kernels on is reproducible: the same
state, scene and generator give the same grads and parameters bit for bit,
on the card too (K2's backward kernel adds in a fixed order; chip_smoke.py's
repro phase checks the rest of the step). With ``use_fused=False`` the plain
``sample_pdf``'s gathers add their backward with atomics on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from scade_tpu_torch.models.nerf import NeRF
from scade_tpu_torch.ops.arith import f32, fma
from scade_tpu_torch.ops.losses import compute_space_carving_loss, img2mse, mse2psnr
from scade_tpu_torch.ops.rays import get_rays
from scade_tpu_torch.parallel import mesh
from scade_tpu_torch.parallel.dist import Ranks
from scade_tpu_torch.render.renderer import RayBlock, RenderConfig, SceneVars, render_rays

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # torch.optim.Adam and optax.adam defaults


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training hyperparameters (reference flag defaults)."""

    n_rand: int = 1024
    num_iterations: int = 500000
    lrate: float = 5e-4
    decay_step: int = 400000
    decay_rate: float = 0.1
    scaleshift_lr: float = 1e-7
    scale_init: float = 1.0
    shift_init: float = 0.0
    freeze_ss: int = 400000
    warm_start_nerf: int = 0
    space_carving_weight: float = 0.007
    space_carving_threshold: float = 0.0
    is_joint: bool = False
    norm_p: int = 2
    mask_corners: bool = False
    # wild-runner variants: 10 px border mask, RGB loss masked by it
    mask_edges: bool = False
    mask_rgb: bool = False
    # "stratified": one uniform pixel per contiguous ~H*W/n_rand stratum
    #     (distinct by construction, uniform marginals);
    # "choice": uniform without replacement (the reference's law);
    # "iid": with replacement.
    pixel_sampling: str = "stratified"


@dataclasses.dataclass
class SceneTensors:
    """Device-resident scene data the train step gathers from; train and
    val images first, hypotheses for the train images only."""

    images: torch.Tensor  # (N_rel, H, W, 3)
    poses: torch.Tensor  # (N_rel, 4, 4)
    intrinsics: torch.Tensor  # (N_rel, 4)
    hyps: torch.Tensor  # (N_train, K, H, W, 1)
    near: torch.Tensor  # ()
    far: torch.Tensor  # ()
    bb_center: torch.Tensor  # (3,)
    bb_scale: torch.Tensor  # ()


@dataclasses.dataclass
class AdamState:
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0

    @classmethod
    def zeros_like(cls, params):
        return cls([torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])


@dataclasses.dataclass
class TrainState:
    model_coarse: NeRF
    model_fine: NeRF  # the coarse model itself when n_importance == 0
    opt: AdamState
    scales: torch.Tensor  # (N_rel, 1) per-image depth scale
    shifts: torch.Tensor  # (N_rel, 1) per-image depth shift
    ss_opt: AdamState
    step: int = 0

    def nerf_params(self) -> List[torch.Tensor]:
        params = list(self.model_coarse.parameters())
        if self.model_fine is not self.model_coarse:
            params += list(self.model_fine.parameters())
        return params


class RayBatch(NamedTuple):
    rays_o: torch.Tensor  # (n_rand, 3)
    rays_d: torch.Tensor  # (n_rand, 3)
    target_s: torch.Tensor  # (n_rand, 3)
    target_h: torch.Tensor  # (K, n_rand, 1)
    sc_mask: Optional[torch.Tensor]  # (n_rand,) or None
    img_i: torch.Tensor  # () long


def staircase_lr(tc: TrainConfig, count: int) -> float:
    """lr * rate^floor((count + 1) / decay_step) at optimizer count ``count``:
    the reference applies its rate at iteration i = count + 1, so the decay
    fires at exactly iteration ``decay_step``."""
    return tc.lrate * tc.decay_rate ** ((count + 1) // tc.decay_step)


def adam_update(params, grads, state: AdamState, lr: float, apply: bool = True) -> None:
    """One Adam step in place, bit for bit optax's as XLA compiles the JAX
    package's jitted steps on the CPU: the bias corrections 1 - b^count in
    float32, each moment's update and the parameter's step contracted into
    one fused multiply-add, and the update as mu / (bc1 * (sqrt(nu / bc2) +
    eps)). b^count is float32(b) raised exactly and rounded: XLA's float32
    power gives the same at every count up to 500,000 but 2,958 and 3,606
    for b2, where it is one ulp off. The square root is taken in float64 and
    rounded, which is the correctly rounded float32 root (torch's CPU
    float32 root is not). The tensors are concatenated, so that a step is a
    few launches whatever their number. ``apply=False`` advances the moments
    and the count but leaves the parameters as they are."""
    state.count += 1
    if not params:
        return
    bc = [f32(1.0 - f32(np.float64(np.float32(b)) ** state.count)) for b in (_B1, _B2)]

    def flat(ts):
        return torch.cat([t.reshape(-1) for t in ts])

    def write(ts, x):
        chunks = x.split([t.numel() for t in ts])
        torch._foreach_copy_(ts, [c.view_as(t) for c, t in zip(chunks, ts)])

    with torch.no_grad():
        g = flat(torch.zeros_like(p) if g is None else g for p, g in zip(params, grads))
        mu = fma(g, f32(1.0 - _B1), flat(state.mu) * f32(_B1))
        nu = fma(g * g, f32(1.0 - _B2), flat(state.nu) * f32(_B2))
        write(state.mu, mu)
        write(state.nu, nu)
        if apply:
            # divisors as tensors on the device: CUDA divides by a host
            # scalar as a product with its reciprocal
            bc1, bc2 = (torch.full((), x, device=g.device) for x in bc)
            den = torch.sqrt((nu / bc2).double()).float().add_(f32(_EPS)).mul_(bc1)
            write(params, fma(mu / den, f32(-lr), flat(params)))


def create_train_state(
    seed: int,
    rc: RenderConfig,
    tc: TrainConfig,
    n_images: int,
    scales_init: Optional[np.ndarray] = None,
    shifts_init: Optional[np.ndarray] = None,
    grid: Optional[Ranks] = None,
) -> TrainState:
    """Models from ``seed`` (initialized on the CPU, so every device gets the
    same weights) moved to ``rc.device``, zero Adam moments, per-image
    scale/shift. ``grid`` with a model axis: the NeRF params and their
    moments keep this rank's rows (``parallel/mesh.py::shard_state``)."""
    device = torch.device(rc.device)
    gen = torch.Generator().manual_seed(seed)
    coarse = NeRF(rc.nerf_coarse, generator=gen).to(device)
    fine = NeRF(rc.nerf_fine, generator=gen).to(device) if rc.nerf_fine is not None else coarse

    def per_image(init, fill):
        if init is not None:
            t = torch.as_tensor(np.asarray(init, np.float32)).reshape(n_images, 1)
        else:
            t = torch.full((n_images, 1), fill, dtype=torch.float32)
        return t.to(device).requires_grad_(True)

    scales = per_image(scales_init, tc.scale_init)
    shifts = per_image(shifts_init, tc.shift_init)
    state = TrainState(coarse, fine, AdamState([], []), scales, shifts,
                       AdamState.zeros_like([scales, shifts]))
    state.opt = AdamState.zeros_like(state.nerf_params())
    if grid is not None and grid.n_model > 1:
        mesh.shard_state(state, grid)
    return state


def scene_tensors_from_scene(scene, bb_center, bb_scale, device) -> SceneTensors:
    """The train step's tensors from a loaded ``data.scene.Scene``, on
    ``device``, one transfer each: the train images then the val images (the
    test images when there is no val split), as the reference repacks them
    (run_scade_scannet.py:843-872), and the train images' hypotheses."""
    i_train, i_val = scene.i_train, scene.i_val
    if len(i_val) == 0:
        i_val = scene.i_test
    i_rel = np.concatenate([i_train, i_val], 0)
    device = torch.device(device)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    return SceneTensors(
        images=put(scene.images[i_rel]),
        poses=put(scene.poses[i_rel]),
        intrinsics=put(scene.intrinsics[i_rel]),
        hyps=put(scene.depth_hypothesis),
        near=torch.tensor(scene.near, dtype=torch.float32, device=device),
        far=torch.tensor(scene.far, dtype=torch.float32, device=device),
        bb_center=put(bb_center),
        bb_scale=torch.tensor(bb_scale, dtype=torch.float32, device=device),
    )


def _corner_mask(rows, cols, H: int, W: int, n_pix: int = 20):
    """Zero a 20 px square in each image corner."""
    in_r = (rows < n_pix) | (rows >= H - n_pix)
    in_c = (cols < n_pix) | (cols >= W - n_pix)
    return torch.where(in_r & in_c, 0.0, 1.0)


def _edge_mask(rows, cols, H: int, W: int, n_pix: int = 10):
    """Zero a 10 px border (wild runner)."""
    in_r = (rows < n_pix) | (rows >= H - n_pix)
    in_c = (cols < n_pix) | (cols >= W - n_pix)
    return torch.where(in_r | in_c, 0.0, 1.0)


def select_pixels(generator, H: int, W: int, tc: TrainConfig, device=None):
    """Per-step pixel ids in [0, H*W); see TrainConfig.pixel_sampling."""
    if tc.pixel_sampling == "choice":
        return torch.randperm(H * W, generator=generator, device=device)[: tc.n_rand]
    if tc.pixel_sampling == "iid":
        return torch.randint(0, H * W, (tc.n_rand,), generator=generator, device=device)
    if tc.pixel_sampling != "stratified":
        raise ValueError(f"pixel_sampling={tc.pixel_sampling!r}")
    u = torch.rand(tc.n_rand, generator=generator, device=device)
    # integer stratum boundaries: stratum i is [b[i], b[i+1]), disjoint and
    # non-empty for n_rand <= H*W, so the picks are distinct by construction
    b = np.arange(tc.n_rand + 1, dtype=np.int64) * (H * W) // tc.n_rand
    lo = torch.as_tensor(b[:-1], device=device)
    size = torch.as_tensor((b[1:] - b[:-1]).astype(np.float32), device=device)
    return lo + (u * size).long()


def sample_ray_batch(generator, scene: SceneTensors, H: int, W: int, n_train: int,
                     tc: TrainConfig) -> RayBatch:
    """On-device batch gather from one random train image."""
    dev = scene.images.device
    img_i = torch.randint(0, n_train, (), generator=generator, device=dev)
    pix = select_pixels(generator, H, W, tc, device=dev)
    rows = pix // W
    cols = pix % W
    coords = torch.stack([rows, cols], dim=-1).float()

    rays_o, rays_d = get_rays(H, W, scene.intrinsics[img_i], scene.poses[img_i], coords=coords)
    target_s = scene.images[img_i, rows, cols]  # (n_rand, 3)
    target_h = scene.hyps[img_i][:, rows, cols]  # (K, n_rand, 1)
    if tc.mask_corners:
        sc_mask = _corner_mask(rows, cols, H, W)
    elif tc.mask_edges:
        sc_mask = _edge_mask(rows, cols, H, W)
    else:
        sc_mask = None
    return RayBatch(rays_o, rays_d, target_s, target_h, sc_mask, img_i)


def batch_rows(batch: RayBatch, rows: slice) -> RayBatch:
    """The rays ``rows`` of a batch."""
    return batch._replace(
        rays_o=batch.rays_o[rows], rays_d=batch.rays_d[rows], target_s=batch.target_s[rows],
        target_h=batch.target_h[:, rows],
        sc_mask=None if batch.sc_mask is None else batch.sc_mask[rows])


def compute_loss(state: TrainState, scene: SceneTensors, batch: RayBatch, rc: RenderConfig,
                 tc: TrainConfig, generator=None, cached_u=None, ranks: Optional[Ranks] = None):
    """Total loss and the metrics dict (tensors) for one batch.

    Under ``ranks``, ``batch`` is this rank's block of the step's
    ``tc.n_rand`` rays: the returned loss is scaled by 1/n_data (grads summed
    over the data group are then the whole batch's), and the metrics are
    this rank's, to be averaged over the data group."""
    block = None if ranks is None else RayBlock(ranks.block(tc.n_rand), tc.n_rand)
    scene_vars = SceneVars(
        state.model_coarse, state.model_fine, scene.bb_center, scene.bb_scale,
        torch.zeros((rc.input_ch_cam,), device=scene.bb_center.device),
    )
    out = render_rays(scene_vars, rc, batch.rays_o, batch.rays_d, scene.near, scene.far,
                      generator=generator, cached_u=cached_u, block=block)

    def rgb_loss(pred):
        if tc.mask_rgb and batch.sc_mask is not None:
            return torch.mean((pred - batch.target_s) ** 2 * batch.sc_mask[:, None])
        return img2mse(pred, batch.target_s)

    img_loss = rgb_loss(out["rgb_map"])
    loss = img_loss
    th = batch.target_h * state.scales[batch.img_i] + state.shifts[batch.img_i]
    sc_loss = compute_space_carving_loss(
        out["pred_hyp"], th, is_joint=tc.is_joint, mask=batch.sc_mask, norm_p=tc.norm_p,
        threshold=tc.space_carving_threshold,
        mean_over_ranks=None if ranks is None else ranks.mean,
    )
    # active after warm_start_nerf iterations; logged as zero while inactive
    sc_active = tc.space_carving_weight > 0.0 and state.step + 1 > tc.warm_start_nerf
    if sc_active:
        loss = loss + tc.space_carving_weight * sc_loss
    metrics = {
        "img_loss": img_loss.detach(),
        "space_carving_loss": sc_loss.detach() if sc_active else torch.zeros_like(sc_loss),
    }
    if rc.nerf_fine is not None:
        img_loss0 = rgb_loss(out["rgb0"])
        loss = loss + img_loss0
        metrics["img_loss0"] = img_loss0.detach()
    metrics["loss"] = loss.detach()
    if ranks is not None:
        loss = loss / ranks.n_data
    return loss, metrics


def compute_grads(state: TrainState, scene: SceneTensors, batch: RayBatch, rc: RenderConfig,
                  tc: TrainConfig, generator=None, cached_u=None, ranks: Optional[Ranks] = None):
    """(grads of the NeRF params, grad of scales, grad of shifts, metrics);
    a grad is None where the loss does not reach the tensor. Under ``ranks``
    the grads are summed and the metrics averaged over the data group, so
    every rank returns the whole batch's (of a sharded tensor, its rows)."""
    loss, metrics = compute_loss(state, scene, batch, rc, tc, generator, cached_u, ranks)
    wrt = state.nerf_params() + [state.scales, state.shifts]
    grads = list(torch.autograd.grad(loss, wrt, allow_unused=True))
    if ranks is not None:
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, wrt)]
        names = list(metrics)
        values = [metrics[k].reshape(1) for k in names]
        if ranks.n_model == 1:
            ranks.sum_(grads + values)
        else:
            sharded = [dim is not None for dim in mesh.nerf_dims(state)] + [False, False]
            ranks.sum_([g for g, s in zip(grads, sharded) if s] + values)
            replicated = [g for g, s in zip(grads, sharded) if not s]
            ranks.sum_(replicated, everywhere=True)
            for g in replicated:
                g.div_(ranks.n_model)
        metrics = {k: v[0] / ranks.n_data for k, v in zip(names, values)}
    return grads[:-2], grads[-2], grads[-1], metrics


def apply_grads(state: TrainState, grads, g_scales, g_shifts, tc: TrainConfig,
                n_train: int, metrics: Dict) -> Dict:
    """Both Adam updates, in place, and the step's remaining metrics."""
    lr = staircase_lr(tc, state.opt.count)
    adam_update(state.nerf_params(), grads, state.opt, lr)
    # frozen after freeze_ss iterations: zero update, moments still advance
    frozen = state.step + 1 >= tc.freeze_ss
    adam_update([state.scales, state.shifts], [g_scales, g_shifts], state.ss_opt,
                tc.scaleshift_lr, apply=not frozen)

    metrics["psnr"] = mse2psnr(metrics["img_loss"])
    if "img_loss0" in metrics:
        metrics["psnr0"] = mse2psnr(metrics["img_loss0"])
    metrics["lr"] = staircase_lr(tc, state.step)
    metrics["depth_scale_mean"] = state.scales.detach()[:n_train].mean()
    metrics["depth_shift_mean"] = state.shifts.detach()[:n_train].mean()
    state.step += 1
    return metrics


def make_train_step(rc: RenderConfig, tc: TrainConfig, H: int, W: int, n_train: int,
                    ranks: Optional[Ranks] = None):
    """The train step: (state, scene, generator) -> metrics, with ``state``
    updated in place. ``generator`` lives on the scene's device and drives
    the batch, the jitter and the draws. ``ranks``: data-parallel over the
    process group, each rank on its block of ``tc.n_rand / world`` rays; a
    grid from ``parallel/dist.py::make_grid`` with a model axis also splits
    the sharded layers over each data row (the state from
    ``create_train_state(..., grid=...)``)."""
    rows = None if ranks is None else ranks.block(tc.n_rand)

    def step_fn(state: TrainState, scene: SceneTensors, generator: torch.Generator):
        batch = sample_ray_batch(generator, scene, H, W, n_train, tc)
        if rows is not None:
            batch = batch_rows(batch, rows)
        grads, g_scales, g_shifts, metrics = compute_grads(
            state, scene, batch, rc, tc, generator=generator, ranks=ranks
        )
        return apply_grads(state, grads, g_scales, g_shifts, tc, n_train, metrics)

    return step_fn
