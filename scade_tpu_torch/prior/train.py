"""cIMLE prior training: AdaIn statistics, z-recaching and grouped-SGD epochs.

The counterpart of ``scade_tpu/prior/train.py`` and ``tools/train_prior.py``
(reference: ambiguity_aware_prior/tools/train_single.py, the working
variant):

- epoch 0, **AdaIn init**: over ``--adain_subset`` images, draw
  ``mini_batch_size`` z each, record the spatial mean of the 4 AdaIn-tap
  activations, then take the channel-wise mean and variance over the images
  → ``mean_var_adain.npy``; those shifts recenter every later AdaIn
  (:286-392);
- every ``refresh_z`` epochs, **z-recache**: per image, ``num_samples`` z
  in sets of ``mini_batch_size``, forward and criterion, keep the z of the
  least total loss (:394-491);
- each epoch: SGD (momentum 0.9, weight decay 5e-4) over (image, cached z)
  with per-group learning rates (encoder ``base_lr``, decoder
  ``base_lr·scale_decoder_lr``, AdaIn style MLPs ``mlp_lr``) after a global
  grad-norm clip at 10 (multi_depth_model_auxiv2.py:385-450); a
  reference-format ``epoch{N}_step0.pth`` every 8th and the last epoch.

The images come from one scene (``--dataset scene``) or, for pretraining,
from taskonomy-style annotation corpora (``--dataset multi --dataroot
<root> --dataset_list taskonomy diml_ganet ...``, ``prior/multi_data.py``):
the sampler interleaves the sources round-robin, and its order is frozen
from one recache to the next, because the cached z are positional, and
drawn anew at each recache (tools/train_prior.py:160-212). Across several
hosts the sampler shards by host, as the JAX tool's one process a host
does, and a step's batch is each host's share of its shard, in host order.

``--data_parallel`` splits each step's batch over ``torch.distributed``
ranks started as the NeRF CLI's ``--multihost`` ranks are (torchrun, or
``SCADE_COORDINATOR``; NCCL, or gloo where a host has more ranks than cards
or on the CPU); without them it runs as one rank. Each step is the global
step of the JAX package's ``make_train_step_dp``: every rank collates the
whole batch and makes all of its draws from the shared generator, keeps its
contiguous block of images, z and draws, takes the step's two batch-wide
sums over the global batch (``dist.global_batch``: the BatchNorm statistics
and the plane loss's count of groups), scales its loss by 1/B of the global
batch and sums the grads over the ranks before the clip, so every rank
takes the same SGD step. The AdaIn init and the recache split their images
over the ranks and gather the results (exact: the others' rows are zeros),
so every rank holds the same shifts and z; split, they cost a rank 1/world
of the whole, where the recache alone is worth about as many steps as a
scene has images. Only rank 0 writes files.

Run it as

    python -m scade_tpu_torch.prior.train --scene_dir <scene> --log_dir logs/prior \\
        --epochs 60 [--d_latent 32] [--batchsize 4] [--device cuda]
    torchrun --nproc_per_node 4 -m scade_tpu_torch.prior.train --data_parallel \\
        --dataset multi --dataroot <corpora> --dataset_list taskonomy diml_ganet ...

It takes ``tools/train_prior.py``'s flags and runs on the card unless
``--device cpu`` is given. Randomness comes from one ``torch.Generator`` on
the device, seeded with ``--seed_num``: the z draws and the criterion's
sampled pixels; fresh weights from a CPU generator with the same seed; the
multi-corpus sampler's order from numpy's ``default_rng(seed_num)``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from scade_tpu_torch.parallel import dist
from scade_tpu_torch.prior import losses as L
from scade_tpu_torch.prior.data import FinetuneDataset, collate
from scade_tpu_torch.prior.dump import matmul_precision
from scade_tpu_torch.prior.model import (
    get_adain_init_act,
    prior_apply,
    zero_shifts_for,
)
from scade_tpu_torch.utils.profiling import span

COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PriorTrainConfig:
    base_lr: float = 1e-3  # cfg.TRAIN.BASE_LR (config.py:79)
    mlp_lr: float = 1e-3  # --mlp_lr
    scale_decoder_lr: float = 1.0  # cfg.TRAIN.SCALE_DECODER_LR (config.py:78)
    weight_decay: float = 5e-4
    grad_clip: float = 10.0
    num_samples: int = 20  # z draws per image in a recache
    mini_batch_size: int = 5
    refresh_z: int = 10
    # WarmupMultiStepLR (--use_scheduler; off for SCADE's per-scene runs)
    use_scheduler: bool = False
    lr_milestones: tuple = (30000, 40000)
    lr_gamma: float = 0.1
    warmup_factor: float = 1.0 / 3.0
    warmup_iters: int = 500
    # "bfloat16": the model's forward and backward under torch.autocast
    # (convolutions and products in bf16, parameters, optimizer state and the
    # BatchNorm statistics in f32); None or "float32": all f32. The
    # criterion runs in f32 either way.
    compute_dtype: Optional[str] = None
    loss_mode: str = L.DEFAULT_LOSS_MODE  # train_single.py:38


def warmup_multistep_lr(base_lr: float, milestones, gamma: float = 0.1,
                        warmup_factor: float = 1.0 / 3.0, warmup_iters: int = 500,
                        warmup_method: str = "linear") -> Callable[[int], float]:
    """WarmupMultiStepLR (lib/utils/lr_scheduler_custom.py:14-55) as a
    function of the update count, which is 0 at the first update (optax's
    law): warmup to ``base_lr``, then ×gamma at each milestone passed. In
    f32, as the JAX package's schedule."""
    ms = np.asarray(sorted(milestones), np.float32)
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(count)
        if warmup_method == "constant":
            wf = f32(warmup_factor) if c < warmup_iters else f32(1.0)
        else:
            alpha = c / f32(max(warmup_iters, 1))
            wf = f32(warmup_factor) * (f32(1.0) - alpha) + alpha if c < warmup_iters else f32(1.0)
        n_passed = f32((ms <= c).sum())
        return float(f32(base_lr) * wf * f32(gamma) ** n_passed)

    return schedule


def param_label(name: str) -> str:
    """The optimizer group of a parameter: the AdaIn style MLPs
    (``*style_mod*``), the rest of the encoder, or the decoder."""
    if "style_mod" in name:
        return "style"
    return "encoder" if name.startswith("encoder_modules.") else "decoder"


class PriorOptimizer:
    """ModelOptimizer_AdaIn (multi_depth_model_auxiv2.py:385-450) as the JAX
    package's optax chain computes it: the grads of **all** parameters
    clipped together to global norm ``grad_clip`` with optax's formula
    (``g`` below the norm, else ``(g / ‖g‖)·c``), then ``torch.optim.SGD``
    (weight decay added to the grad before momentum 0.9) with one group per
    label and its learning rate, scheduled by the update count where
    ``use_scheduler``. ``fixed_backbone`` (the reference's PRETRAIN_MLP
    optimizer) leaves the encoder and decoder groups out: no update, no
    decay, no momentum."""

    def __init__(self, model: nn.Module, tc: PriorTrainConfig, fixed_backbone: bool = False):
        self.tc = tc
        self.params = [p for p in model.parameters()]
        groups: Dict[str, list] = {"encoder": [], "decoder": [], "style": []}
        for name, p in model.named_parameters():
            groups[param_label(name)].append(p)
        lrs = {"encoder": tc.base_lr, "decoder": tc.base_lr * tc.scale_decoder_lr,
               "style": tc.mlp_lr}
        trained = ["style"] if fixed_backbone else ["encoder", "decoder", "style"]
        self.schedules = []
        param_groups = []
        for g in trained:
            if groups[g]:
                param_groups.append({"params": groups[g], "lr": lrs[g], "label": g})
                self.schedules.append(warmup_multistep_lr(
                    lrs[g], tc.lr_milestones, tc.lr_gamma, tc.warmup_factor,
                    tc.warmup_iters) if tc.use_scheduler else None)
        self.sgd = torch.optim.SGD(param_groups, lr=tc.base_lr, momentum=0.9,
                                   weight_decay=tc.weight_decay)
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self, ranks: Optional[dist.Ranks] = None) -> None:
        """Clip and SGD; with ``ranks`` the grads are first summed over them
        (one all-reduce), so the clip's norm is the global one."""
        for p in self.params:  # an unused parameter's grad is 0, as in JAX
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if ranks is not None:
            ranks.sum_(grads)
        clip_by_global_norm_(grads, self.tc.grad_clip)
        for group, schedule in zip(self.sgd.param_groups, self.schedules):
            if schedule is not None:
                group["lr"] = schedule(self.count)
        self.sgd.step()
        self.count += 1


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place, without a read to the host:
    ``g`` where the global norm is below ``max_norm``, else ``(g / norm)·max_norm``.
    Returns the norm. The squares are summed in f64, then the norm rounded to
    the grads' dtype (f32 at least): torch's f32 norm of a 4e7-element tensor
    on the CPU is 2e-3 off, XLA's 2e-7."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        grads, 2, dtype=torch.float64))).to(torch.promote_types(grads[0].dtype, torch.float32))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


def batch_to_torch(batch: dict, device) -> dict:
    """A collated numpy batch (HWC, ``data.collate``) → NCHW tensors on
    ``device``: rgb (B, 3, H, W), depth and disp (B, 1, H, W), planes
    (B, H, W) int64, focal_length (B,), quality_flg (B,)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if t.ndim == 4:
            t = t.permute(0, 3, 1, 2)
        elif k == "planes":
            t = t.long()
        out[k] = t.contiguous().to(device)
    return out


def repeat_batch(batch: dict, n: int) -> dict:
    """Each image ``n`` times in a row: image b at rows b·n … b·n + n − 1."""
    return {k: v.repeat_interleave(n, 0) for k, v in batch.items()}


def rows_of(batch: dict, rows: slice) -> dict:
    """The images ``rows`` of a batch."""
    return {k: v[rows] for k, v in batch.items()}


def draws_of(draws: dict, rows: slice) -> dict:
    """The draws of the images ``rows`` (every draw is per image)."""
    return {k: tuple(t[rows] for t in v) for k, v in draws.items()}


def own_rows(ranks: Optional[dist.Ranks], n: int) -> slice:
    """The rows of an ``n``-image batch this rank evaluates in the AdaIn
    init's and the recache's split: its contiguous block where ``n``
    divides over the ranks, else all of them on rank 0 and none elsewhere."""
    if ranks is None:
        return slice(0, n)
    if n % ranks.world == 0:
        return ranks.block(n)
    return slice(0, n) if ranks.primary else slice(0, 0)


def collate_multi(items: List[dict]) -> dict:
    """Examples of ``multi_data.MultiDataset`` → the batch the criterion
    reads (tools/train_prior.py:185-197): rgb, depth, disp and planes
    stacked (planes int32), focal_length float32, quality_flg int32."""
    out = {k: np.stack([it[k] for it in items]) for k in ("rgb", "depth", "disp", "planes")}
    out["planes"] = out["planes"].astype(np.int32)
    out["focal_length"] = np.array([it["focal_length"] for it in items], np.float32)
    out["quality_flg"] = np.array([int(it["quality_flg"]) for it in items], np.int32)
    return out


def z_from(gen: torch.Generator, d_latent: int) -> Callable[[int], torch.Tensor]:
    """(n,) → an (n, d_latent) standard normal draw from ``gen``."""
    return lambda n: torch.randn((n, d_latent), generator=gen, device=gen.device)


def loss_fn(model: nn.Module, shifts, batch: dict, z: torch.Tensor, draws: dict,
            tc: PriorTrainConfig, train: bool, step: Optional[int] = None):
    """The forward (train or eval mode, under autocast for a bf16
    ``compute_dtype``) and the criterion in f32 on ``draws`` →
    (mean total, loss dict, per-image totals). ``step`` labels the spans."""
    dtype = COMPUTE_DTYPES[tc.compute_dtype]
    cast = (torch.autocast(batch["rgb"].device.type, dtype=dtype) if dtype is not None
            else contextlib.nullcontext())
    with span("scade.prior.forward", step):
        with cast:
            depth = prior_apply(model, shifts, batch["rgb"], z, train=train)
        depth = depth.to(torch.promote_types(depth.dtype, torch.float32))  # f32 at least
    with span("scade.prior.criterion", step):
        loss_dict, total_raw = L.criterion(depth, batch, tc.loss_mode, draws)
        return total_raw.mean(), loss_dict, total_raw


def train_step(model: nn.Module, opt: PriorOptimizer, shifts, batch: dict, z: torch.Tensor,
               draws: dict, tc: PriorTrainConfig, ranks: Optional[dist.Ranks] = None):
    """One SGD step in train mode (BatchNorm on the batch's statistics, its
    running statistics moved) → (mean total loss, loss dict), detached, on
    the device. With ``ranks``, ``batch``, ``z`` and ``draws`` are this
    rank's block of a global batch ``ranks.world`` times as large, and the
    step is the global one: BatchNorm over the global batch, the loss the
    sum of the rank's per-image totals over the global B, grads summed over
    the ranks; the returned losses are the global batch's on every rank."""
    model.train()
    opt.zero_grad()
    step = opt.count
    with span("scade.prior.step", step):
        if ranks is None:
            total, loss_dict, _ = loss_fn(model, shifts, batch, z, draws, tc, True, step)
            with span("scade.prior.backward", step):
                total.backward()
            with span("scade.prior.optimizer", step):
                opt.step()
            return total.detach(), {k: v.detach() for k, v in loss_dict.items()}
        with dist.global_batch(ranks):
            _, loss_dict, total_raw = loss_fn(model, shifts, batch, z, draws, tc, True, step)
        n = total_raw.shape[0] * ranks.world
        with span("scade.prior.backward", step):
            (total_raw.sum() / n).backward()
        with span("scade.prior.optimizer", step):
            opt.step(ranks)
            keys = list(loss_dict)
            sums = torch.stack([loss_dict[k].detach() for k in keys] + [total_raw.detach().sum()])
            ranks.sum_([sums])
        return sums[-1] / n, dict(zip(keys, sums[:-1]))


def compute_adain_stats(model: nn.Module, batches: Iterable[dict], draw_z, mini_batch_size: int = 5,
                        out_path: Optional[str] = None, ranks: Optional[dist.Ranks] = None
                        ) -> Dict[str, torch.Tensor]:
    """AdaIn init (train_single.py:286-392): per image (``batches`` yield
    NCHW batches whose first image is used), ``mini_batch_size`` z from
    ``draw_z(n)``, the 4 tap activations in eval mode with zero shifts, their
    spatial mean and then the mean over the z; over the images the mean and
    the variance (ddof 1; ddof 0 for one image). Written to ``out_path`` as
    the reference's ``mean_var_adain.npy`` where given. With ``ranks``,
    image i is evaluated on rank i mod world (every rank still draws every
    image's z) and the per-image means are gathered, so every rank returns
    the same shifts. Returns the shifts on the model's device."""
    device = next(model.parameters()).device
    model.eval()
    zero = {k: v.to(device) for k, v in zero_shifts_for(model).items()}
    per_image: List[List[Optional[torch.Tensor]]] = [[], [], [], []]
    with torch.no_grad():
        for i, batch in enumerate(batches):
            z = draw_z(mini_batch_size)
            if ranks is not None and i % ranks.world != ranks.rank:
                for j in range(4):
                    per_image[j].append(None)
                continue
            rgb = batch["rgb"][:1].expand(mini_batch_size, -1, -1, -1)
            acts = get_adain_init_act(model, zero, rgb, z)
            for j, a in enumerate(acts):
                per_image[j].append(a.float().mean((2, 3)).mean(0))
    shifts = {}
    for j in range(4):
        dim = zero[f"mean{j}"].shape[0]
        rows = torch.stack([torch.zeros(dim, device=device) if a is None else a
                            for a in per_image[j]])
        if ranks is not None:  # the others' rows are zeros here: the sum is exact
            ranks.sum_([rows])
        stack = rows.cpu().numpy()
        shifts[f"mean{j}"] = stack.mean(0).astype(np.float32)
        shifts[f"var{j}"] = stack.var(0, ddof=1 if stack.shape[0] > 1 else 0).astype(np.float32)
    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.save(out_path, shifts)
    return {k: torch.from_numpy(v).to(device) for k, v in shifts.items()}


def recache_z(model: nn.Module, shifts, tc: PriorTrainConfig, batches: Iterable[dict], draw_z,
              gen: torch.Generator, ranks: Optional[dist.Ranks] = None) -> np.ndarray:
    """Per image the z of least total loss among ``num_samples //
    mini_batch_size`` sets (the floor, as the reference) of
    ``mini_batch_size`` draws (train_single.py:394-491): each set draws z as
    (B·mini, d) for the batch repeated image by image (row b·mini + j), in
    eval mode; the first of equal losses wins. With ``ranks`` every rank
    makes every draw, evaluates the images ``own_rows`` gives it, and the
    chosen z are gathered, so every rank returns the same. Returns
    (n_images, d) on the host."""
    model.eval()
    mini = tc.mini_batch_size
    selected = []
    with torch.no_grad():
        for batch in batches:
            B = batch["rgb"].shape[0]
            rep = repeat_batch(batch, mini)
            mine = own_rows(ranks, B)
            nb = mine.stop - mine.start
            rep_rows = slice(mine.start * mini, mine.stop * mini)
            losses, zs = [], []
            for _ in range(tc.num_samples // mini):
                z = draw_z(B * mini)
                draws = L.draw_criterion(gen, rep, tc.loss_mode)
                if nb == 0:
                    continue
                with dist.global_batch(ranks if nb < B else None):  # the plane loss's count
                    _, _, total_raw = loss_fn(model, shifts, rows_of(rep, rep_rows),
                                              z[rep_rows], draws_of(draws, rep_rows), tc,
                                              train=False)
                losses.append(total_raw.reshape(nb, mini))
                zs.append(z[rep_rows].reshape(nb, mini, -1))
            chosen = z.new_zeros((B, z.shape[1]))
            if nb:
                losses = torch.cat(losses, 1)
                zs = torch.cat(zs, 1)
                first_min = losses.cpu().numpy().argmin(axis=1)
                chosen[mine] = zs[torch.arange(nb), torch.from_numpy(first_min).to(zs.device)]
            selected.append(chosen)
    out = torch.cat(selected, 0)
    if ranks is not None:  # the others' rows are zeros here: the sum is exact
        ranks.sum_([out])
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def rainbow(x: np.ndarray) -> np.ndarray:
    """matplotlib's "rainbow" colormap of values in [0, 1] → (..., 3) RGB in
    [0, 1]: its 256-entry table of (|2t − 0.5|, sin πt, cos πt/2), clipped."""
    n = 256
    t = np.linspace(0.0, 1.0, n)
    lut = np.clip(np.stack([np.abs(2 * t - 0.5), np.sin(t * np.pi), np.cos(t * np.pi / 2)], -1),
                  0.0, 1.0)
    xa = np.array(x, copy=True) * n
    xa[xa == n] = n - 1
    return lut[np.clip(xa, 0, n - 1).astype(int)]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Train the cIMLE depth prior on a scene.")
    ap.add_argument("--version", default="v2", choices=["v2", "v3", "v4", "v5", "v6"],
                    help="AdaIn flavor: the encoder side takes v2|v3, the decoder side "
                         "(--cimle_version dec) v2..v6")
    ap.add_argument("--cimle_version", default="enc", choices=["enc", "dec"],
                    help="where z enters: the encoder (the shipped path) or the decoder")
    ap.add_argument("--backbone", default="resnext101_32x8d")
    ap.add_argument("--loss_mode", default=None,
                    help="criterion substrings (train_single.py:38); default the 5-loss mode")
    ap.add_argument("--use_scheduler", action="store_true", help="WarmupMultiStepLR")
    ap.add_argument("--lr_scheduler_multiepochs", type=int, nargs="+", default=None,
                    help="the scheduler's milestones, in steps")
    ap.add_argument("--scale_decoder_lr", type=float, default=1.0)
    ap.add_argument("--only_output_adain_init", action="store_true",
                    help="write mean_var_adain.npy, then exit")
    ap.add_argument("--check_init", action="store_true",
                    help="after the AdaIn init, write the first image and a rainbow depth map "
                         "per z draw to log_dir, then exit")
    ap.add_argument("--debug_mode", action="store_true",
                    help="no z-recache: train with zero z")
    ap.add_argument("--dataset", default="scene", choices=["scene", "multi"])
    ap.add_argument("--dataroot", default=None)
    ap.add_argument("--dataset_list", nargs="+", default=["taskonomy"])
    ap.add_argument("--phase_anno", default="train")
    ap.add_argument("--sample_ratio", type=float, default=1.0)
    ap.add_argument("--scene_dir", default=None,
                    help="scene root holding train/ and transforms_train.json")
    ap.add_argument("--log_dir", default="logs/prior")
    ap.add_argument("--dataset_name", default="scannet")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batchsize", type=int, default=4)
    ap.add_argument("--d_latent", type=int, default=32)
    ap.add_argument("--base_lr", type=float, default=1e-3)
    ap.add_argument("--mlp_lr", type=float, default=1e-3)
    ap.add_argument("--refresh_z", type=int, default=10)
    ap.add_argument("--num_samples", type=int, default=20)
    ap.add_argument("--mini_batch_size", type=int, default=5)
    ap.add_argument("--adain_subset", type=int, default=100)
    ap.add_argument("--pretrain_mlp_epochs", type=int, default=0,
                    help="train only the AdaIn style MLPs for the first N epochs")
    ap.add_argument("--seed_num", type=int, default=0)
    ap.add_argument("--loss_jsonl", default=None,
                    help="append each SGD step's losses as one JSON line")
    ap.add_argument("--small_model", action="store_true", help="layers (1, 1, 1, 1)")
    ap.add_argument("--ckpt", default=None,
                    help="start from a reference-format .pth/.tar (a flax msgpack goes "
                         "through tools/export_prior_to_torch.py first)")
    ap.add_argument("--data_parallel", action="store_true")
    ap.add_argument("--image_size", type=int, default=448)
    ap.add_argument("--precision", default="ambient",
                    choices=["highest", "high", "bfloat16", "tensorfloat32", "ambient"],
                    help="TF32 for f32 convolutions and products (cuDNN's and cuBLAS's "
                         "allow_tf32, the flag set_float32_matmul_precision sets): 'highest' "
                         "turns it off, 'ambient' keeps torch's settings (cuDNN's on, "
                         "cuBLAS's off), any other value turns it on")
    ap.add_argument("--compute_dtype", default=None, choices=["bfloat16", "float32"],
                    help="bfloat16: forward and backward under torch.autocast, parameters "
                         "and optimizer state in f32")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def config_from_args(args) -> PriorTrainConfig:
    kw = dict(base_lr=args.base_lr, mlp_lr=args.mlp_lr, num_samples=args.num_samples,
              mini_batch_size=args.mini_batch_size, refresh_z=args.refresh_z,
              use_scheduler=args.use_scheduler, scale_decoder_lr=args.scale_decoder_lr,
              compute_dtype=args.compute_dtype)
    if args.loss_mode:
        kw["loss_mode"] = args.loss_mode
    if args.lr_scheduler_multiepochs:
        kw["lr_milestones"] = tuple(args.lr_scheduler_multiepochs)
    return PriorTrainConfig(**kw)


def build_model(args, device) -> nn.Module:
    """The model of ``--cimle_version``/``--version``/``--backbone``: from
    ``--ckpt`` (loaded strictly) or fresh seeded weights."""
    from scade_tpu_torch.prior.convert import load_prior_checkpoint
    from scade_tpu_torch.prior.model import backbone_config, build_prior_model, init_weights_

    cfg = backbone_config(args.backbone, d_latent=args.d_latent)
    if args.small_model:
        cfg = cfg.with_small()
    model = build_prior_model(cfg, args.version, args.cimle_version)
    if args.ckpt:
        if not args.ckpt.endswith((".pth", ".tar")):
            sys.exit(f"{args.ckpt}: the port reads .pth/.tar checkpoints; convert a flax "
                     "msgpack with tools/export_prior_to_torch.py first")
        model.load_state_dict(load_prior_checkpoint(args.ckpt), strict=True)
        print(f"restored {args.ckpt}")
    else:
        init_weights_(model, torch.Generator().manual_seed(args.seed_num), random_stats=False)
    return model.to(device)


def save_checkpoint(model: nn.Module, path: str, epoch: int) -> None:
    """A reference-format checkpoint (net_tools.py save_ckpt :73-90):
    ``model_state_dict`` in the reference's names, on the host."""
    torch.save({"epoch": epoch, "model_state_dict": {k: v.detach().cpu() for k, v in
                                                     model.state_dict().items()}}, path)


def check_init(model, shifts, first: dict, draw_z, mini: int, log_dir: str) -> None:
    """train_single.py's CHECK_INIT block (:417-468): the first image,
    min-max scaled, and a rainbow depth map for each of ``mini`` z."""
    import cv2

    from scade_tpu_torch.prior.model import prior_inference

    rgb0 = first["rgb"][0].permute(1, 2, 0).cpu().numpy()
    rgb_img = 255 * (rgb0 - rgb0.min()) / (rgb0.max() - rgb0.min() + 1e-12)
    cv2.imwrite(os.path.join(log_dir, "image0-raw.png"), rgb_img.astype(np.uint8))
    model.eval()
    with torch.no_grad():
        pred = prior_inference(model, shifts, first["rgb"][:1].expand(mini, -1, -1, -1),
                               draw_z(mini)).cpu().numpy()
    for s in range(mini):
        d = pred[s].squeeze()
        d = (d - d.min()) / (d.max() - d.min() + 1e-12)
        img = (rainbow(d)[..., ::-1] * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(log_dir, f"image0_0_{s}-depth.png"), img)


def main(argv=None) -> dict:
    """The trainer. Returns the model, its AdaIn shifts, the cached z, the
    checkpoints written, the epochs' mean losses and, for ``--dataset
    multi``, the last epoch's visit order (global indices, and the source
    of each)."""
    args = parse_args(argv)
    if args.dataset == "multi" and not args.dataroot:
        sys.exit("--dataset multi requires --dataroot")
    if args.dataset == "scene" and not args.scene_dir:
        sys.exit("--dataset scene requires --scene_dir")
    from scade_tpu_torch.train.loop import check_device

    device = check_device(args.device)
    ranks = None
    if args.data_parallel and dist.launched():
        ranks, device, backend = dist.init_from_env(args.device)
        print(f"data-parallel: rank {ranks.rank}/{ranks.world} on {device}, {backend}")
    try:
        world = 1 if ranks is None else ranks.world
        if args.data_parallel and args.batchsize % world:
            sys.exit(f"--batchsize {args.batchsize} not divisible by the {world}-device data axis")
        hosts = 1 if ranks is None or args.dataset != "multi" else ranks.hosts()
        if args.batchsize % hosts:
            sys.exit(f"--batchsize {args.batchsize} not divisible by the {hosts} hosts")
        with matmul_precision(args.precision):
            return _train(args, device, ranks, hosts)
    finally:
        if ranks is not None:
            dist.destroy()


def _scene_input(args, device):
    """--dataset scene: the scene's views, read once, in their order."""
    ds = FinetuneDataset(os.path.join(args.scene_dir, "train"), args.dataset_name,
                         crop_size=(args.image_size, args.image_size))
    examples = [ds[i] for i in range(len(ds))]

    def batches(bs, limit=None):
        n = len(examples) if limit is None else min(limit, len(examples))
        for s in range(0, n, bs):
            yield batch_to_torch(collate(examples[s:min(s + bs, n)]), device)

    return len(examples), batches, lambda: None, lambda: None


def _multi_input(args, device, hosts: int = 1):
    """--dataset multi (tools/train_prior.py:160-212): one MultiDataset per
    source, concatenated, visited in the interleaving sampler's order; the
    order is drawn once here and anew at each ``reshuffle``. The sampler
    shards over ``hosts`` replicas, one a host as the JAX tool runs one
    process a host; a step's global batch is every host's next
    ``batchsize / hosts`` examples of its shard, in host order (every rank
    reads it whole and keeps its block). One host: the sampler's order."""
    from scade_tpu_torch.prior.multi_data import (
        InterleavedShardedSampler,
        MultiDataset,
        MultipleDataset,
    )

    sources = [MultiDataset(args.dataroot, name, args.phase_anno,
                            crop_size=(args.image_size, args.image_size))
               for name in args.dataset_list]
    ds = MultipleDataset(sources)
    # one sampler a host, each on the JAX tool's seed: their draws stay in step
    samplers = [InterleavedShardedSampler(ds, num_replicas=hosts, rank=h,
                                          sample_ratio=args.sample_ratio,
                                          rng=np.random.default_rng(args.seed_num))
                for h in range(hosts)]
    per_host = args.batchsize // hosts

    def global_order():
        shards = [list(iter(sm)) for sm in samplers]
        return [i for s in range(0, len(shards[0]), per_host)
                for shard in shards for i in shard[s:s + per_host]]

    order = {"idx": global_order()}

    def reshuffle():
        order["idx"] = global_order()

    def batches(bs, limit=None):
        idx = order["idx"] if limit is None else order["idx"][:limit]
        for s in range(0, len(idx), bs):
            yield batch_to_torch(collate_multi([ds[i] for i in idx[s:s + bs]]), device)

    def visit_order():
        src = np.searchsorted(ds._cum, order["idx"], side="right") - 1
        return dict(index=list(order["idx"]), source=[args.dataset_list[d] for d in src])

    return len(order["idx"]), batches, reshuffle, visit_order


def write_loss_jsonl(path: str, loss_dicts: List[dict], epoch: int, first_step: int) -> int:
    """Appends one JSON line per step (its global number, the epoch, each
    loss); returns the next step's number."""
    keys = sorted(loss_dicts[0])
    rows = torch.stack([torch.stack([d[k] for k in keys]) for d in loss_dicts]).cpu()
    with open(path, "a") as fp:
        for i, row in enumerate(rows.tolist()):
            rec = {"step": first_step + i, "epoch": epoch}
            rec.update(zip(keys, row))
            fp.write(json.dumps(rec) + "\n")
    return first_step + len(loss_dicts)


def _train(args, device, ranks: Optional[dist.Ranks] = None, hosts: int = 1) -> dict:
    primary = ranks is None or ranks.primary
    say = print if primary else (lambda *a, **k: None)
    if primary:
        os.makedirs(args.log_dir, exist_ok=True)
    tc = config_from_args(args)
    if args.dataset == "multi":
        n_examples, batches, reshuffle, visit_order = _multi_input(args, device, hosts)
    else:
        n_examples, batches, reshuffle, visit_order = _scene_input(args, device)
    say(f"{n_examples} training examples")
    if args.data_parallel:
        say(f"data-parallel over {1 if ranks is None else ranks.world} ranks")

    model = build_model(args, device)
    gen = torch.Generator(device=device).manual_seed(args.seed_num)
    draw_z = z_from(gen, args.d_latent)
    opt = PriorOptimizer(model, tc)
    pre_opt = PriorOptimizer(model, tc, fixed_backbone=True) if args.pretrain_mlp_epochs else None

    shifts = {k: v.to(device) for k, v in zero_shifts_for(model).items()}
    mv_path = os.path.join(args.log_dir, "mean_var_adain.npy")
    selected_z = None
    saved, epoch_means = [], []
    jsonl_step = 0
    for epoch in range(args.epochs):
        if epoch == 0:
            say("Initializing AdaIn layers")
            shifts = compute_adain_stats(model, batches(1, args.adain_subset), draw_z,
                                         tc.mini_batch_size, mv_path if primary else None, ranks)
            say("AdaIn weights init done.")
            if args.only_output_adain_init:
                say(f"--only_output_adain_init: wrote {mv_path}, exiting")
                return dict(model=model, shifts=shifts, z=None, checkpoints=[], losses=[],
                            order=visit_order())
            if args.check_init:
                if primary:
                    check_init(model, shifts, next(batches(1)), draw_z, tc.mini_batch_size,
                               args.log_dir)
                say("Done with debug block.")
                return dict(model=model, shifts=shifts, z=None, checkpoints=[], losses=[],
                            order=visit_order())

        if args.debug_mode:
            if selected_z is None:
                selected_z = np.zeros((n_examples, args.d_latent), np.float32)
        elif epoch % tc.refresh_z == 0:
            say("Recaching z-codes...")
            reshuffle()  # a new visit order; the z are cached in it
            selected_z = recache_z(model, shifts, tc, batches(args.batchsize), draw_z, gen, ranks)
            say(f"cached z: {selected_z.shape}")

        totals, loss_dicts = [], []
        idx = 0
        pretrain = pre_opt is not None and epoch < args.pretrain_mlp_epochs
        for batch in batches(args.batchsize):
            B = batch["rgb"].shape[0]
            z = torch.from_numpy(selected_z[idx:idx + B]).to(device)
            idx += B
            if ranks is not None and B % ranks.world:
                continue  # the uneven remainder batch is dropped (train_prior.py:345-346)
            draws = L.draw_criterion(gen, batch, tc.loss_mode)
            if ranks is not None:
                mine = ranks.block(B)
                batch, z, draws = rows_of(batch, mine), z[mine], draws_of(draws, mine)
            total, loss_dict = train_step(model, pre_opt if pretrain else opt, shifts, batch, z,
                                          draws, tc, ranks)
            totals.append(total)
            if args.loss_jsonl:
                loss_dicts.append(loss_dict)
        if args.loss_jsonl and loss_dicts and primary:
            jsonl_step = write_loss_jsonl(args.loss_jsonl, loss_dicts, epoch, jsonl_step)
        if totals:
            epoch_means.append(torch.stack(totals).mean().item())
            say(f"Epoch {epoch}/{args.epochs}: loss {epoch_means[-1]:.5f}")
        else:
            say(f"Epoch {epoch}/{args.epochs}: NO trainable batches: the loader yielded "
                "nothing, or every batch was a remainder that does not split over the ranks")

        if epoch % 8 == 0 or epoch == args.epochs - 1:
            path = os.path.join(args.log_dir, f"epoch{epoch}_step0.pth")
            if primary:
                save_checkpoint(model, path, epoch)
                say(f"saved {path}")
            saved.append(path)
    return dict(model=model, shifts=shifts, z=selected_z, checkpoints=saved, losses=epoch_means,
                order=visit_order())


if __name__ == "__main__":
    main()
