"""The cIMLE prior's fine-tune step in plain PyTorch: the yardstick the
``prior-step`` cell's program is held against.

The network is ``prior_net`` (LeReS with the cIMLE AdaIn taps), the losses
and their draws ``prior_criterion``; both are written from the methods and
import nothing of the program. Here, as SCADE's ``tools/train_single.py``
runs them:

- the AdaIn statistics: per view, 5 z, the spatial mean of the 4 tap
  activations in eval mode with zero shifts, averaged over the z; over the
  views their mean and variance (ddof 1), in float64;
- a z-recache's losses: a view repeated once per candidate z, eval mode,
  the criterion's per-image total;
- a train step: train-mode forward (BatchNorm on the batch's statistics),
  the criterion in float32, the mean total's backward, every gradient
  clipped together to global norm 10, then SGD with momentum 0.9 and the
  weight decay added to the gradient, at the learning rate of each
  parameter's group (encoder, decoder, AdaIn MLPs).

The caller sets the precision flags.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import prior_criterion as C
from .prior_net import DepthNet, from_config, zero_shifts

draws = C.draws


def build(config: dict, device) -> DepthNet:
    """The configuration's network, its parameters made on ``device`` (to be
    overwritten by the caller's weights)."""
    with torch.device(device):
        return from_config(config)


def adain_shifts(net: DepthNet, rgb: torch.Tensor, z: torch.Tensor) -> Dict[str, torch.Tensor]:
    """rgb (N, 3, S, S) views, z (N, n_z, d) → the AdaIn mean and variance
    shifts of the 4 taps, float32 on the views' device."""
    net.eval()
    zero = zero_shifts(net, rgb.device)
    per_view = []
    with torch.no_grad():
        for i in range(rgb.shape[0]):
            x = rgb[i:i + 1].expand(z.shape[1], -1, -1, -1)
            per_view.append([a.double().mean((0, 2, 3)) for a in net.taps(x, z[i], zero)])
    shifts = {}
    for j in range(4):
        rows = torch.stack([v[j] for v in per_view])
        shifts[f"mean{j}"] = rows.mean(0).float()
        shifts[f"var{j}"] = rows.var(0, correction=1 if rows.shape[0] > 1 else 0).float()
    return shifts


def view_totals(net: DepthNet, shifts, batch: dict, z: torch.Tensor, drawn: dict,
                loss_mode: str) -> torch.Tensor:
    """The criterion's per-image totals of ``batch`` under ``z`` in eval mode."""
    net.eval()
    with torch.no_grad():
        return C.criterion(net(batch["rgb"], z, shifts).float(), batch, loss_mode, drawn)


def group_lr(name: str, config: dict) -> float:
    if ".style_mod" in name:
        return config["mlp_lr"]
    if name.startswith("decoder_modules."):
        return config["base_lr"] * config["scale_decoder_lr"]
    return config["base_lr"]


def train(net: DepthNet, shifts, config: dict, batches: List[dict], zs: List[torch.Tensor],
          drawn: List[dict]):
    """One SGD step a batch, in order, in place. Returns each step's mean
    total loss, the first step's clipped gradient by parameter name, and the
    first step's depth prediction."""
    named = list(net.named_parameters())
    lrs = [group_lr(n, config) for n, _ in named]
    mom, wd, clip = config["momentum"], config["weight_decay"], config["grad_clip"]
    bufs: List[torch.Tensor] = []
    losses, first, depth0 = [], None, None
    for batch, z, d in zip(batches, zs, drawn):
        net.train()
        net.zero_grad(set_to_none=True)
        depth = net(batch["rgb"], z, shifts).float()
        if depth0 is None:
            depth0 = depth.detach().clone()
        total = C.criterion(depth, batch, config["loss_mode"], d).mean()
        total.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for _, p in named]
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
        if norm >= clip:
            grads = [g / norm * clip for g in grads]
        if first is None:
            first = {n: g.detach().clone() for (n, _), g in zip(named, grads)}
        with torch.no_grad():
            for k, ((_, p), g, lr) in enumerate(zip(named, grads, lrs)):
                g = g + wd * p
                if len(bufs) <= k:
                    bufs.append(g.clone())
                else:
                    bufs[k].mul_(mom).add_(g)
                p.sub_(lr * bufs[k])
        losses.append(float(total.detach()))
    return losses, first, depth0
