"""The SCADE NeRF MLP as an ``nn.Module``.

D=8 x W=256 trunk with a skip concat of the embedded position after layer 4,
a view branch (W/2) fed by [feature, embedded dirs, cam latent] and
softplus(beta=10) on the density. Parameter names follow the reference
(``pts_linears.{i}``, ``views_linears.0``, ``feature_linear``,
``alpha_linear``, ``rgb_linear``, ``output_linear``), so reference
state_dicts load with ``strict=True``. Init: xavier-uniform with gain
sqrt(2) on hidden layers and 1 on heads, zero biases.

``compute_dtype=torch.bfloat16`` rounds as the JAX package's ``nerf_apply``
does: matmul operands in bf16 with f32 accumulation, hidden activations
stored in bf16 with a bf16 bias, heads produced in f32.

A model sharded over a model axis (``parallel/mesh.py::shard_params`` sets
``model_axis``) runs its sharded layers column-parallel: each rank computes
its output columns, and the model group gathers them along the last dim.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Static architecture config."""

    D: int = 8
    W: int = 256
    input_ch: int = 3
    input_ch_views: int = 3
    input_ch_cam: int = 0
    output_ch: int = 4  # only used when use_viewdirs=False
    skips: tuple = (4,)
    use_viewdirs: bool = True
    compute_dtype: torch.dtype = torch.float32

    def layer_in_dim(self, i: int) -> int:
        if i == 0:
            return self.input_ch
        # layer i takes the skip concat when layer i-1's output was concatenated
        if (i - 1) in self.skips:
            return self.W + self.input_ch
        return self.W


def _softplus_beta10(x):
    return F.softplus(10.0 * x) / 10.0


def _dense(x, layer: nn.Linear, compute_dtype, out_dtype=torch.float32):
    """Linear layer with operands rounded to ``compute_dtype``, an f32 sum,
    and result and bias in ``out_dtype``."""
    if compute_dtype == torch.float32:
        return F.linear(x.float(), layer.weight, layer.bias)
    y = F.linear(
        x.to(compute_dtype).float(), layer.weight.to(compute_dtype).float()
    ).to(out_dtype)
    return y + layer.bias.to(out_dtype)


class NeRF(nn.Module):
    # parallel/mesh.py's ModelAxis (the grid and the names of the sharded
    # layers) once shard_params has kept this rank's rows; None: whole
    model_axis = None

    def __init__(self, cfg: NeRFConfig, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg

        def linear(in_dim, out_dim, activation):
            layer = nn.Linear(in_dim, out_dim, device=device)
            gain = math.sqrt(2.0) if activation == "relu" else 1.0
            bound = gain * math.sqrt(6.0 / (in_dim + out_dim))
            with torch.no_grad():
                layer.weight.uniform_(-bound, bound, generator=generator)
                layer.bias.zero_()
            return layer

        self.pts_linears = nn.ModuleList(
            [linear(cfg.layer_in_dim(i), cfg.W, "relu") for i in range(cfg.D)]
        )
        view_in = cfg.input_ch_views + cfg.input_ch_cam + cfg.W
        self.views_linears = nn.ModuleList([linear(view_in, cfg.W // 2, "relu")])
        if cfg.use_viewdirs:
            self.feature_linear = linear(cfg.W, cfg.W, "linear")
            self.alpha_linear = linear(cfg.W, 1, "linear")
            self.rgb_linear = linear(cfg.W // 2, 3, "linear")
        else:
            self.output_linear = linear(cfg.W, cfg.output_ch, "linear")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., input_ch + input_ch_views + input_ch_cam), the embedded
        position then the embedded view dir and camera latent.
        Returns (..., 4): [rgb logits, softplus density], in f32."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        hd = torch.bfloat16 if cd == torch.bfloat16 else torch.float32
        input_pts = x[..., : cfg.input_ch].to(hd)
        input_views = x[..., cfg.input_ch:].to(hd)

        h = input_pts
        for i in range(cfg.D):
            h = torch.relu(self._layer(h, f"pts_linears.{i}", out_dtype=hd))
            if i in cfg.skips:
                h = torch.cat([input_pts, h], dim=-1)

        if cfg.use_viewdirs:
            alpha = self._layer(h, "alpha_linear")
            feature = self._layer(h, "feature_linear", out_dtype=hd)
            h = torch.cat([feature, input_views], dim=-1)
            for i in range(len(self.views_linears)):
                h = torch.relu(self._layer(h, f"views_linears.{i}", out_dtype=hd))
            rgb = self._layer(h, "rgb_linear")
            return torch.cat([rgb, _softplus_beta10(alpha)], dim=-1)

        out = self._layer(h, "output_linear")
        return torch.cat([out[..., :3], _softplus_beta10(out[..., 3:])], dim=-1)

    def _layer(self, x, name: str, out_dtype=torch.float32):
        """``_dense`` of the layer ``name``; column-parallel where it is
        sharded: the input's grad is summed over the model group (each rank's
        holds its columns' share), the output gathered from it."""
        layer = self.get_submodule(name)
        axis = self.model_axis
        if axis is None or name not in axis.layers:
            return _dense(x, layer, self.cfg.compute_dtype, out_dtype)
        y = _dense(axis.ranks.model_copy(x), layer, self.cfg.compute_dtype, out_dtype)
        return axis.ranks.model_gather(y, -1)


def nerf_num_params(model: NeRF) -> int:
    return sum(p.numel() for p in model.parameters())
