"""SCADE's test-time render in plain PyTorch, float32: the yardstick the
``scannet-render`` cell's program is held against.

NeRF's hierarchical sampling in the deterministic form a test view is
rendered in (``run_scade_scannet.py`` with ``perturb`` 0 and
``raw_noise_std`` 0): 64 evenly spaced depths between near and far through
the coarse network, 128 importance depths drawn at evenly spaced u in
[0, 1] through the inverse CDF of the coarse weights, and the fine network
on the sorted union of both. A ray's colour is its weights' sum of the
samples' colours and its depth their sum of the samples' depths. The
network, the compositing and the inverse CDF are ``reference/nerf.py``'s;
there are no kernels, caches or chunks of the program's here.

The control computes every layer in TF32 (``tf32_linear``): each operand
rounded to TF32's 10 mantissa bits, as the tensor cores take it, and the
products summed in float32.

Imports nothing of the program. Nothing here runs when the module is
imported.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from reference import nerf as ref


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def tf32_linear(h, weight, bias):
    return F.linear(tf32(h), tf32(weight), bias)


def maps(params: Dict[str, torch.Tensor], s: ref.NerfSetup, rays_o, rays_d, near: float,
         far: float, bb_center, bb_scale, linear=F.linear) -> Dict[str, torch.Tensor]:
    """The coarse and fine colours (R, 3) and depths (R,) of the rays
    ``rays_o``, ``rays_d`` (R, 3). ``params`` holds ``coarse.*`` and
    ``fine.*``."""
    R, dev = rays_o.shape[0], rays_o.device
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    coarse = {k[7:]: v for k, v in params.items() if k.startswith("coarse.")}
    fine = {k[5:]: v for k, v in params.items() if k.startswith("fine.")}

    def query(p, z):
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
        x = ((pts - bb_center) * bb_scale).reshape(-1, 3)
        d = viewdirs[:, None, :].expand(R, z.shape[1], 3).reshape(-1, 3)
        return ref.mlp(p, s, x, d, linear).reshape(R, z.shape[1], 4)

    t = torch.linspace(0.0, 1.0, s.n_samples, device=dev)
    near = torch.full((R, 1), near, device=dev)
    far = torch.full((R, 1), far, device=dev)
    z = near * (1.0 - t) + far * t
    rgb0, w0 = ref.composite(query(coarse, z), z, rays_d)
    u = torch.linspace(0.0, 1.0, s.n_importance, device=dev).expand(R, s.n_importance)
    z_imp = ref.sample_pdf(0.5 * (z[..., 1:] + z[..., :-1]), w0[..., 1:-1], u)
    z_all = torch.sort(torch.cat([z, z_imp], -1), dim=-1, stable=True).values
    rgb, w = ref.composite(query(fine, z_all), z_all, rays_d)
    return {"rgb0": rgb0, "depth0": torch.sum(w0 * z, -1),
            "rgb": rgb, "depth": torch.sum(w * z_all, -1)}


def render_rows(params: Dict[str, torch.Tensor], s: ref.NerfSetup, rows, intr, c2w,
                near: float, far: float, bb_center, bb_scale, linear=F.linear,
                block: int = 4096) -> Dict[str, torch.Tensor]:
    """``maps`` of every pixel of the image rows ``rows`` (a 1-D tensor), row
    after row, in blocks of ``block`` rays."""
    cols = torch.arange(s.W, dtype=torch.float32, device=rows.device)
    r = rows.float()[:, None].expand(-1, s.W).reshape(-1)
    c = cols[None, :].expand(rows.shape[0], -1).reshape(-1)
    rays_o, rays_d = ref.rays_at(r, c, s.H, intr, c2w)
    parts = [maps(params, s, rays_o[i:i + block], rays_d[i:i + block], near, far, bb_center,
                  bb_scale, linear) for i in range(0, rays_o.shape[0], block)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
