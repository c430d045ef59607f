"""Volume rendering: densities and colours along rays → pixel values.

The model emits softplus(beta=10) densities; ``compute_weights`` applies
relu, ``alpha = 1 - exp(-sigma * dist)`` and an exclusive cumprod
transmittance with the classic 1e-10 floor. Randomness (``t_rand``,
``noise``) is an argument, so callers own the generator.
"""

from __future__ import annotations

import torch

from scade_tpu_torch.ops.arith import fma

# Effectively infinite distance after the last sample.
_LAST_DIST = 1e10


def stratified_z_vals(near, far, n_samples: int, lindisp: bool = False):
    """Evenly spaced depths between per-ray near/far: (..., 1) → (..., S)."""
    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=near.device)
    if not lindisp:
        return near * (1.0 - t_vals) + far * t_vals
    return 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)


def perturb_z_vals(z_vals, t_rand):
    """Jitter each sample uniformly within its stratum; ``t_rand`` holds
    uniform [0, 1) draws of z_vals' shape."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    # one fused multiply-add, as XLA contracts the JAX package's jitted step
    return fma(upper - lower, t_rand, lower)


def compute_weights(raw, z_vals, rays_d, noise=0.0):
    """Per-sample compositing weights.

    raw: (..., S, 4), raw[..., 3] the softplus'd density; z_vals: (..., S);
    rays_d: (..., 3), not normalized (its norm turns depth steps into
    distances).
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], _LAST_DIST)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    sigma = torch.relu(raw[..., 3] + noise)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1),
        dim=-1,
    )[..., :-1]
    return alpha * trans


def raw2outputs(raw, z_vals, rays_d, noise=0.0):
    """Full compositing → (rgb_map, disp_map, acc_map, weights, depth_map).
    ``noise`` is 0.0 or a pre-drawn (..., S) tensor of ``randn * std``."""
    rgb = torch.sigmoid(raw[..., :3])
    weights = compute_weights(raw, z_vals, rays_d, noise)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    return rgb_map, disp_map, acc_map, weights, depth_map
