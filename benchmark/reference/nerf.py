"""The SCADE NeRF train step in plain PyTorch, float32: the yardstick the
``scannet-train`` cell's program is held against.

It follows the published method (SCADE, CVPR 2023; NeRF's hierarchical
sampling) as the reference code ``run_scade_scannet.py`` runs it: a random
train image a step and ``n_rand`` stratified pixels of it, 64 jittered
coarse depths, 128 importance draws from the coarse weights, the fine
network on the sorted union, 128 differentiable P_depth draws from the fine
weights, the RGB losses of both networks plus the space-carving loss against
the K depth hypotheses (scaled by a learned per-image scale and shift), then
Adam on the networks and Adam on the scales and shifts. The positional
encoding and the 8x256 MLP (skip at layer 4, view branch of width 128,
softplus(beta=10) density) are written out with ``F.linear``; there are no
fused kernels, caches or batching tricks here.

Two things are the program's conventions, kept so that a sound program and
this reference draw the same random numbers and take the same discrete
decisions (which pixel, which CDF bin): the order of the random draws from
the step's generator, and the order in which the inverse CDF's sums are
taken (windows of 32, blocks of 16), which decides the 1e-5 guard on empty
bins. Adam rounds as ``optax`` does (bias corrections in float32, one
rounding for each fused multiply-add).

Imports nothing of the program. Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-8
LAST_DIST = 1e10
ROW_WINDOW, SCAN_BLOCK = 32, 16


@dataclasses.dataclass(frozen=True)
class NerfSetup:
    """The sizes and hyperparameters the step needs (from the configuration file)."""

    H: int
    W: int
    n_train: int
    netdepth: int = 8
    netwidth: int = 256
    multires: int = 9
    skips: tuple = (4,)
    n_samples: int = 64
    n_importance: int = 128
    n_rand: int = 1024
    lrate: float = 5e-4
    decay_step: int = 400000
    decay_rate: float = 0.1
    scaleshift_lr: float = 1e-7
    freeze_ss: int = 400000
    space_carving_weight: float = 0.007

    @property
    def input_ch(self) -> int:
        return 3 + 2 * self.multires * 3


def layer_shapes(s: NerfSetup) -> Dict[str, tuple]:
    """(out, in) of every linear layer of one network, by its parameter name."""
    shapes = {}
    for i in range(s.netdepth):
        fan_in = s.input_ch if i == 0 else s.netwidth + (s.input_ch if i - 1 in s.skips else 0)
        shapes[f"pts_linears.{i}"] = (s.netwidth, fan_in)
    shapes["views_linears.0"] = (s.netwidth // 2, s.netwidth + 3)
    shapes["feature_linear"] = (s.netwidth, s.netwidth)
    shapes["alpha_linear"] = (1, s.netwidth)
    shapes["rgb_linear"] = (3, s.netwidth // 2)
    return shapes


# --- arithmetic -------------------------------------------------------------

def f32(x: float) -> float:
    return float(np.float32(x))


def fma(a, b, c):
    """a * b + c rounded once to float32."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a.double() * b).add_(c.double()).float()


# --- the network ------------------------------------------------------------

def encode(x, multires: int):
    """[x, sin(pi 2^k x), cos(pi 2^k x)] for k < multires, frequency major."""
    freqs = torch.as_tensor((2.0 ** np.linspace(0.0, multires - 1, multires)).astype(np.float32),
                            device=x.device)
    xb = (x * math.pi)[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2).reshape(*x.shape[:-1], -1)
    return torch.cat([x, enc], dim=-1)


def mlp(p: Dict[str, torch.Tensor], s: NerfSetup, x, dirs, linear=F.linear):
    """x (N, 3) normalized points, dirs (N, 3) unit directions → (N, 4):
    rgb logits and the softplus(beta=10) density. ``linear(h, weight,
    bias)`` computes each layer (the render's control passes a TF32 one)."""
    emb = encode(x, s.multires)

    def dense(h, name):
        return linear(h, p[f"{name}.weight"], p[f"{name}.bias"])

    h = emb
    for i in range(s.netdepth):
        h = torch.relu(dense(h, f"pts_linears.{i}"))
        if i in s.skips:
            h = torch.cat([emb, h], dim=-1)
    alpha = dense(h, "alpha_linear")
    h = torch.relu(dense(torch.cat([dense(h, "feature_linear"), dirs], -1), "views_linears.0"))
    return torch.cat([dense(h, "rgb_linear"), F.softplus(10.0 * alpha) / 10.0], dim=-1)


# --- rays and compositing ---------------------------------------------------

def rays_at(rows, cols, H: int, intr, c2w):
    """Origins and directions through pixel centres (rows, cols); y flipped,
    the camera looking down -z."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    dirs = torch.stack([((cols + 0.5) - cx) / fx, (H - (rows + 0.5) - cy) / fy,
                        -torch.ones_like(cols)], dim=-1)
    rot = c2w[:3, :3]
    rays_d = dirs[..., None, 0] * rot[:, 0]
    for k in (1, 2):
        rays_d = fma(dirs[..., None, k], rot[:, k], rays_d)
    return c2w[:3, -1].expand(rays_d.shape), rays_d


def composite(raw, z, rays_d):
    """(rgb, weights) of the samples raw (R, S, 4) at depths z (R, S)."""
    d = z[..., 1:] - z[..., :-1]
    d = torch.cat([d, torch.full_like(d[..., :1], LAST_DIST)], -1)
    d = d * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * d)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
                          -1)[..., :-1]
    w = alpha * trans
    return torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), -2), w


# --- inverse-CDF sampling ---------------------------------------------------

def _serial(x):
    c = torch.zeros_like(x[..., 0])
    out = []
    for j in range(x.shape[-1]):
        c = c + x[..., j]
        out.append(c)
    return torch.stack(out, -1)


def _row_sum(x):
    n = x.shape[-1]
    if n <= ROW_WINDOW:
        return _serial(x)[..., -1]
    pad = -n % ROW_WINDOW
    x = F.pad(x, (pad // 2, pad - pad // 2)).unflatten(-1, (-1, ROW_WINDOW))
    return _row_sum(_serial(x)[..., -1])


def _scan(x):
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _serial(x)
    blocks = F.pad(x, (0, -n % SCAN_BLOCK)).unflatten(-1, (-1, SCAN_BLOCK))
    prefix = _serial(blocks)
    before = _scan(prefix[..., -1])[..., :-1]
    off = torch.cat([torch.zeros_like(before[..., :1]), before], -1)
    return (prefix + off[..., None]).flatten(-2)[..., :n]


def sample_pdf(bins, weights, u):
    """Draws u (R, S) through the CDF of weights (R, M-1) over bins (R, M)."""
    w = weights + 1e-5
    cdf = _scan(w / _row_sum(w)[..., None])
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    m = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below, above = torch.clamp(inds - 1, min=0), torch.clamp(inds, max=m - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0, b1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = c1 - c0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b0 + (u - c0) / denom * (b1 - b0)


# --- one step ---------------------------------------------------------------

def pixels(gen, s: NerfSetup, device):
    """A train image and one uniform pixel in each of n_rand equal strata."""
    img = torch.randint(0, s.n_train, (), generator=gen, device=device)
    u = torch.rand(s.n_rand, generator=gen, device=device)
    b = np.arange(s.n_rand + 1, dtype=np.int64) * (s.H * s.W) // s.n_rand
    lo = torch.as_tensor(b[:-1], device=device)
    size = torch.as_tensor((b[1:] - b[:-1]).astype(np.float32), device=device)
    return img, lo + (u * size).long()


def loss_of(params: Dict[str, torch.Tensor], scene: dict, s: NerfSetup, gen):
    """The step's loss from the generator's next draws, and its coarse
    network's RGB loss. ``params`` holds ``coarse.*``, ``fine.*``,
    ``scales`` and ``shifts``."""
    dev = scene["images"].device
    img, pix = pixels(gen, s, dev)
    rows, cols = pix // s.W, pix % s.W
    rays_o, rays_d = rays_at(rows.float(), cols.float(), s.H, scene["intrinsics"][img],
                             scene["poses"][img])
    target = scene["images"][img, rows, cols]
    hyps = scene["hyps"][img][:, rows, cols]  # (K, R, 1)
    R = rays_o.shape[0]
    near = scene["near"].expand(R, 1)
    far = scene["far"].expand(R, 1)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    coarse = {k[7:]: v for k, v in params.items() if k.startswith("coarse.")}
    fine = {k[5:]: v for k, v in params.items() if k.startswith("fine.")}

    def query(p, z):
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
        x = ((pts - scene["bb_center"]) * scene["bb_scale"]).reshape(-1, 3)
        d = viewdirs[:, None, :].expand(R, z.shape[1], 3).reshape(-1, 3)
        return mlp(p, s, x, d).reshape(R, z.shape[1], 4)

    t = torch.linspace(0.0, 1.0, s.n_samples, device=dev)
    z = near * (1.0 - t) + far * t
    jitter = torch.rand((R, s.n_samples), generator=gen, device=dev)
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper, lower = torch.cat([mids, z[..., -1:]], -1), torch.cat([z[..., :1], mids], -1)
    z = fma(upper - lower, jitter, lower)
    rgb0, w0 = composite(query(coarse, z), z, rays_d)

    e = torch.empty(R, s.n_importance + 1, device=dev)
    e.exponential_(generator=gen)
    c = torch.cumsum(e, -1)
    u_imp = c[..., :-1] / c[..., -1:]
    z_imp = sample_pdf(0.5 * (z[..., 1:] + z[..., :-1]), w0[..., 1:-1], u_imp).detach()
    z_all = torch.sort(torch.cat([z, z_imp], -1), dim=-1, stable=True).values
    rgb, w = composite(query(fine, z_all), z_all, rays_d)

    u = torch.rand(R, s.n_importance, generator=gen, device=dev)
    pred = sample_pdf(0.5 * (z_all[..., 1:] + z_all[..., :-1]), w[..., 1:-1], u)
    th = hyps * params["scales"][img] + params["shifts"][img]
    best = torch.min(torch.abs(pred[None] - th.expand(-1, -1, pred.shape[-1])), dim=0).values
    carve = torch.mean(torch.mean(best, dim=-1))
    coarse = torch.mean((rgb0 - target) ** 2)
    return torch.mean((rgb - target) ** 2) + s.space_carving_weight * carve + coarse, coarse


class Adam:
    """Adam as optax rounds it, over a list of tensors updated in place."""

    def __init__(self, params: List[torch.Tensor]):
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def step(self, params, grads, lr: float, apply: bool = True):
        self.count += 1
        bc1, bc2 = (f32(1.0 - f32(np.float64(np.float32(b)) ** self.count)) for b in (B1, B2))
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, self.mu, self.nu):
                g = torch.zeros_like(p) if g is None else g
                m.copy_(fma(g, f32(1.0 - B1), m * f32(B1)))
                v.copy_(fma(g * g, f32(1.0 - B2), v * f32(B2)))
                if apply:
                    c1 = torch.full((), bc1, device=p.device)
                    c2 = torch.full((), bc2, device=p.device)
                    den = torch.sqrt((v / c2).double()).float().add_(f32(EPS)).mul_(c1)
                    p.copy_(fma(m / den, f32(-lr), p))


def train(params: Dict[str, torch.Tensor], scene: dict, s: NerfSetup, seeds: List[int]):
    """``len(seeds)`` steps from ``params`` (updated in place), step i's
    generator seeded with ``seeds[i]``. Returns each step's loss, each step's
    coarse RGB loss and the first step's gradient, by leaf."""
    dev = scene["images"].device
    names = list(params)
    nets = [n for n in names if n not in ("scales", "shifts")]
    adam, adam_ss = Adam([params[n] for n in nets]), Adam([params["scales"], params["shifts"]])
    gen = torch.Generator(device=dev)
    losses, coarse_losses, first = [], [], None
    for step, seed in enumerate(seeds):
        gen.manual_seed(seed)
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        loss, coarse = loss_of(leaves, scene, s, gen)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names],
                                                    allow_unused=True)))
        grads = {n: torch.zeros_like(params[n]) if g is None else g for n, g in grads.items()}
        if first is None:
            first = grads
        lr = s.lrate * s.decay_rate ** ((adam.count + 1) // s.decay_step)
        adam.step([params[n] for n in nets], [grads[n] for n in nets], lr)
        adam_ss.step([params["scales"], params["shifts"]], [grads["scales"], grads["shifts"]],
                     s.scaleshift_lr, apply=step + 1 < s.freeze_ss)
        losses.append(float(loss.detach()))
        coarse_losses.append(float(coarse.detach()))
    return losses, coarse_losses, first
