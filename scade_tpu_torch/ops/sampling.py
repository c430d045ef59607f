"""Hierarchical inverse-CDF sampling (NeRF section 5.2, SCADE P_depth draws).

Weights get a 1e-5 floor, the CDF is prepended with 0,
``searchsorted(..., right=True)`` locates each uniform draw and a
``denom < 1e-5`` guard protects the linear interpolation. The CDF's sums run
in the JAX package's order (see ``ROW_WINDOW``), which K2's kernels follow
too, so every bin and guard decision is ``scade_tpu``'s bit for bit. The draws ``u`` are
an argument: joint, independent, deterministic and cached draws are only
different ways of producing them (``draw_u``). The result is differentiable
in ``bins``, ``weights`` and ``u``; SCADE's space-carving loss backprops
through it.
"""

from __future__ import annotations

from typing import Optional

import torch


def draw_u(generator: Optional[torch.Generator], n_rays: int, n_samples: int,
           det: bool = False, joint: bool = False, device=None):
    """Uniform draws for ``sample_pdf``.

    det:   linspace(0, 1) for every ray (test-time rendering).
    joint: one draw vector shared by all rays (SCADE's is_joint mode).
    """
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=device)
        return u.expand(n_rays, n_samples)
    if joint:
        u = torch.rand(n_samples, generator=generator, device=device)
        return u.expand(n_rays, n_samples)
    return torch.rand(n_rays, n_samples, generator=generator, device=device)


def draw_u_sorted(generator: Optional[torch.Generator], n_rays: int,
                  n_samples: int, det: bool = False, joint: bool = False,
                  device=None):
    """Per-ray ascending uniform draws with the joint law of the order
    statistics of ``n_samples`` iid U(0, 1) variables, made without a sort
    from normalized cumulative sums of S+1 iid Exp(1) spacings. Every
    consumer of the importance draws is order-invariant, so the sorted law
    trains like the iid one and lets the coarse/fine union be a merge."""
    if det:
        return draw_u(generator, n_rays, n_samples, det=True, device=device)
    rows = 1 if joint else n_rays
    e = torch.empty(rows, n_samples + 1, dtype=torch.float32, device=device)
    e.exponential_(generator=generator)
    c = torch.cumsum(e, dim=-1)
    u = c[..., :-1] / c[..., -1:]
    return u.expand(n_rays, n_samples) if joint else u


def merge_sorted(a, b, va=None, vb=None):
    """Merge two per-ray ascending arrays into one sorted union.

    a: (..., Na), b: (..., Nb); optional payloads va: (..., Na, C) and
    vb: (..., Nb, C) follow the same permutation. Ties keep a first (a
    stable sort of the concatenation), as the JAX package's rank formula
    does.
    """
    merged, idx = torch.sort(torch.cat([a, b], dim=-1), dim=-1, stable=True)
    if va is None:
        return merged
    vals = torch.cat([va, vb], dim=-2)
    idx = idx[..., None].expand(*idx.shape, vals.shape[-1])
    return merged, torch.gather(vals, -2, idx)


# The CDF's order of sums: the JAX package's, as XLA runs it on the CPU (its
# optimized HLO). A row sum of more than ROW_WINDOW terms becomes windows of
# ROW_WINDOW (the row zero-padded to a multiple of ROW_WINDOW, the padding
# split between the two ends, the smaller half first), each window summed in
# order, then the window sums summed the same way. A cumulative sum of more
# than SCAN_BLOCK terms becomes blocks of SCAN_BLOCK from the start, each
# summed cumulatively in order, and each entry is its in-block sum plus its
# block's offset: the cumulative sum of the block totals before it, taken
# the same way. Every serial sum starts from +0.
ROW_WINDOW = 32
SCAN_BLOCK = 16


def _serial_sums(x):
    """The running sums of x (..., n) in order from +0 → (..., n)."""
    c = torch.zeros_like(x[..., :1])[..., 0]
    out = []
    for j in range(x.shape[-1]):
        c = c + x[..., j]
        out.append(c)
    return torch.stack(out, -1)


def _row_sum(x):
    """x (..., n) summed over its last axis in the JAX package's order → (...)."""
    n = x.shape[-1]
    if n <= ROW_WINDOW:
        return _serial_sums(x)[..., -1]
    pad = -n % ROW_WINDOW
    x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).unflatten(-1, (-1, ROW_WINDOW))
    return _row_sum(_serial_sums(x)[..., -1])


def _inclusive_scan(x):
    """The cumulative sum of x (..., n) over its last axis in the JAX
    package's order."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _serial_sums(x)
    blocks = torch.nn.functional.pad(x, (0, -n % SCAN_BLOCK)).unflatten(-1, (-1, SCAN_BLOCK))
    prefix = _serial_sums(blocks)
    before = _inclusive_scan(prefix[..., -1])[..., :-1]
    offsets = torch.cat([torch.zeros_like(before[..., :1]), before], -1)
    return (prefix + offsets[..., None]).flatten(-2)[..., :n]


def _cdf_parts(weights):
    """The CDF of ``weights`` (..., M-1) → (..., M), with the pdf (..., M-1)
    and the total of w' (..., 1) it is built from."""
    weights = weights + 1e-5  # prevent nans
    total = _row_sum(weights)[..., None]
    pdf = weights / total
    cdf = _inclusive_scan(pdf)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1), pdf, total


def _cdf_from_weights(weights):
    return _cdf_parts(weights)[0]


def _interp(u, cdf_below, cdf_above, bins_below, bins_above):
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def lookup(cdf, bins, u):
    """Inverse CDF from a built CDF: cdf and bins (R, M) ascending, u (R, S).
    "below" is the last m with cdf[m] <= u, "above" the first m with
    cdf[m] > u, or M-1 where there is none."""
    m = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=m - 1)
    return _interp(
        u,
        torch.gather(cdf, -1, below),
        torch.gather(cdf, -1, above),
        torch.gather(bins, -1, below),
        torch.gather(bins, -1, above),
    )


def sample_pdf(bins, weights, u):
    """Inverse-CDF sampling of ``u`` from the histogram (bins, weights).

    bins: (..., M) sorted positions; weights: (..., M-1) unnormalized
    probabilities of the intervals; u: (..., S) draws in [0, 1].
    Returns (..., S) samples.
    """
    return lookup(_cdf_from_weights(weights), bins, u)
