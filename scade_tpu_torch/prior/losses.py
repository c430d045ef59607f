"""The cIMLE prior's five-loss criterion, in NCHW torch.

The counterpart of ``scade_tpu/prior/losses.py`` (reference:
ambiguity_aware_prior/lib/models/ILNR_loss.py, MSGIL_loss.py,
ranking_loss.py, PWN_edges.py, PWN_planes.py, Surface_normal.py). The JAX
package's TPU forms are not kept, only their values: its bucketed
``masked_sample`` is a ``searchsorted`` over the mask's cumsum here, its
``_pair_cos`` custom VJP a plain gather that autograd differentiates, and
its ``perm`` plane sampler the per-plane inverse CDF its ``cdf`` lowering
(bit-identical to ``perm``) computes.

Each sampled loss is two functions: a *draw*, which makes its indices from
a ``torch.Generator`` (they depend on the ground truth, the image and the
plane mask, never on the prediction), and the loss on given indices.
``draw_criterion`` makes every draw ``criterion`` needs, so a caller can
draw once and feed the same indices to two runs (the card and the CPU, or
the JAX package's own draws).

The JAX package's choices are kept (``PARITY.md`` deviations 1 and 2): the
shipped degenerate (0, 1) ILNR/MSGIL transform (``trimmed_stats`` gives the
intended 10%-trimmed one), MSGIL's non-progressive scales, and PWN edges'
three terms per image where the reference overwrites them.

Shapes: depth and prediction (B, 1, H, W); rgb (B, 3, H, W); planes
(B, H, W) integer instance ids (0 = none); focal_length and quality_flg (B,).
A flat index is ``row * W + col``, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from scade_tpu_torch.parallel.dist import batch_ranks
from scade_tpu_torch.utils.profiling import span

DEFAULT_LOSS_MODE = ("_ranking-edge_pairwise-normal-regress-edge_msgil-normal_"
                     "meanstd-tanh_pairwise-normal-regress-plane_")


def safe_normalize(v: torch.Tensor, dim: int = 1, eps: float = 1e-12) -> torch.Tensor:
    """Unit vectors with a finite gradient at v = 0: v·rsqrt(|v|² + eps)."""
    return v * torch.rsqrt((v * v).sum(dim, keepdim=True) + eps)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def masked_sample(mask_flat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Indices where ``mask_flat`` (bool, (..., P)) holds, one for each
    uniform in ``u`` ((..., n), in [0, 1)): ``u·max(total, 1)`` looked up in
    the mask's cumsum with ``searchsorted(side="right")``, clipped to P−1 (so
    an empty mask gives P−1). The JAX package's ``masked_sample`` law."""
    P = mask_flat.shape[-1]
    cdf = torch.cumsum(mask_flat.float(), -1)
    total = cdf[..., -1:]
    return torch.searchsorted(cdf, u * total.clamp(min=1.0), right=True).clamp_(max=P - 1)


def _uniform(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _sobel(x: torch.Tensor):
    """VALID sobel responses of (N, 1, H, W) → gx, gy (N, H−2, W−2)."""
    k = torch.tensor([[[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      [[1, 2, 1], [0, 0, 0], [-1, -2, -1]]], dtype=x.dtype, device=x.device)
    g = F.conv2d(x, k[:, None])
    return g[:, 0], g[:, 1]


def sobel_edges(img: torch.Tensor):
    """Sobel magnitude and orientation of (N, H, W) images, VALID and then
    zero-padded back to (N, H, W) (ranking_loss.py getEdge :127-143)."""
    gx, gy = _sobel(img[:, None])
    return F.pad(torch.sqrt(gx ** 2 + gy ** 2), (1, 1, 1, 1)), F.pad(torch.atan2(gy, gx),
                                                                      (1, 1, 1, 1))


def edge_pairs(anchors: torch.Tensor, dist: torch.Tensor, thetas: torch.Tensor, H: int, W: int):
    """edgeGuidedSampling's pairs (ranking_loss.py:60-107) from (N, n)
    anchor indices and (N, 4, n) integer distances: 4 points along each
    anchor's (absolute) gradient direction, two behind and two ahead, paired
    (a,b), (b,c), (c,d). ``thetas``: (N, H, W). Returns A, B of (N, 3n)."""
    theta = thetas.reshape(thetas.shape[0], -1).gather(1, anchors)
    row_a, col_a = anchors // W, anchors % W
    sign = torch.tensor([-1.0, -1.0, 1.0, 1.0], device=dist.device)[None, :, None]
    d = dist.float() * sign
    col = col_a[:, None] + torch.round(d * torch.abs(torch.cos(theta))[:, None]).long()
    row = row_a[:, None] + torch.round(d * torch.abs(torch.sin(theta))[:, None]).long()
    flat = row.clamp(0, H - 1) * W + col.clamp(0, W - 1)  # (N, 4, n)
    return flat[:, :3].flatten(1), flat[:, 1:].flatten(1)


def draw_edge_pairs(gen: torch.Generator, edges: torch.Tensor, thetas: torch.Tensor,
                    n_anchors: int, dist_lo: int, dist_hi: int):
    """Anchors uniform over the pixels whose edge is at least 0.1 of the
    image's largest, distances uniform in [dist_lo, dist_hi); → A, B."""
    N, H, W = edges.shape
    flat = edges.reshape(N, -1)
    anchors = masked_sample(flat >= 0.1 * flat.max(1, keepdim=True).values,
                            _uniform(gen, N, n_anchors))
    dist = torch.randint(dist_lo, dist_hi, (N, 4, n_anchors), generator=gen, device=gen.device)
    return edge_pairs(anchors, dist, thetas, H, W)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) at flat pixel indices idx (B, n) → (B, C, n)."""
    xf = x.flatten(2)
    return xf.gather(2, idx[:, None].expand(-1, xf.shape[1], -1))


# ---------------------------------------------------------------------------
# ILNR and MSGIL
# ---------------------------------------------------------------------------


def _trimmed_stats(gt_flat: torch.Tensor, valid: torch.Tensor):
    """10%-trimmed mean/std over one image's valid depths (the intended
    transform; (0, 1) under 10 valid pixels)."""
    order = torch.sort(torch.where(valid, gt_flat, torch.full_like(gt_flat, float("inf")))).values
    n_valid = valid.sum()
    lo = (n_valid.float() * 0.1).long()
    ranks = torch.arange(order.shape[0], device=order.device)
    finite = torch.isfinite(order)
    w = ((ranks >= lo) & (ranks < n_valid - lo) & finite).float()
    vals = torch.where(finite, order, torch.zeros_like(order))
    denom = w.sum().clamp(min=1.0)
    mean = (vals * w).sum() / denom
    var = (((vals - mean) ** 2) * w).sum() / (denom - 1.0).clamp(min=1.0)
    ok = n_valid >= 10
    return (torch.where(ok, mean, torch.zeros_like(mean)),
            torch.where(ok, torch.sqrt(var), torch.ones_like(var)))


def _transform(g: torch.Tensor, valid: torch.Tensor, trimmed_stats: bool) -> torch.Tensor:
    """(g − mean)/(std + 1e-8) per image of (B, P) ground truth."""
    if not trimmed_stats:  # the shipped transform: (0, 1), so g itself in f32
        return g
    stats = [_trimmed_stats(g[i], valid[i]) for i in range(g.shape[0])]
    mean = torch.stack([s[0] for s in stats])[:, None]
    std = torch.stack([s[1] for s in stats])[:, None]
    return (g - mean) / (std + 1e-8)


def ilnr_loss(pred, gt, valid_threshold=-1e-8, max_threshold=1e8,
              trimmed_stats: bool = False) -> torch.Tensor:
    """MEADSTD_TANH_NORM_Loss (ILNR_loss.py:12-80) → (B,); an image with at
    most 100 valid pixels gives 0."""
    B = pred.shape[0]
    mask = (gt > valid_threshold) & (gt < max_threshold)
    m = mask.reshape(B, -1).float()
    p, g = pred.reshape(B, -1), gt.reshape(B, -1)
    g_t = _transform(g, m > 0, trimmed_stats)
    denom = m.sum(1).clamp(min=1.0)
    l_mae = (torch.abs(g_t - p) * m).sum(1) / denom
    l_tanh = (torch.abs(torch.tanh(0.01 * g_t) - torch.tanh(0.01 * p)) * m).sum(1) / denom
    return (l_mae + l_tanh) * (m.sum(1) > 100).float()


def _one_scale_gradient(d: torch.Tensor, mf: torch.Tensor) -> torch.Tensor:
    """MSGIL_loss.py:18-37 on (B, H, W) residual and mask."""
    B = d.shape[0]
    v_mask = mf[:, :-2, :] * mf[:, 2:, :]
    v_grad = torch.abs(d[:, :-2, :] - d[:, 2:, :]) * v_mask
    h_mask = mf[:, :, :-2] * mf[:, :, 2:]
    h_grad = torch.abs(d[:, :, :-2] - d[:, :, 2:]) * h_mask
    valid = h_mask.reshape(B, -1).mean(-1) + v_mask.reshape(B, -1).mean(-1)
    grad = h_grad.reshape(B, -1).mean(-1) + v_grad.reshape(B, -1).mean(-1)
    return grad / (valid + 1e-8)


def msgil_loss(pred, gt, scale: int = 4, valid_threshold=-1e-8, trimmed_stats: bool = False,
               progressive: bool = False) -> torch.Tensor:
    """MSGIL_NORM_Loss (MSGIL_loss.py:6-77) → (B,). As shipped each of the
    ``scale`` terms re-downsamples the full-size maps by 2 (PARITY.md
    deviation 2); ``progressive`` halves again at each scale."""
    B, _, H, W = pred.shape
    mask = (gt > valid_threshold)[:, 0]
    g_t = _transform(gt.reshape(B, -1), mask.reshape(B, -1), trimmed_stats).reshape(B, H, W)
    total = torch.zeros(B, device=pred.device)
    dp, dg, dm = pred[:, 0], g_t, mask
    for _ in range(scale):
        dp2, dg2, dm2 = dp[:, ::2, ::2], dg[:, ::2, ::2], dm[:, ::2, ::2]
        total = total + _one_scale_gradient(dp2 - dg2, dm2.to(pred.dtype))
        if progressive:
            dp, dg, dm = dp2, dg2, dm2
    return total


# ---------------------------------------------------------------------------
# edge-guided ranking
# ---------------------------------------------------------------------------


def draw_ranking_edge(gen: torch.Generator, gt, rgb, n_anchors: int = 3000,
                      mask_value: float = -1e-8):
    """The ranking loss's pairs: 3n edge-guided pairs at the red channel's
    edges (distances 2–30) and n random pairs over valid depth, a 1:3 mix
    (ranking_loss.py:178-186). → A, B of (B, 4n)."""
    B, _, H, W = gt.shape
    edges, thetas = sobel_edges(rgb[:, 0])
    A, Bi = draw_edge_pairs(gen, edges, thetas, n_anchors, 2, 31)
    r = masked_sample(gt.reshape(B, -1) > mask_value, _uniform(gen, B, 2 * n_anchors))
    return torch.cat([A, r[:, 0::2]], 1), torch.cat([Bi, r[:, 1::2]], 1)


def ranking_edge_loss(pred, gt, pairs, mask_value=-1e-8, sigma=0.03, alpha=1.0) -> torch.Tensor:
    """EdgeguidedRankingLoss (ranking_loss.py:112-201) on the pairs (A, B)
    of ``draw_ranking_edge``: squared difference where the ground truth is
    about equal, softplus ranking loss elsewhere. → (B,)."""
    A, Bi = pairs
    B = pred.shape[0]
    pf, gf = pred.reshape(B, -1), gt.reshape(B, -1)
    iA, iB = pf.gather(1, A), pf.gather(1, Bi)
    tA, tB = gf.gather(1, A), gf.gather(1, Bi)
    consistency = (tA > mask_value).float() * (tB > mask_value).float()
    ratio = (tA + 1e-6) / (tB + 1e-6)
    mask_eq = ((ratio < 1.0 + sigma) & (ratio > 1.0 / (1.0 + sigma))).float()
    labels = torch.where(ratio >= 1.0 + sigma, 1.0,
                         torch.where(ratio <= 1.0 / (1.0 + sigma), -1.0, 0.0))
    equal_l = (iA - iB) ** 2 * mask_eq * consistency
    unequal_l = F.softplus((-iA + iB) * labels) * (1.0 - mask_eq) * consistency
    return alpha * equal_l.mean(1) + unequal_l.mean(1)


# ---------------------------------------------------------------------------
# surface normals
# ---------------------------------------------------------------------------


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 mean with zero padding counted (avg_pool2d's default)."""
    return F.avg_pool2d(x, 3, 1, 1)


def depth_to_xyz(depth: torch.Tensor, focal_length: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) depth → (B, 3, H, W) camera points (Surface_normal.py
    :6-30): x = (u − W/2)d/f, y = (v − H/2)d/f, z = d."""
    _, _, H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, None, None] - W / 2.0
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[None, None, :, None] - H / 2.0
    f = focal_length.reshape(-1, 1, 1, 1)
    return torch.cat([u * depth / f, v * depth / f, depth], 1)


def surface_normal_from_depth(depth, focal_length, valid_mask=None) -> torch.Tensor:
    """get_surface_normalv2 over twice avg-filtered depth (Surface_normal.py
    :95-213): (B, 1, H, W) → (B, 3, H, W) unit normals, zero where
    ``valid_mask`` (B, 1, H, W) is false."""
    _, _, H, W = depth.shape
    xyz = depth_to_xyz(_avg_pool3(_avg_pool3(depth)), focal_length)
    patch, half = 5, 2
    pad = F.pad(xyz, (half, half, half, half))
    horiz = pad[:, :, half:half + H, :W] - pad[:, :, half:half + H, -W:]
    vert = pad[:, :, :H, half:half + W] - pad[:, :, -H:, half:half + W]
    horiz_in = pad[:, :, half:half + H, 1:W + 1] - pad[:, :, half:half + H, patch - 1:patch - 1 + W]
    vert_in = pad[:, :, 1:H + 1, half:half + W] - pad[:, :, patch - 1:patch - 1 + H, half:half + W]

    def orient(n):
        return torch.where((n * xyz).sum(1, keepdim=True) > 0, -n, n)

    n1 = safe_normalize(orient(torch.linalg.cross(horiz_in, vert_in, dim=1)))
    n2 = safe_normalize(orient(torch.linalg.cross(horiz, vert, dim=1)))
    n = orient(safe_normalize(n1 + n2))
    if valid_mask is not None:
        n = torch.where(valid_mask, n, torch.zeros_like(n))
    return n


# ---------------------------------------------------------------------------
# PWN edges
# ---------------------------------------------------------------------------


def pwn_edge_maps(im, n_g, g):
    """EdgeguidedNormalRegressionLoss's edge maps (PWN_edges.py:171-192) for
    a batch: the red channel's sobel edges, the gt normals' edges (the mean
    over channels of |sobel|), the normal edges zeroed within 5 px of the
    border, and both zeroed on the dilated gt-depth edges. im (B, 3, H, W),
    n_g (B, 3, H, W), g (B, 1, H, W) → edges_img, thetas_img, edges_normal,
    thetas_normal, each (B, H, W)."""
    B, _, H, W = im.shape
    edges_img, thetas_img = sobel_edges(im[:, 0])
    gx, gy = _sobel(n_g.reshape(B * 3, 1, H, W))
    gxm = torch.abs(gx).reshape(B, 3, H - 2, W - 2).mean(1)
    gym = torch.abs(gy).reshape(B, 3, H - 2, W - 2).mean(1)
    edges_normal = F.pad(torch.sqrt(gxm ** 2 + gym ** 2), (1, 1, 1, 1))
    thetas_normal = F.pad(torch.atan2(gym, gxm), (1, 1, 1, 1))
    border = torch.ones(H, W, dtype=torch.bool, device=im.device)
    border[5:-5, 5:-5] = False
    edges_normal = torch.where(border, torch.zeros_like(edges_normal), edges_normal)
    edges_depth, _ = sobel_edges(g[:, 0])
    depth_edge = edges_depth >= 0.1 * edges_depth.flatten(1).max(1).values[:, None, None]
    dil = F.max_pool2d(depth_edge[:, None].float(), 3, 1, 1)[:, 0] > 0
    zero = torch.zeros_like(edges_img)
    return (torch.where(dil, zero, edges_img), thetas_img, torch.where(dil, zero, edges_normal),
            thetas_normal)


def draw_pwn_edge(gen: torch.Generator, gt, rgb, focal_length, n_anchors: int = 3000,
                  mask_value: float = -1e-8):
    """The PWN edge loss's pairs: n edge-guided anchors at the image's edges
    and n at the gt normals' edges (distances 3–19), 3 pairs each, → A, B of
    (B, 6n); and 2n random pairs over valid depth → rA, rB of (B, 2n)."""
    B, _, H, W = gt.shape
    masks = gt > mask_value
    normals_gt = surface_normal_from_depth(gt, focal_length, masks)
    edges_img, thetas_img, edges_normal, thetas_normal = pwn_edge_maps(rgb, normals_gt, gt)
    A1, B1 = draw_edge_pairs(gen, edges_img, thetas_img, n_anchors, 3, 20)
    A2, B2 = draw_edge_pairs(gen, edges_normal, thetas_normal, n_anchors, 3, 20)
    r = masked_sample(masks.reshape(B, -1), _uniform(gen, B, 4 * n_anchors))
    return torch.cat([A1, A2], 1), torch.cat([B1, B2], 1), r[:, 0::2], r[:, 1::2]


def pwn_edge_loss(pred_ss, gt, focal_length, pairs, mask_value=-1e-8, cos_theta1=0.3,
                  cos_theta2=0.95) -> torch.Tensor:
    """EdgeguidedNormalRegressionLoss (PWN_edges.py:104-245) on the pairs of
    ``draw_pwn_edge``: |cos| between the normals of the (scale/shift
    aligned) prediction regressed onto the gt's, over nearly orthogonal and
    nearly parallel gt pairs, plus the random pairs' term. All three terms
    per image (PARITY.md deviation 1). → (B,)."""
    A, Bi, rA, rB = pairs
    masks = gt > mask_value
    n_p = surface_normal_from_depth(pred_ss, focal_length, masks)
    n_g = surface_normal_from_depth(gt, focal_length, masks)
    m_f = masks.flatten(1)
    cons = (m_f.gather(1, A) & m_f.gather(1, Bi)).float()
    t_cos = torch.abs((_gather(n_g, A) * _gather(n_g, Bi)).sum(1))
    i_cos = torch.abs((_gather(n_p, A) * _gather(n_p, Bi)).sum(1))
    m75 = (t_cos < cos_theta1).float() * cons
    m10 = (t_cos > cos_theta2).float() * cons
    l75 = (torch.abs(t_cos - i_cos) * m75).sum(1) / (m75.sum(1) + 1e-8)
    l10 = (torch.abs(t_cos - i_cos) * m10).sum(1) / (m10.sum(1) + 1e-8)
    rt = torch.abs((_gather(n_g, rA) * _gather(n_g, rB)).sum(1))
    ri = torch.abs((_gather(n_p, rA) * _gather(n_p, rB)).sum(1))
    return l75 + l10 + torch.abs(rt - ri).mean(1)


# ---------------------------------------------------------------------------
# PWN planes
# ---------------------------------------------------------------------------


def draw_pwn_planes(gen: torch.Generator, planes, sample_groups: int = 5000,
                    max_planes: int = 8):
    """3·sample_groups pixels uniform over each plane instance 1..max_planes
    of each image. → idx (B, max_planes, 3·sample_groups) and each plane's
    pixel count (B, max_planes)."""
    B = planes.shape[0]
    flat = planes.reshape(B, 1, -1)
    ids = torch.arange(1, max_planes + 1, device=planes.device)[None, :, None]
    masks = flat == ids  # (B, K, P)
    return (masked_sample(masks, _uniform(gen, B, max_planes, 3 * sample_groups)),
            masks.sum(-1))


def pwn_planes_loss(pred, focal_length, draws, sample_groups: int = 5000, delta_cos=0.867,
                    delta_diff=0.007) -> torch.Tensor:
    """PWNPlanesLoss (PWN_planes.py:6-250) on the draws of
    ``draw_pwn_planes``: each group of 3 sampled pixels of a plane gives a
    virtual normal (camera xyz with |depth| in x and y, oriented away from
    its first point); groups that are near-collinear or near-coincident in
    normalized image coordinates, and planes with under 0.6·3·sample_groups
    pixels, are dropped; a plane with under 2 groups left adds nothing, not
    even to the denominator. The loss is each plane's sum of 1 − cos to its
    mean normal, per image, over all images' count of groups (every rank's
    images inside ``parallel.dist.global_batch``). → (B,)."""
    idx, n_valid = draws
    B, K, n = idx.shape
    _, _, H, W = pred.shape
    max_uv = float(W - 1 - W // 2)
    z = pred.reshape(B, -1).gather(1, idx.reshape(B, -1)).reshape(B, K, n)
    f = focal_length.reshape(B, 1, 1)
    i1, i2, i3 = idx[..., 0::3], idx[..., 1::3], idx[..., 2::3]
    z1, z2, z3 = z[..., 0::3], z[..., 1::3], z[..., 2::3]

    def cam(i, zz):
        uu = (i % W).float() - W // 2
        vv = (i // W).float() - H // 2
        return uu, vv, uu * torch.abs(zz) / f, vv * torch.abs(zz) / f

    u1, v1, x1, y1 = cam(i1, z1)
    u2, v2, x2, y2 = cam(i2, z2)
    u3, v3, x3, y3 = cam(i3, z3)
    plane_ok = (n_valid >= 0.6 * (3 * sample_groups))[..., None]
    dx = ((u2 - u1) / max_uv, (u3 - u1) / max_uv, (u3 - u2) / max_uv)
    dy = ((v2 - v1) / max_uv, (v3 - v1) / max_uv, (v3 - v2) / max_uv)
    norms = [torch.sqrt(dx[i] ** 2 + dy[i] ** 2) + 1e-8 for i in range(3)]
    n_bad = 0
    for i in range(3):
        for j in range(3):
            cos_ij = (dx[i] * dx[j] + dy[i] * dy[j]) / (norms[i] * norms[j])
            n_bad = n_bad + ((cos_ij > delta_cos) | (cos_ij < -delta_cos)).int()
    near = ((torch.abs(dx[0]) < delta_diff) | (torch.abs(dx[1]) < delta_diff)
            | (torch.abs(dx[2]) < delta_diff)) & (
        (torch.abs(dy[0]) < delta_diff) | (torch.abs(dy[1]) < delta_diff)
        | (torch.abs(dy[2]) < delta_diff))
    group_ok = ~((n_bad > 3) | near) & plane_ok

    ax, ay, az = x2 - x1, y2 - y1, z2 - z1
    bx, by, bz = x3 - x1, y3 - y1, z3 - z1
    cx = ay * bz - az * by
    cy = az * bx - ax * bz
    cz = ax * by - ay * bx
    inv = torch.rsqrt(cx ** 2 + cy ** 2 + cz ** 2 + 1e-12)
    vx, vy, vz = cx * inv, cy * inv, cz * inv
    flip = vx * x1 + vy * y1 + vz * z1 > 0
    vx, vy, vz = (torch.where(flip, -c, c) for c in (vx, vy, vz))
    w = group_ok.float()
    sx, sy, sz = (vx * w).sum(-1), (vy * w).sum(-1), (vz * w).sum(-1)
    s_inv = torch.rsqrt(sx ** 2 + sy ** 2 + sz ** 2 + 1e-10)
    avx, avy, avz = (c * s_inv for c in (sx, sy, sz))
    cos_diff = torch.where(group_ok, 1.0 - (vx * avx[..., None] + vy * avy[..., None]
                                            + vz * avz[..., None]), 0.0)
    keep = group_ok.sum(-1) >= 2
    losses = torch.where(keep, cos_diff.sum(-1), 0.0).sum(1)
    count = torch.where(keep, w.sum(-1), 0.0).sum()  # from the draws only: no gradient
    ranks = batch_ranks()
    if ranks is not None:
        ranks.sum_([count])
    return losses / (count + 1e-8)


# ---------------------------------------------------------------------------
# scale/shift alignment and the criterion
# ---------------------------------------------------------------------------


def recover_scale_shift_depth(pred, gt, min_threshold=-1e-8, max_threshold=10.1):
    """Per-image closed-form least squares of pred → gt over valid pixels
    (multi_depth_model_auxiv2.py:550-575). The sums and the 2×2 solve run in
    f64: its determinant cancels ~18-fold on a depth map, and in f32 torch's
    separate products and reductions lose more of it than XLA's fused ones
    (a 3e-4 relative gradient error against f64 on a 112×128 map, the JAX
    package's 8e-6)."""
    B = pred.shape[0]
    m = ((gt > min_threshold) & (gt < max_threshold)).double().reshape(B, -1)
    p, g = pred.reshape(B, -1).double(), gt.reshape(B, -1).double()
    a00 = (m * p * p).sum(1) + 1e-6
    a01 = (m * p).sum(1)
    a11 = m.sum(1) + 1e-6
    b0 = (m * p * g).sum(1)
    b1 = (m * g).sum(1)
    det = a00 * a11 - a01 * a01
    safe = torch.where(det != 0, det, torch.ones_like(det))
    scale = ((a11 * b0 - a01 * b1) / safe).to(pred.dtype)
    shift = ((-a01 * b0 + a00 * b1) / safe).to(pred.dtype)
    return pred * scale[:, None, None, None] + shift[:, None, None, None]


def _active(loss_mode: str) -> Dict[str, bool]:
    lm = loss_mode.lower()
    return {"plane": "_pairwise-normal-regress-plane_" in lm,
            "edge": "_pairwise-normal-regress-edge_" in lm,
            "ilnr": "_meanstd-tanh_" in lm,
            "ranking": "_ranking-edge_" in lm,
            "msgil": "_msgil-normal_" in lm}


def draw_criterion(gen: torch.Generator, batch: dict, loss_mode: str) -> dict:
    """Every draw the active sampled losses of ``loss_mode`` need, on the
    generator's device: ``ranking`` (A, B), ``edge`` (A, B, rA, rB),
    ``plane`` (idx, counts)."""
    on = _active(loss_mode)
    draws = {}
    with span("scade.prior.draws"):
        if on["plane"]:
            draws["plane"] = draw_pwn_planes(gen, batch["planes"])
        if on["edge"]:
            draws["edge"] = draw_pwn_edge(gen, batch["depth"], batch["rgb"],
                                          batch["focal_length"])
        if on["ranking"]:
            draws["ranking"] = draw_ranking_edge(gen, batch["depth"], batch["rgb"])
    return draws


def criterion(pred_depth, batch: dict, loss_mode: str, draws: Optional[dict] = None,
              generator: Optional[torch.Generator] = None):
    """ModelLoss.decoder_loss (multi_depth_model_auxiv2.py:209-341): the
    losses whose names ``loss_mode`` holds (as substrings), with PWN edges
    only for quality 3 and ILNR for quality ≥ 2. ``draws`` (or, without
    them, fresh ones from ``generator``) feed the sampled losses. Returns
    (the loss dict: each loss summed over the batch, and ``total_loss``; the
    (B,) per-image totals)."""
    on = _active(loss_mode)
    if draws is None and any(on[k] for k in ("plane", "edge", "ranking")):
        draws = draw_criterion(generator, batch, loss_mode)
    gt = batch["depth"]
    B = gt.shape[0]
    total = torch.zeros(B, device=pred_depth.device)
    loss = {}
    mid_q = (batch["quality_flg"] >= 2).float()
    high_q = (batch["quality_flg"] == 3).float()
    pred_ss = (recover_scale_shift_depth(pred_depth, gt) if on["plane"] or on["edge"]
               else None)
    terms = []
    if on["plane"]:
        terms.append(("pairwise-normal-regress-plane_loss",
                      pwn_planes_loss(pred_ss, batch["focal_length"], draws["plane"])))
    if on["edge"]:
        terms.append(("pairwise-normal-regress-edge_loss",
                      pwn_edge_loss(pred_ss, gt, batch["focal_length"], draws["edge"]) * high_q))
    if on["ilnr"]:
        terms.append(("meanstd-tanh_loss", ilnr_loss(pred_depth, gt) * mid_q))
    if on["ranking"]:
        terms.append(("ranking-edge_loss", ranking_edge_loss(pred_depth, gt, draws["ranking"])))
    if on["msgil"]:
        terms.append(("msg_normal_loss", msgil_loss(pred_depth, gt) * 0.1))
    for name, cur in terms:
        loss[name] = cur.sum()
        total = total + cur
    loss["total_loss"] = (sum(loss.values()) if loss
                          else torch.zeros((), device=pred_depth.device))
    return loss, total


# ---------------------------------------------------------------------------
# the baseline model's auxi (disparity) branch
# ---------------------------------------------------------------------------


def draw_auxi_criterion(gen: torch.Generator, batch: dict, loss_mode: str) -> dict:
    """The draws ``auxi_criterion`` needs: the ranking pairs on the
    disparity, ``ranking`` (A, B), where ``loss_mode`` holds
    ``_ranking-edge-auxi_`` and the batch a ``disp``."""
    if "disp" in batch and "_ranking-edge-auxi_" in loss_mode.lower():
        return {"ranking": draw_ranking_edge(gen, batch["disp"], batch["rgb"])}
    return {}


def auxi_criterion(pred_disp, batch: dict, loss_mode: str, draws: Optional[dict] = None,
                   generator: Optional[torch.Generator] = None, auxi_weight: float = 0.5):
    """ModelLoss.auxi_loss for the disparity branch
    (multi_depth_model_auxiv2.py:229-248): the ``*-auxi_`` losses of
    ``loss_mode`` on the prediction against ``batch["disp"]`` (ranking-edge
    on ``draws``, or fresh ones from ``generator``; MSGIL × 0.5; ILNR), the
    totals scaled by ``auxi_weight`` (LOSS_AUXI_WEIGHT, config.py:99). A
    batch without ``disp`` gives zeros. Returns (the loss dict, the (B,)
    per-image totals)."""
    B = pred_disp.shape[0]
    total = torch.zeros(B, device=pred_disp.device)
    if "disp" not in batch:
        return {"total_loss": torch.zeros((), device=pred_disp.device)}, total
    gt = batch["disp"]
    lm = loss_mode.lower()
    if draws is None and "_ranking-edge-auxi_" in lm:
        draws = draw_auxi_criterion(generator, batch, loss_mode)
    terms = []
    if "_ranking-edge-auxi_" in lm:
        terms.append(("ranking-edge_auxiloss", ranking_edge_loss(pred_disp, gt, draws["ranking"])))
    if "_msgil-normal-auxi_" in lm:
        terms.append(("msg_normal_auxiloss", msgil_loss(pred_disp, gt) * 0.5))
    if "_meanstd-tanh-auxi_" in lm:
        terms.append(("meanstd-tanh_auxiloss", ilnr_loss(pred_disp, gt)))
    loss = {}
    for name, cur in terms:
        loss[name] = cur.sum()
        total = total + cur
    loss["total_loss"] = (sum(loss.values()) * auxi_weight if loss
                          else torch.zeros((), device=pred_disp.device))
    return loss, total * auxi_weight
