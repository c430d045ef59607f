"""The cIMLE prior's five-loss criterion and its random draws, written for
the benchmark from the methods (LeReS, Yin et al., CVPR 2021; its
``ILNR_loss``, ``MSGIL_loss``, ``ranking_loss``, ``PWN_edges``,
``PWN_planes`` and ``Surface_normal``), in the laws the configuration runs
them by: the shipped (0, 1) ground-truth transform of ILNR and MSGIL,
MSGIL's four terms each on the maps halved once, PWN edges' three terms
per image. Imports nothing of the program.

Draws are the configuration's inputs: ``draws`` takes them from a
``torch.Generator`` in a fixed order and law (plane pixels, then the PWN
edge pairs, then the ranking pairs; a uniform u picks the ⌊u·n⌋-th of the
n pixels a mask holds, the last pixel where it holds none), so the same
generator gives the program and this reference the same pairs.

Shapes: prediction and depth (B, 1, H, W), rgb (B, 3, H, W), planes
(B, H, W) with 0 for none, focal_length and quality_flg (B,). A flat pixel
index is ``row·W + col``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

INVALID = -1e-8  # a depth at or below this is missing
N_ANCHORS = 3000
PLANE_GROUPS = 5000
MAX_PLANES = 8


def terms_of(loss_mode: str) -> Dict[str, bool]:
    lm = loss_mode.lower()
    return {"plane": "_pairwise-normal-regress-plane_" in lm,
            "edge": "_pairwise-normal-regress-edge_" in lm,
            "ilnr": "_meanstd-tanh_" in lm,
            "ranking": "_ranking-edge_" in lm,
            "msgil": "_msgil-normal_" in lm}


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


def pick(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """mask (..., P) bool, u (..., n) in [0, 1) → (..., n) flat indices: the
    ⌊u·max(count, 1)⌋-th pixel where the mask holds, or P − 1 past the last."""
    P = mask.shape[-1]
    m, uu = mask.reshape(-1, P), u.reshape(-1, u.shape[-1])
    out = torch.full(uu.shape, P - 1, dtype=torch.long, device=u.device)
    for r in range(m.shape[0]):
        where = m[r].nonzero().squeeze(1)
        count = where.numel()
        k = (uu[r] * float(max(count, 1))).floor().long()
        ok = k < count
        if count:
            out[r] = torch.where(ok, where[k.clamp(max=count - 1)], out[r])
    return out.reshape(u.shape)


def sobel(img: torch.Tensor):
    """(N, H, W) → the Sobel magnitude and direction, zero on the border."""
    k = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                     device=img.device, dtype=img.dtype)
    g = F.conv2d(img[:, None], torch.stack([k, k.t()])[:, None])
    gx, gy = g[:, 0], -g[:, 1]  # the y kernel is [1, 2, 1] over [-1, -2, -1]
    mag = torch.sqrt(gx ** 2 + gy ** 2)
    return F.pad(mag, (1, 1, 1, 1)), F.pad(torch.atan2(gy, gx), (1, 1, 1, 1))


def guided_pairs(gen, edges, theta, lo: int, hi: int):
    """Anchors uniform over the pixels whose edge is at least a tenth of the
    image's strongest, each with four points along its gradient's direction
    (|cos|, |sin|) at distances drawn in [lo, hi): two behind, two ahead,
    joined in three pairs. → A, B (N, 3·N_ANCHORS), grouped by pair."""
    N, H, W = edges.shape
    e = edges.reshape(N, -1)
    anchor = pick(e >= 0.1 * e.max(1, keepdim=True).values,
                  torch.rand((N, N_ANCHORS), generator=gen, device=gen.device))
    dist = torch.randint(lo, hi, (N, 4, N_ANCHORS), generator=gen, device=gen.device)
    t = theta.reshape(N, -1).gather(1, anchor)[:, None]
    signed = dist.float() * torch.tensor([-1.0, -1.0, 1.0, 1.0], device=dist.device)[:, None]
    rows = (anchor // W)[:, None] + torch.round(signed * t.sin().abs()).long()
    cols = (anchor % W)[:, None] + torch.round(signed * t.cos().abs()).long()
    pts = rows.clamp(0, H - 1) * W + cols.clamp(0, W - 1)
    return (torch.cat([pts[:, 0], pts[:, 1], pts[:, 2]], 1),
            torch.cat([pts[:, 1], pts[:, 2], pts[:, 3]], 1))


def random_pairs(gen, valid: torch.Tensor, n: int):
    """n pairs of pixels uniform over ``valid`` (N, P): draws 2n, pairs
    them in turn."""
    idx = pick(valid, torch.rand((valid.shape[0], 2 * n), generator=gen, device=gen.device))
    return idx[:, 0::2], idx[:, 1::2]


def draws(gen: torch.Generator, batch: dict, loss_mode: str) -> dict:
    """Every draw the configuration's sampled losses need."""
    on, out = terms_of(loss_mode), {}
    gt, rgb = batch["depth"], batch["rgb"]
    B = gt.shape[0]
    valid = (gt > INVALID).reshape(B, -1)
    if on["plane"]:
        planes = batch["planes"].reshape(B, 1, -1)
        masks = planes == torch.arange(1, MAX_PLANES + 1, device=planes.device)[:, None]
        u = torch.rand((B, MAX_PLANES, 3 * PLANE_GROUPS), generator=gen, device=gen.device)
        out["plane"] = (pick(masks, u), masks.sum(-1))
    if on["edge"]:
        e_img, t_img, e_nrm, t_nrm = pwn_edge_maps(rgb, gt, batch["focal_length"])
        a1, b1 = guided_pairs(gen, e_img, t_img, 3, 20)
        a2, b2 = guided_pairs(gen, e_nrm, t_nrm, 3, 20)
        ra, rb = random_pairs(gen, valid, 2 * N_ANCHORS)
        out["edge"] = (torch.cat([a1, a2], 1), torch.cat([b1, b2], 1), ra, rb)
    if on["ranking"]:
        e, t = sobel(rgb[:, 0])
        a, b = guided_pairs(gen, e, t, 2, 31)
        ra, rb = random_pairs(gen, valid, N_ANCHORS)
        out["ranking"] = (torch.cat([a, ra], 1), torch.cat([b, rb], 1))
    return out


def at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) at flat indices idx (B, n) → (B, C, n)."""
    flat = x.flatten(2)
    return torch.gather(flat, 2, idx.unsqueeze(1).expand(-1, flat.shape[1], -1))


# ---------------------------------------------------------------------------
# surface normals
# ---------------------------------------------------------------------------


def unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt((v * v).sum(1, keepdim=True) + 1e-12)


def normals(depth: torch.Tensor, focal: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Unit normals (B, 3, H, W) of the points the depth, twice smoothed by a
    3×3 mean, puts in the camera's frame: the mean of two crosses of
    differences along x and y (from 2 pixels behind to 2 ahead, and from 1
    behind to 2 ahead), each turned to face the camera; zero where
    ``valid`` is false."""
    B, _, H, W = depth.shape
    d = F.avg_pool2d(F.avg_pool2d(depth, 3, 1, 1), 3, 1, 1)
    u = torch.arange(W, device=depth.device, dtype=depth.dtype) - W / 2.0
    v = torch.arange(H, device=depth.device, dtype=depth.dtype) - H / 2.0
    f = focal.reshape(B, 1, 1, 1)
    xyz = torch.cat([u.view(1, 1, 1, W) * d / f, v.view(1, 1, H, 1) * d / f, d], 1)
    p = F.pad(xyz, (2, 2, 2, 2))

    def shift(dy, dx):
        return p[:, :, 2 + dy:2 + dy + H, 2 + dx:2 + dx + W]

    def facing(n):
        return torch.where((n * xyz).sum(1, keepdim=True) > 0, -n, n)

    wide = torch.cross(shift(0, -2) - shift(0, 2), shift(-2, 0) - shift(2, 0), dim=1)
    near = torch.cross(shift(0, -1) - shift(0, 2), shift(-1, 0) - shift(2, 0), dim=1)
    n = facing(unit(facing(unit(near)) + facing(unit(wide))))
    return torch.where(valid, n, 0.0)


def pwn_edge_maps(rgb, gt, focal):
    """The PWN edge loss's guides: the red channel's Sobel edges, and the
    ground-truth normals' (the channel mean of |Sobel| per direction, none
    within 5 pixels of the border), both cleared on the ground-truth depth's
    strong edges dilated by one pixel."""
    B, _, H, W = gt.shape
    e_img, t_img = sobel(rgb[:, 0])
    n = normals(gt, focal, gt > INVALID)
    k = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=gt.device)
    g = F.conv2d(n.reshape(B * 3, 1, H, W), torch.stack([k, k.t()])[:, None]).abs()
    gx = g[:, 0].reshape(B, 3, H - 2, W - 2).mean(1)
    gy = g[:, 1].reshape(B, 3, H - 2, W - 2).mean(1)
    e_nrm = F.pad(torch.sqrt(gx ** 2 + gy ** 2), (1, 1, 1, 1))
    t_nrm = F.pad(torch.atan2(gy, gx), (1, 1, 1, 1))
    inner = torch.zeros(H, W, dtype=torch.bool, device=gt.device)
    inner[5:H - 5, 5:W - 5] = True
    e_nrm = e_nrm * inner
    e_d, _ = sobel(gt[:, 0])
    strong = (e_d >= 0.1 * e_d.flatten(1).max(1).values.view(B, 1, 1)).float()
    near_edge = F.max_pool2d(strong[:, None], 3, 1, 1)[:, 0] > 0
    return e_img.masked_fill(near_edge, 0.0), t_img, e_nrm.masked_fill(near_edge, 0.0), t_nrm


# ---------------------------------------------------------------------------
# the losses, each (B,)
# ---------------------------------------------------------------------------


def masked_mean(x, m):
    return (x * m).sum(1) / m.sum(1).clamp(min=1.0)


def ilnr(pred, gt):
    """Image-level normalized regression, shipped transform (0, 1): mean
    |gt − pred| plus mean |tanh(gt/100) − tanh(pred/100)| over valid
    pixels; 0 for an image with 100 valid pixels or fewer."""
    B = pred.shape[0]
    p, g = pred.reshape(B, -1), gt.reshape(B, -1)
    m = ((g > INVALID) & (g < 1e8)).float()
    loss = masked_mean((g - p).abs(), m) + masked_mean(
        (torch.tanh(0.01 * g) - torch.tanh(0.01 * p)).abs(), m)
    return torch.where(m.sum(1) > 100, loss, 0.0)


def msgil(pred, gt, scales: int = 4):
    """Multi-scale gradient matching: |Δ₂(pred − gt)| along rows and columns
    where both ends are valid, mean over the map, over the mean of the valid
    pairs; each of the ``scales`` terms on the maps halved once."""
    B = pred.shape[0]
    d = (pred - gt)[:, 0, ::2, ::2]
    m = (gt > INVALID)[:, 0, ::2, ::2].to(pred.dtype)
    mv, mh = m[:, 2:] * m[:, :-2], m[:, :, 2:] * m[:, :, :-2]
    gv = (d[:, 2:] - d[:, :-2]).abs() * mv
    gh = (d[:, :, 2:] - d[:, :, :-2]).abs() * mh

    def mean(x):
        return x.reshape(B, -1).mean(1)

    one = (mean(gh) + mean(gv)) / (mean(mh) + mean(mv) + 1e-8)
    total = torch.zeros_like(one)
    for _ in range(scales):
        total = total + one
    return total


def ranking(pred, gt, pairs, sigma: float = 0.03):
    """Edge-guided ranking: a squared gap for pairs whose depths agree within
    1 + sigma, a logistic ranking loss for the others; pairs with a missing
    depth count as zero in both means."""
    a, b = pairs
    B = pred.shape[0]
    p, g = pred.reshape(B, -1), gt.reshape(B, -1)
    pa, pb, ga, gb = p.gather(1, a), p.gather(1, b), g.gather(1, a), g.gather(1, b)
    both = ((ga > INVALID) & (gb > INVALID)).float()
    r = (ga + 1e-6) / (gb + 1e-6)
    farther, nearer = r >= 1.0 + sigma, r <= 1.0 / (1.0 + sigma)
    equal = ((r < 1.0 + sigma) & (r > 1.0 / (1.0 + sigma))).float()
    label = farther.float() - nearer.float()
    eq_loss = (pa - pb) ** 2 * equal * both
    rank_loss = F.softplus(label * (pb - pa)) * (1.0 - equal) * both
    return eq_loss.mean(1) + rank_loss.mean(1)


def pwn_edge(pred_ss, gt, focal, pairs, lo: float = 0.3, hi: float = 0.95):
    """Pair-wise normal regression at edges: |cos| between two pixels'
    normals, predicted against true, over near-orthogonal (true |cos| <
    ``lo``) and near-parallel (> ``hi``) guided pairs, each a mean, plus the
    mean over the random pairs."""
    a, b, ra, rb = pairs
    valid = gt > INVALID
    n_p, n_g = normals(pred_ss, focal, valid), normals(gt, focal, valid)
    vf = valid.flatten(1)
    both = (vf.gather(1, a) & vf.gather(1, b)).float()

    def cos(n, i, j):
        return (at(n, i) * at(n, j)).sum(1).abs()

    t, p = cos(n_g, a, b), cos(n_p, a, b)
    gap = (t - p).abs()
    out = 0.0
    for sel in ((t < lo).float() * both, (t > hi).float() * both):
        out = out + (gap * sel).sum(1) / (sel.sum(1) + 1e-8)
    return out + (cos(n_g, ra, rb) - cos(n_p, ra, rb)).abs().mean(1)


def pwn_planes(pred_ss, focal, draw, delta_cos: float = 0.867, delta_diff: float = 0.007):
    """Pair-wise normals on planes: each group of three pixels drawn on a
    plane gives a virtual normal (camera points with |depth|, turned away
    from its first point); groups whose image offsets are near-collinear or
    near-coincident, and planes under 0.6 of the pixels drawn, are dropped;
    a plane keeps its groups' sum of 1 − cos to their mean normal where it
    has two groups or more. The sum over a batch's planes, per image, over
    all its kept groups."""
    idx, count = draw
    B, K, n = idx.shape
    _, _, H, W = pred_ss.shape
    depth = pred_ss.reshape(B, -1).gather(1, idx.reshape(B, -1)).reshape(B, K, n // 3, 3)
    idx = idx.reshape(B, K, n // 3, 3)
    u = (idx % W).float() - W // 2
    v = (idx // W).float() - H // 2
    f = focal.view(B, 1, 1, 1)
    pts = torch.stack([u * depth.abs() / f, v * depth.abs() / f, depth], -1)  # (B,K,G,3,3)
    scale = float(W - 1 - W // 2)
    uv = torch.stack([u, v], -1)
    offs = torch.stack([uv[..., 1, :] - uv[..., 0, :], uv[..., 2, :] - uv[..., 0, :],
                        uv[..., 2, :] - uv[..., 1, :]], -2) / scale  # (B, K, G, 3, 2)
    length = offs.norm(dim=-1) + 1e-8
    cosm = (offs[..., :, None, :] * offs[..., None, :, :]).sum(-1) / (
        length[..., :, None] * length[..., None, :])
    collinear = (cosm.abs() > delta_cos).sum((-1, -2)) > 3
    close = (offs.abs() < delta_diff).any(-2)  # per axis, any of the three offsets
    ok = ~(collinear | (close[..., 0] & close[..., 1]))
    ok = ok & (count >= 0.6 * 3 * PLANE_GROUPS)[..., None]
    nrm = torch.cross(pts[..., 1, :] - pts[..., 0, :], pts[..., 2, :] - pts[..., 0, :], dim=-1)
    nrm = nrm / torch.sqrt((nrm * nrm).sum(-1, keepdim=True) + 1e-12)
    nrm = torch.where((nrm * pts[..., 0, :]).sum(-1, keepdim=True) > 0, -nrm, nrm)
    w = ok.float()[..., None]
    mean = (nrm * w).sum(2)
    mean = mean / torch.sqrt((mean * mean).sum(-1, keepdim=True) + 1e-10)
    off_mean = (1.0 - (nrm * mean[:, :, None]).sum(-1)) * ok.float()
    kept = ok.sum(-1) >= 2
    per_image = (off_mean.sum(-1) * kept).sum(1)
    return per_image / ((ok.sum(-1) * kept).sum() + 1e-8)


def align(pred, gt, hi: float = 10.1):
    """pred·s + t with (s, t) the per-image least-squares fit to the valid
    ground truth (a 1e-6 ridge on the diagonal), solved in float64."""
    B = pred.shape[0]
    p, g = pred.reshape(B, -1).double(), gt.reshape(B, -1).double()
    m = ((g > INVALID) & (g < hi)).double()
    a = torch.stack([torch.stack([(m * p * p).sum(1) + 1e-6, (m * p).sum(1)], -1),
                     torch.stack([(m * p).sum(1), m.sum(1) + 1e-6], -1)], -2)
    rhs = torch.stack([(m * p * g).sum(1), (m * g).sum(1)], -1)
    st = torch.linalg.solve(a, rhs).to(pred.dtype)
    return pred * st[:, 0].view(B, 1, 1, 1) + st[:, 1].view(B, 1, 1, 1)


def criterion(pred, batch: dict, loss_mode: str, drawn: dict) -> torch.Tensor:
    """The per-image total (B,) of the losses ``loss_mode`` names: PWN planes,
    PWN edges (images of quality 3), ILNR (quality 2 or more), ranking,
    0.1 × MSGIL."""
    on = terms_of(loss_mode)
    gt, focal, q = batch["depth"], batch["focal_length"], batch["quality_flg"]
    total = torch.zeros(pred.shape[0], device=pred.device)
    aligned = align(pred, gt) if on["plane"] or on["edge"] else None
    if on["plane"]:
        total = total + pwn_planes(aligned, focal, drawn["plane"])
    if on["edge"]:
        total = total + pwn_edge(aligned, gt, focal, drawn["edge"]) * (q == 3).float()
    if on["ilnr"]:
        total = total + ilnr(pred, gt) * (q >= 2).float()
    if on["ranking"]:
        total = total + ranking(pred, gt, drawn["ranking"])
    if on["msgil"]:
        total = total + 0.1 * msgil(pred, gt)
    return total

