"""SPVCNN point-cloud classifier (sparse point-voxel CNN) in PyTorch.

Counterpart of ``scade_tpu/prior/spvcnn.py``, with the same names. Reference:
ambiguity_aware_prior/lib/spvcnn_classsification.py (SPVCNN_CLASSIFICATION
and its blocks), lib/spvcnn_utils.py (initial_voxelize, point_to_voxel,
voxel_to_point) and lib/test_utils.py (the depth → point cloud → sparse
tensor input functions, refine_focal and refine_shift). Upstream it is dead code
that needs torchsparse's CUDA hash maps; here, as in the JAX package:

- a sparse voxel or point set is ``(feats (N, C), coords (N, 4) [x, y, z,
  batch], mask (N,))`` padded to a fixed capacity; masked rows contribute
  nothing;
- kernel maps come from exact key matching, not hashing: coords pack into
  one int64 key, (b, z, y, x) in 16+15+15+15 bits, ordered as the JAX
  package's two int32 keys are, and the queries of all offsets find their
  table rows at once by ``torch.sort`` + ``torch.searchsorted``
  (``kernel_map``; the JAX package's lexsort and cummax merge-join, an
  offset at a time);
- a sparse conv is, per kernel offset, a gather of the matched input rows
  and a product with that offset's (Cin, Cout) weight (``torch.matmul``),
  over the matches alone (the JAX package's static shapes multiply the
  misses' zero rows too);
- BatchNorm and global average pooling run over the valid rows.

Coordinate contract: |c| < 2**14 and batch < 2**16; coords outside are
clipped by the key packing.

On a CUDA card ``index_add_`` sums in no fixed order, so ``_segment_mean``
and the pools it serves differ from the CPU's in the last bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


class SparseVoxels(NamedTuple):
    """Fixed-capacity sparse voxel set at integer tensor stride ``stride``."""

    feats: torch.Tensor  # (N, C) float
    coords: torch.Tensor  # (N, 4) int32: x, y, z, batch; multiples of stride
    mask: torch.Tensor  # (N,) bool
    stride: int = 1  # torchsparse SparseTensor.s


class SparsePoints(NamedTuple):
    """Fixed-capacity point set with float voxel-frame coordinates
    (torchsparse PointTensor: spvcnn_classsification.py:138)."""

    feats: torch.Tensor  # (N, C) float
    fcoords: torch.Tensor  # (N, 4) float: x, y, z, batch
    mask: torch.Tensor  # (N,) bool

    def to(self, device) -> "SparsePoints":
        return SparsePoints(*(t.to(device) for t in self))


# ---------------------------------------------------------------------------
# key packing and matching (the torchsparse sphash/sphashquery replacement)
# ---------------------------------------------------------------------------

_COORD_BIAS = 1 << 14  # coords clipped to [-2^14, 2^14)
_INVALID_KEY = 1 << 62  # above every valid key (< 2^61)


def _pack_keys(coords: torch.Tensor) -> torch.Tensor:
    """(N, 4) int [x, y, z, b] → (N,) int64 keys, ordered as (b, z, y, x)
    lexicographically: b in 16 bits, each clipped coord in 15."""
    c = coords.long()
    xyz = c[:, :3].clamp(-_COORD_BIAS, _COORD_BIAS - 1) + _COORD_BIAS
    return ((c[:, 3] * (1 << 15) + xyz[:, 2]) * (1 << 15) + xyz[:, 1]) * (1 << 15) + xyz[:, 0]


def _masked_keys(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Keys with the invalid rows' above every valid one (they sort last)."""
    return torch.where(mask, _pack_keys(coords), torch.full_like(mask, _INVALID_KEY,
                                                                  dtype=torch.long))


def kernel_map(table: torch.Tensor, table_mask: torch.Tensor, query: torch.Tensor,
               query_mask: torch.Tensor, offsets: np.ndarray) -> torch.Tensor:
    """(K, M) int64: for each of the K (x, y, z) ``offsets`` and each query
    coord, the index of the coord ``query + offset`` in ``table`` (-1 if
    absent, or where either side is masked), all offsets in one search: the
    table's keys sorted once (stably), every query key looked up by
    ``searchsorted``. Valid table coords are assumed unique (voxel sites
    are); among equal ones the last in the stable order wins, as the JAX
    merge-join's cummax picks it."""
    keys, perm = torch.sort(_masked_keys(table, table_mask), stable=True)
    shift = torch.zeros((len(offsets), 1, 4), dtype=query.dtype)
    shift[:, 0, :3] = torch.as_tensor(np.asarray(offsets), dtype=query.dtype)
    q = _pack_keys((query[None] + shift.to(query.device)).reshape(-1, 4))
    pos = torch.searchsorted(keys, q, right=True) - 1
    cand = pos.clamp(min=0)
    hit = (pos >= 0) & (keys[cand] == q) & query_mask.repeat(len(offsets))
    return torch.where(hit, perm[cand], torch.full_like(cand, -1)).view(len(offsets), -1)


def sparse_match(table: torch.Tensor, table_mask: torch.Tensor,
                 query: torch.Tensor, query_mask: torch.Tensor) -> torch.Tensor:
    """For each query coord, the index of the equal coord in ``table`` (-1
    if absent or masked): torchsparse's sphashquery (spvcnn_utils.py:18,48,78),
    the kernel map of the zero offset."""
    return kernel_map(table, table_mask, query, query_mask, np.zeros((1, 3), np.int32))[0]


def sparse_unique(coords: torch.Tensor, mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate valid coords (torch.unique in initial_voxelize,
    spvcnn_utils.py:17). Returns (unique coords (N, 4) compacted to the
    front in (b, z, y, x) order, their mask, inverse (N,) mapping each input
    row to its unique slot (-1 for invalid rows), counts (N,) per slot)."""
    n = coords.shape[0]
    keys, perm = torch.sort(_masked_keys(coords, mask), stable=True)
    s_valid = mask[perm]
    first = torch.ones_like(s_valid)
    first[1:] = keys[1:] != keys[:-1]
    first &= s_valid
    gid = torch.cumsum(first.long(), 0) - 1
    n_unique = int(first.sum())
    ucoords = torch.zeros_like(coords)
    ucoords[gid[first]] = coords[perm[first]]
    umask = torch.arange(n, device=coords.device) < n_unique
    inverse = torch.empty_like(gid)
    inverse[perm] = torch.where(s_valid, gid, torch.full_like(gid, -1))
    counts = torch.zeros_like(gid)
    counts.index_add_(0, inverse[mask], torch.ones_like(inverse[mask]))
    return ucoords, umask, inverse, counts


def _segment_mean(feats: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Masked scatter-mean (torchsparse spvoxelize: grouped sum / counts,
    spvcnn_utils.py:20-26,56); rows outside [0, num_segments) are dropped."""
    keep = mask & (seg >= 0) & (seg < num_segments)
    seg = torch.where(keep, seg.long(), torch.full_like(seg, num_segments, dtype=torch.long))
    w = keep.to(feats.dtype)
    total = feats.new_zeros((num_segments + 1, feats.shape[1]))
    total.index_add_(0, seg, feats * w[:, None])
    cnt = feats.new_zeros((num_segments + 1,))
    cnt.index_add_(0, seg, w)
    return total[:num_segments] / cnt[:num_segments, None].clamp(min=1.0)


# ---------------------------------------------------------------------------
# sparse conv (torchsparse spnn.Conv3d semantics)
# ---------------------------------------------------------------------------


def _kernel_offsets(ks: int, stride_units: int) -> np.ndarray:
    """torchsparse KernelRegion offsets at tensor stride s: odd kernels
    centred ({-s..s} for ks=3), even ones corner-aligned ({0, s} for ks=2).
    Order: x fastest, ``meshgrid(r, r, r, indexing='ij')`` over (z, y, x),
    the JAX package's order, which the (ks³, Cin, Cout) weights index."""
    if ks % 2:
        r = np.arange(-(ks // 2), ks // 2 + 1) * stride_units
    else:
        r = np.arange(ks) * stride_units
    zz, yy, xx = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.int32)


def _sparse_products(feats: torch.Tensor, kmap: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Σ_k feats[kmap[k]] @ weight[k] for each output row, the offsets in
    order, over the hits alone (a miss adds a zero row's product, exactly 0,
    in the JAX package's static-shape form). One host sync for the hits'
    counts; each offset's rows are distinct, so ``index_add_`` adds each
    once, deterministically on the card too."""
    acc = feats.new_zeros((kmap.shape[1], weight.shape[-1]))
    offset_of, rows = (kmap >= 0).nonzero(as_tuple=True)
    counts = torch.bincount(offset_of, minlength=kmap.shape[0]).tolist()
    for k, r in enumerate(rows.split(counts)):
        if len(r):
            acc.index_add_(0, r, feats[kmap[k, r]] @ weight[k])
    return acc


def sparse_conv3d(x: SparseVoxels, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  ks: int = 3, stride: int = 1) -> SparseVoxels:
    """spnn.Conv3d (spvcnn_classsification.py:14-18); ``weight`` is
    (ks**3, Cin, Cout). Stride 1: outputs on the input sites. Stride > 1:
    outputs on the unique downsampled sites floor(c / (s*stride)) *
    (s*stride), at tensor stride s*stride (torchsparse's rule)."""
    s = x.stride
    if stride == 1:
        out_coords, out_mask, out_stride = x.coords, x.mask, s
    else:
        new_s = s * stride
        down = torch.cat([torch.div(x.coords[:, :3], new_s, rounding_mode="floor") * new_s,
                          x.coords[:, 3:]], dim=1)
        out_coords, out_mask, _, _ = sparse_unique(down, x.mask)
        out_stride = new_s
    kmap = kernel_map(x.coords, x.mask, out_coords, out_mask, _kernel_offsets(ks, s))
    acc = _sparse_products(x.feats, kmap, weight)
    if bias is not None:
        acc = acc + bias
    acc = torch.where(out_mask[:, None], acc, 0.0)
    return SparseVoxels(acc, out_coords, out_mask, out_stride)


def sparse_conv3d_transpose(x: SparseVoxels, weight: torch.Tensor, out_sites: SparseVoxels,
                            ks: int = 3) -> SparseVoxels:
    """spnn.Conv3d(transpose=True) (BasicDeconvolutionBlock,
    spvcnn_classsification.py:27-40; unused by the classifier): upsample
    onto finer sites seen before. out[p] receives W[o] · in[p - o] for the
    offsets o at the output stride; a query off the input stride finds no
    match."""
    so = out_sites.stride
    kmap = kernel_map(x.coords, x.mask, out_sites.coords, out_sites.mask,
                      -_kernel_offsets(ks, so))
    acc = _sparse_products(x.feats, kmap, weight)
    acc = torch.where(out_sites.mask[:, None], acc, 0.0)
    return SparseVoxels(acc, out_sites.coords, out_sites.mask, so)


def batch_norm_masked(feats: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, mean: Optional[torch.Tensor] = None,
                      var: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """spnn.BatchNorm over the valid rows. With (mean, var), inference-mode
    normalization by them; without, the batch's mean and biased variance
    over the valid rows (training), which update no running statistics."""
    if mean is None:
        w = mask[:, None].to(feats.dtype)
        n = w.sum().clamp(min=1.0)
        mean = (feats * w).sum(0) / n
        var = ((feats - mean) ** 2 * w).sum(0) / n
    y = (feats - mean) * torch.rsqrt(var + eps) * scale + bias
    return torch.where(mask[:, None], y, 0.0)


def global_avg_pool(x: SparseVoxels, num_batches: int) -> torch.Tensor:
    """spnn.GlobalAveragePooling (spvcnn_classsification.py:117): the mean
    over each sample's valid sites → (B, C)."""
    return _segment_mean(x.feats, x.coords[:, 3], x.mask, num_batches)


# ---------------------------------------------------------------------------
# point ↔ voxel (spvcnn_utils.py)
# ---------------------------------------------------------------------------


def _batch_col(fcoords: torch.Tensor) -> torch.Tensor:
    return fcoords[:, 3].to(torch.int32)[:, None]


def initial_voxelize(z: SparsePoints, init_res: float, after_res: float
                     ) -> Tuple[SparseVoxels, SparsePoints]:
    """spvcnn_utils.py:12-33: float coords scaled by init_res / after_res,
    point features mean-pooled into their floor voxels (stride 1). Returns
    the voxels and the points with the scaled coords (the reference mutates
    z.C in place)."""
    n = z.fcoords.shape[0]
    new_float = torch.cat([z.fcoords[:, :3] * (init_res / after_res), z.fcoords[:, 3:]], dim=1)
    vox = torch.cat([torch.floor(new_float[:, :3]).to(torch.int32), _batch_col(new_float)], dim=1)
    ucoords, umask, inverse, _ = sparse_unique(vox, z.mask)
    feats = _segment_mean(z.feats, inverse, z.mask, n)
    feats = torch.where(umask[:, None], feats, 0.0)
    return SparseVoxels(feats, ucoords, umask, 1), SparsePoints(z.feats, new_float, z.mask)


def point_to_voxel(x: SparseVoxels, z: SparsePoints) -> SparseVoxels:
    """spvcnn_utils.py:37-61: point features mean-pooled onto x's sites
    (points whose voxel x lacks are dropped)."""
    s = x.stride
    pvox = torch.cat([torch.floor(z.fcoords[:, :3] / s).to(torch.int32) * s,
                      _batch_col(z.fcoords)], dim=1)
    idx = sparse_match(x.coords, x.mask, pvox, z.mask)
    feats = _segment_mean(z.feats, idx, z.mask & (idx >= 0), x.coords.shape[0])
    feats = torch.where(x.mask[:, None], feats, 0.0)
    return SparseVoxels(feats, x.coords, x.mask, s)


def voxel_to_point(x: SparseVoxels, z: SparsePoints, nearest: bool = False) -> SparsePoints:
    """spvcnn_utils.py:65-103: x's features interpolated trilinearly (the 8
    corners of KernelRegion(2, s)) at z's float positions; an absent corner
    gets weight 0 and the rest are not renormalized. ``nearest=True`` drops
    the 7 non-floor corners but keeps the floor corner's trilinear weight
    (the reference's lines 84-86, a shipped quirk kept)."""
    s = x.stride
    scaled = z.fcoords[:, :3] / s
    base = torch.floor(scaled)
    frac = scaled - base
    corners = _kernel_offsets(2, 1)[:1 if nearest else 8]  # {0, 1}³, x fastest; floor first
    floor_q = torch.cat([base.to(torch.int32) * s, _batch_col(z.fcoords)], dim=1)
    kmap = kernel_map(x.coords, x.mask, floor_q, z.mask, corners * s)
    feats = x.feats.new_zeros((z.fcoords.shape[0], x.feats.shape[1]))
    for off, idx in zip(corners, kmap):
        upper = torch.as_tensor(off > 0, device=frac.device)
        w = torch.prod(torch.where(upper, frac, 1.0 - frac), dim=1)
        hit = idx >= 0
        f = torch.where(hit[:, None], x.feats[idx.clamp(min=0)], 0.0)
        feats = feats + f * torch.where(hit, w, 0.0)[:, None]
    return SparsePoints(feats, z.fcoords, z.mask)


# ---------------------------------------------------------------------------
# the classifier (spvcnn_classsification.py:74-158)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SPVCNNConfig:
    """SPVCNN_CLASSIFICATION kwargs (spvcnn_classsification.py:75-84)."""

    input_channel: int = 3
    num_classes: int = 1
    cr: float = 1.0
    pres: float = 1.0
    vres: float = 1.0

    @property
    def cs(self) -> Sequence[int]:
        return [int(self.cr * c) for c in (32, 32, 64, 128, 256, 256, 128, 96, 96)]


class MaskedBatchNorm(nn.Module):
    """spnn.BatchNorm's parameters and statistics (γ=1, β=0, mean 0, var 1:
    spvcnn_classsification.py:130-134), applied by ``batch_norm_masked``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, feats, mask, train: bool):
        if train:
            return batch_norm_masked(feats, mask, self.weight, self.bias)
        return batch_norm_masked(feats, mask, self.weight, self.bias, self.running_mean,
                                 self.running_var)


class ConvBN(nn.Module):
    """BasicConvolutionBlock's weights (spvcnn_classsification.py:10-24): a
    (ks³, Cin, Cout) sparse conv weight ``w`` and its BatchNorm."""

    def __init__(self, ks: int, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(ks ** 3, cin, cout))
        self.bn = MaskedBatchNorm(cout)

    def block(self, x: SparseVoxels, ks: int, stride: int, train: bool) -> SparseVoxels:
        """conv → BN → ReLU."""
        y = sparse_conv3d(x, self.w, ks=ks, stride=stride)
        return y._replace(feats=torch.relu(self.bn(y.feats, y.mask, train)))

    def deconv_block(self, x: SparseVoxels, out_sites: SparseVoxels, ks: int,
                     train: bool) -> SparseVoxels:
        """BasicDeconvolutionBlock (spvcnn_classsification.py:27-40):
        transpose conv → BN → ReLU. Unused by the classifier, as in the
        reference."""
        y = sparse_conv3d_transpose(x, self.w, out_sites, ks=ks)
        return y._replace(feats=torch.relu(self.bn(y.feats, y.mask, train)))


class ResidualBlock(nn.Module):
    """ResidualBlock (spvcnn_classsification.py:43-71), stride 1."""

    def __init__(self, cin: int, cout: int, ks: int = 3):
        super().__init__()
        self.conv1 = ConvBN(ks, cin, cout)
        self.conv2 = ConvBN(ks, cout, cout)
        self.down = ConvBN(1, cin, cout) if cin != cout else None

    def forward(self, x: SparseVoxels, train: bool) -> SparseVoxels:
        y = sparse_conv3d(x, self.conv1.w, ks=3)
        f = torch.relu(self.conv1.bn(y.feats, y.mask, train))
        y = sparse_conv3d(y._replace(feats=f), self.conv2.w, ks=3)
        f = self.conv2.bn(y.feats, y.mask, train)
        if self.down is not None:
            d = sparse_conv3d(x, self.down.w, ks=1)
            fd = self.down.bn(d.feats, d.mask, train)
        else:
            fd = x.feats
        return y._replace(feats=torch.relu(f + fd))


class Stage(nn.Module):
    """A ks=2, stride-2 conv block, then two residual blocks."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.down = ConvBN(2, cin, cin)
        self.res1 = ResidualBlock(cin, cout)
        self.res2 = ResidualBlock(cout, cout)

    def forward(self, x: SparseVoxels, train: bool) -> SparseVoxels:
        x = self.down.block(x, ks=2, stride=2, train=train)
        return self.res2(self.res1(x, train), train)


class Stem(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv1 = ConvBN(3, cin, c)
        self.conv2 = ConvBN(3, c, c)


class PointTransform(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.lin = nn.Linear(cin, cout)
        self.bn = MaskedBatchNorm(cout)


class SPVCNN(nn.Module):
    """SPVCNN_CLASSIFICATION, the layout of spvcnn_classsification.py:86-128
    (stem, stage1-4, point_transform, classifier); ``forward`` is the JAX
    package's ``spvcnn_apply``."""

    def __init__(self, cfg: SPVCNNConfig):
        super().__init__()
        self.cfg = cfg
        cs = cfg.cs
        self.stem = Stem(cfg.input_channel, cs[0])
        for i, (cin, cout) in enumerate(((cs[0], cs[1]), (cs[1], cs[2]), (cs[2], cs[3]),
                                         (cs[3], cs[4])), start=1):
            setattr(self, f"stage{i}", Stage(cin, cout))
        self.classifier = nn.Linear(cs[4], cfg.num_classes)
        self.point_transform = PointTransform(cs[0], cs[4])

    def forward(self, points: SparsePoints, num_batches: int = 1,
                train: bool = False) -> torch.Tensor:
        """(num_batches, num_classes) logits (spvcnn_classsification.py:136-158).
        ``train``: BatchNorm on the batch's statistics (no running update);
        else on the running ones. The reference's quirks are kept: z0's
        point features feed only the final point-transform skip (line 152),
        its Dropout(0.3) is never applied (line 128), and the voxel stages
        never see point features after the stem's re-voxelization (line 146)."""
        cfg = self.cfg
        x0, z = initial_voxelize(points, cfg.pres, cfg.vres)
        x0 = self.stem.conv1.block(x0, ks=3, stride=1, train=train)
        x0 = self.stem.conv2.block(x0, ks=3, stride=1, train=train)
        z0 = voxel_to_point(x0, z, nearest=False)

        x1 = point_to_voxel(x0, z0)
        for i in range(1, 5):
            x1 = getattr(self, f"stage{i}")(x1, train)

        z1 = voxel_to_point(x1, z0)
        pt = self.point_transform
        skip = pt.bn(pt.lin(z0.feats), z0.mask, train)
        z1 = z1._replace(feats=z1.feats + torch.relu(skip))

        y1 = point_to_voxel(x1, z1)
        return self.classifier(global_avg_pool(y1, num_batches))


def init_spvcnn(cfg: SPVCNNConfig, generator: Optional[torch.Generator] = None) -> SPVCNN:
    """The classifier with seeded weights (``scade_tpu/prior/spvcnn.py::init_spvcnn``'s
    laws, drawn from ``generator``): torchsparse's conv init uniform(-a, a),
    a = sqrt(1 / (ks³ Cin)); Linear uniform(±sqrt(1 / Cin)) for weight and
    bias; BatchNorm γ=1, β=0, mean 0, var 1. In eval mode."""
    model = SPVCNN(cfg)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, ConvBN):
                ks3, cin, _ = module.w.shape
                a = math.sqrt(1.0 / (ks3 * cin))
                module.w.uniform_(-a, a, generator=generator)
            elif isinstance(module, nn.Linear):
                a = math.sqrt(1.0 / module.in_features)
                module.weight.uniform_(-a, a, generator=generator)
                module.bias.uniform_(-a, a, generator=generator)
    return model.eval()


# ---------------------------------------------------------------------------
# input functions (lib/test_utils.py): host-side numpy, then pad to capacity
# ---------------------------------------------------------------------------


def init_image_coor(height: int, width: int, u0: Optional[float] = None,
                    v0: Optional[float] = None):
    """test_utils.py:9-22."""
    u0 = width / 2.0 if u0 is None else u0
    v0 = height / 2.0 if v0 is None else v0
    u_u0 = np.tile(np.arange(width), (height, 1)).astype(np.float32) - u0
    v_v0 = np.tile(np.arange(height), (width, 1)).T.astype(np.float32) - v0
    return u_u0, v_v0


def depth_to_pcd(depth: np.ndarray, u_u0: np.ndarray, v_v0: np.ndarray, f: float,
                 invalid_value: float = 0.0):
    """test_utils.py:24-31 (sets depth's invalid entries to 0 in place, as
    the reference does)."""
    mask_invalid = depth <= invalid_value
    depth[mask_invalid] = 0.0
    pcd = np.stack([u_u0 / f * depth, v_v0 / f * depth, depth], axis=2)
    return pcd, ~mask_invalid


def _quantize_pad(pc: np.ndarray, feat: np.ndarray, num_points: int,
                  rng: np.random.RandomState) -> SparsePoints:
    """sparse_quantize(return_index) and the random subsample past
    num_points (test_utils.py:44-52), padded to a fixed capacity."""
    _, inds = np.unique(pc.astype(np.int64), axis=0, return_index=True)
    if len(inds) > num_points:
        inds = rng.choice(inds, num_points, replace=False)
    pc, feat = pc[inds], feat[inds]
    n = pc.shape[0]
    coords = np.zeros((num_points, 4), np.int32)
    feats = np.zeros((num_points, feat.shape[1]), np.float32)
    coords[:n, :3] = pc[:num_points].astype(np.int32)
    feats[:n] = feat[:num_points]
    return SparsePoints(torch.from_numpy(feats), torch.from_numpy(coords.astype(np.float32)),
                        torch.from_numpy(np.arange(num_points) < n))


def pcd_to_sparsetensor(pcd: np.ndarray, mask_valid: np.ndarray, voxel_size: float = 0.01,
                        num_points: int = 100000, seed: int = 0) -> SparsePoints:
    """test_utils.py:33-56: xyz features, the voxel-grid quantization with
    the min-corner shift, dedup, subsample, padding."""
    block = pcd[mask_valid].astype(np.float32)
    pc = np.round(block[:, :3] / voxel_size)
    pc -= pc.min(0, keepdims=True)
    return _quantize_pad(pc, block, num_points, np.random.RandomState(seed))


def pcd_uv_to_sparsetensor(pcd: np.ndarray, u_u0: np.ndarray, v_v0: np.ndarray,
                           mask_valid: np.ndarray, f: float = 500.0, voxel_size: float = 0.01,
                           mask_side: Optional[np.ndarray] = None, num_points: int = 100000,
                           seed: int = 0) -> SparsePoints:
    """test_utils.py:58-87: xyz + (u - u0) / f + (v - v0) / f features."""
    if mask_side is not None:
        mask_valid = mask_valid & mask_side
    block = np.concatenate([
        pcd[mask_valid].astype(np.float32),
        (u_u0[mask_valid] / f)[:, None].astype(np.float32),
        (v_v0[mask_valid] / f)[:, None].astype(np.float32),
    ], axis=1)
    pc = np.round(block[:, :3] / voxel_size)
    pc -= pc.min(0, keepdims=True)
    return _quantize_pad(pc, block, num_points, np.random.RandomState(seed))


def refine_focal(depth: np.ndarray, focal: float, apply_fn: Callable[[SparsePoints], torch.Tensor],
                 u0: float, v0: float) -> Tuple[float, float]:
    """test_utils.py:90-119 (one iteration, as shipped): a focal scale
    predicted from the uv point cloud; ``apply_fn(points) -> (1, 1)`` is the
    classifier with its weights bound (and the points moved to its device).
    Returns (refined focal, scale); the reference returns only the scale."""
    u_u0, v_v0 = init_image_coor(depth.shape[0], depth.shape[1], u0, v0)
    pcd, mask_valid = depth_to_pcd(depth.copy(), u_u0, v_v0, f=focal)
    pts = pcd_uv_to_sparsetensor(pcd, u_u0, v_v0, mask_valid, f=focal, voxel_size=0.005)
    scale = float(apply_fn(pts).reshape(-1)[0])
    return float(focal / scale), scale


def refine_shift(depth_wshift: np.ndarray, apply_fn: Callable[[SparsePoints], torch.Tensor],
                 focal: float, u0: float, v0: float) -> float:
    """test_utils.py:101-129 (one iteration; the shift clamped at 0.7 as
    shipped)."""
    u_u0, v_v0 = init_image_coor(depth_wshift.shape[0], depth_wshift.shape[1], u0, v0)
    pcd, mask_valid = depth_to_pcd(depth_wshift.copy(), u_u0, v_v0, f=focal)
    pts = pcd_to_sparsetensor(pcd, mask_valid, voxel_size=0.01)
    shift = float(apply_fn(pts).reshape(-1)[0])
    return min(shift, 0.7)
