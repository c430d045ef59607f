"""Depth-completion data utilities (reference: data/scannet_dataset.py).

The port's own copy of ``scade_tpu/data/scannet_dataset.py``, in numpy with
the same outputs. The reference's ScanNetDataset/TaskonomyDataset feed a
depth-completion prior that the SCADE flow itself never trains (the runners
import only the helper functions, SURVEY.md §2.1): ``read_depth``, the
scaling conversions, ``get_pretrained_normalize``, ``resize_sparse_depth``,
``sample_depth_at_image_features`` (COLMAP SQLite keypoint sparsification),
and the two loaders with the reference's on-disk contract. OpenCV is
required to read and resize images.
"""

from __future__ import annotations

import os
import sqlite3
from typing import Optional, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

MAX_DEPTH_M = 16.38  # 1/4 of the 16-bit range at 512 units/m (reference :65-68)


def read_depth(depth_file: str) -> Tuple[np.ndarray, np.ndarray]:
    """uint16 depth png → (depth in [0,1] of 16.38 m, valid mask)
    (reference :51-74): values > 23000 invalid, 512 units per meter."""
    depth = cv2.imread(depth_file, cv2.IMREAD_UNCHANGED) if depth_file else None
    if depth is None:
        # the reference crashes here (cv2.imread(None)[...] TypeError,
        # :53-54); returning None lets callers zero-fill the example instead
        # of aborting an hours-long pretraining epoch
        return None, None
    depth = depth.astype(np.float64)
    depth[depth > 23000] = 0
    depth = depth / 512.0  # meters
    valid = depth.astype(bool)
    depth = depth.astype(np.float32) / MAX_DEPTH_M
    over = depth > 1.0
    depth[over] = 0.0
    valid[over] = False
    return depth, valid


def convert_depth_completion_scaling_to_m_taskonomy(depth):
    return depth * MAX_DEPTH_M


def convert_m_to_depth_completion_scaling_taskonomy(depth):
    return depth / MAX_DEPTH_M


def convert_depth_completion_scaling_to_m(depth):
    # map range 0..1 to 0..16.38 m via the 4000 units/m 16-bit convention
    return depth * (2**16 - 1) / 4000.0


def convert_m_to_depth_completion_scaling(depth):
    return depth * 4000.0 / (2**16 - 1)


def get_pretrained_normalize():
    """ImageNet (un)normalization params for rgb and rgbd stacks
    (reference :99-106). Returns dict {'rgb': (mean, std), 'rgbd': ...}."""
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (
        {"rgb": (mean, std), "rgbd": (np.append(mean, 0.0), np.append(std, 1.0))},
        {
            "rgb": (-mean / std, 1.0 / std),
            "rgbd": (
                np.append(-mean / std, 0.0),
                np.append(1.0 / std, 1.0),
            ),
        },
    )


def resize_sparse_depth(depths, valid_depths, size):
    """Sparsity-preserving resize: move each valid sample to its resized
    pixel-center location instead of interpolating (reference :108-125).

    depths: (B, H, W) float; valid_depths: (B, H, W) bool; size: (h, w).
    """
    depths = np.asarray(depths)
    valid = np.asarray(valid_depths)
    B, H, W = depths.shape
    h, w = size
    fh, fw = h / H, w / W
    out = np.zeros((B, h, w), depths.dtype)
    out_valid = np.zeros((B, h, w), bool)
    b_idx, r_idx, c_idx = np.nonzero(valid)
    r2 = ((r_idx + 0.5) * fh).astype(int)
    c2 = ((c_idx + 0.5) * fw).astype(int)
    keep = (r2 >= 0) & (r2 < h) & (c2 >= 0) & (c2 < w)
    out[b_idx[keep], r2[keep], c2[keep]] = depths[b_idx[keep], r_idx[keep], c_idx[keep]]
    out_valid[b_idx[keep], r2[keep], c2[keep]] = True
    return out, out_valid


def sample_depth_at_image_features(
    depth, valid_depth, db_path: str, db_image_id: int, scale=(1.0, 1.0),
    pad_height: int = 0,
):
    """Keep depth only at COLMAP SfM keypoints, read from the `keypoints`
    table of a COLMAP SQLite database (reference :248-271). depth/valid:
    (H, W). Returns sparsified (depth, valid)."""
    depth = np.array(depth, copy=True)
    valid = np.array(valid_depth, copy=True)
    con = sqlite3.connect(db_path)
    try:
        rows_db = con.execute(
            "SELECT data FROM keypoints WHERE image_id==?", (db_image_id,)
        ).fetchall()
    finally:
        con.close()
    if not rows_db or rows_db[0][0] is None:
        return np.zeros_like(depth), np.zeros_like(valid)
    kp = np.frombuffer(rows_db[0][0], dtype=np.float32).reshape(-1, 6)
    cols = (kp[:, 0] * scale[1]).astype(int)
    rows = ((kp[:, 1] + pad_height) * scale[0]).astype(int)
    keep = (rows >= 0) & (rows < depth.shape[0]) & (cols >= 0) & (cols < depth.shape[1])
    mask = np.zeros_like(valid)
    mask[rows[keep], cols[keep]] = True
    valid = valid & mask
    depth[~valid] = 0.0
    return depth, valid


def _add_missing_depth_np(rng, depth, valid, p):
    """Host-side add_missing_depth (reference data/error_sources.py:3-15):
    invalidate random VALID pixels until the TOTAL invalid fraction reaches
    p — a no-op when the map is already sparser than p (the common case
    after SfM-keypoint sparsification). (The tensor variant, drawing from
    a torch.Generator, is data/error_sources.py's.)"""
    n_pixels = valid.size
    n_valid = int(valid.sum())
    p_before = (n_pixels - n_valid) / n_pixels
    p_gap = p - p_before
    if p_gap <= 0.0 or n_valid == 0:
        return depth, valid
    p_inv = p_gap * n_pixels / n_valid
    drop = rng.random(depth.shape) < p_inv
    valid = valid & ~drop
    out = np.where(valid, depth, 0.0).astype(depth.dtype)
    return out, valid


class TaskonomyDataset:
    """Depth-completion dataset over taskonomy-style annotations json
    (reference TaskonomyDataset, data/scannet_dataset.py:276-515).

    Per example: rgb + sensor depth (16.38 m normalization via read_depth),
    SfM-keypoint sparsification from a COLMAP SQLite db, missing-depth
    corruption (p=0.998), sparse-preserving resize to load_size, optional
    rotation / horizontal flip / color jitter, ImageNet-normalized rgbd
    stack, and the clean (target) depth for supervision. numpy host-side
    (NHWC); RNG is an explicit np.random.Generator.

    Matches the reference's quirks: the 968x1296 ScanNet-style rgb gets
    2-pixel height padding + nearest resize to the depth grid (:377-386);
    the db image id is the last-3 path components of the rgb file (:394);
    missing rgb files yield a zeroed example with found=False (:373-376);
    a missing/entry-less depth file also zero-fills here, where the
    reference crashes in read_depth (documented deviation: an aborted
    multi-hour pretraining epoch is genuinely broken);
    the depth channel is divided by (1 + tan|rot|) after rotation (:474).
    """

    def __init__(self, dataset_dir, data_split, db_path, random_rot=0,
                 load_size=(240, 320), horizontal_flip=False,
                 color_jitter=None, depth_noise=False,
                 missing_depth_percent=0.998, rng=None):
        import json

        dir_anno = os.path.join(
            dataset_dir, "annotations", f"{data_split}_annotations.json"
        )
        with open(dir_anno, "r") as f:
            annos = json.load(f)
        self.rgb_files = [
            os.path.join(dataset_dir, "..", a["rgb_path"]) for a in annos
        ]
        self.depth_files = [
            os.path.join(dataset_dir, "..", a["depth_path"])
            if "depth_path" in a else None
            for a in annos
        ]
        self.dataset_dir = dataset_dir
        self.random_rot = random_rot
        self.load_size = tuple(load_size)
        self.horizontal_flip = horizontal_flip
        self.color_jitter = color_jitter
        self.depth_noise = depth_noise
        self.missing_depth_percent = missing_depth_percent
        self.rng = rng or np.random.default_rng()
        self.db_path = db_path
        con = sqlite3.connect(db_path)
        try:
            self.id2dbid = {
                n[:-4]: i
                for n, i in con.execute("SELECT name, image_id FROM images")
            }
        finally:
            con.close()

    def __len__(self):
        return len(self.rgb_files)

    def _zero_example(self):
        h, w = self.load_size
        return {
            "rgbd": np.zeros((h, w, 4), np.float32),
            "valid_depth": np.zeros((h, w), bool),
            "target_depth": np.zeros((h, w, 1), np.float32),
            "target_valid_depth": np.zeros((h, w), bool),
            "found": False,
        }

    def __getitem__(self, index: int) -> dict:
        bgr = cv2.imread(self.rgb_files[index])
        if bgr is None:
            return self._zero_example()
        rgb = bgr[:, :, ::-1].astype(np.float32) / 255.0  # (H, W, 3)
        depth, valid = read_depth(self.depth_files[index])
        if depth is None:
            return self._zero_example()

        # aspect-ratio fixup for 968x1296 rgb vs 480x640 depth (:377-386)
        if rgb.shape[0] == 968 and rgb.shape[1] == 1296:
            pad_h = 2
            rgb = np.pad(rgb, ((pad_h, pad_h), (0, 0), (0, 0)))
            scale = (depth.shape[0] / rgb.shape[0], depth.shape[1] / rgb.shape[1])
            rgb = cv2.resize(
                rgb, (depth.shape[1], depth.shape[0]),
                interpolation=cv2.INTER_NEAREST,
            )
        else:
            pad_h = 0
            scale = (1.0, 1.0)

        img_id = "/".join(self.rgb_files[index][:-4].split("/")[-3:])

        rot = float(self.rng.uniform(-self.random_rot, self.random_rot))
        import math

        tan_abs_rot = math.tan(math.radians(abs(rot)))
        border_w = math.ceil(self.load_size[0] * tan_abs_rot)
        border_h = math.ceil(self.load_size[1] * tan_abs_rot)
        top, left = border_h // 2, border_w // 2
        resize_size = (self.load_size[0] + border_h, self.load_size[1] + border_w)
        apply_hflip = self.horizontal_flip and self.rng.random() > 0.5

        target_depth, target_valid = depth.copy(), valid.copy()
        db_id = self.id2dbid.get(img_id)
        if db_id is None:
            depth, valid = np.zeros_like(depth), np.zeros_like(valid)
        else:
            depth, valid = sample_depth_at_image_features(
                depth, valid, self.db_path, db_id, scale, pad_h
            )
        depth, valid = _add_missing_depth_np(
            self.rng, depth, valid, self.missing_depth_percent
        )

        # resize: sparse-preserving for the sparse depth channel, nearest
        # for rgb and the dense targets (:437-446)
        d_r, valid = resize_sparse_depth(depth[None], valid[None], resize_size)
        d_r, valid = d_r[0], valid[0]
        rgb_r = cv2.resize(
            rgb, (resize_size[1], resize_size[0]),
            interpolation=cv2.INTER_NEAREST,
        )
        t_r = cv2.resize(
            target_depth, (resize_size[1], resize_size[0]),
            interpolation=cv2.INTER_NEAREST,
        )
        tv_r = cv2.resize(
            target_valid.astype(np.uint8), (resize_size[1], resize_size[0]),
            interpolation=cv2.INTER_NEAREST,
        ).astype(bool)

        if self.color_jitter is not None:
            rgb_r = self._jitter(rgb_r)

        if self.random_rot != 0:
            m = cv2.getRotationMatrix2D(
                ((resize_size[1] - 1) / 2.0, (resize_size[0] - 1) / 2.0), rot, 1.0
            )
            size_wh = (resize_size[1], resize_size[0])
            nearest = dict(flags=cv2.INTER_NEAREST, borderValue=0)
            rgb_r = cv2.warpAffine(rgb_r, m, size_wh, **nearest)
            d_r = cv2.warpAffine(d_r, m, size_wh, **nearest)
            valid = cv2.warpAffine(
                valid.astype(np.uint8), m, size_wh, **nearest
            ).astype(bool)
            t_r = cv2.warpAffine(t_r, m, size_wh, **nearest)
            tv_r = cv2.warpAffine(
                tv_r.astype(np.uint8), m, size_wh, **nearest
            ).astype(bool)

        sl = (slice(top, top + self.load_size[0]),
              slice(left, left + self.load_size[1]))
        rgb_r, d_r, valid = rgb_r[sl], d_r[sl], valid[sl]
        t_r, tv_r = t_r[sl], tv_r[sl]

        if apply_hflip:
            rgb_r, d_r, valid = rgb_r[:, ::-1], d_r[:, ::-1], valid[:, ::-1]
            t_r, tv_r = t_r[:, ::-1], tv_r[:, ::-1]

        norm, _ = get_pretrained_normalize()
        mean, std = norm["rgb"]
        rgb_n = (rgb_r - mean) / std
        d_r = d_r / (1.0 + tan_abs_rot)  # rotation rescales depth (:474)

        if self.depth_noise:
            # reference add_quadratic_depth_noise (error_sources.py:17-21):
            # std = 1.68e-3*d^2 + 6.58e-3*d + 4.78e-2 in METERS, valid
            # pixels only, clamped to >= 0
            m_depth = convert_depth_completion_scaling_to_m_taskonomy(d_r)
            sigma = 1.68e-3 * m_depth**2 + 6.58e-3 * m_depth + 4.78e-2
            noisy = np.maximum(
                m_depth + self.rng.standard_normal(m_depth.shape) * sigma, 0.0
            )
            m_depth = np.where(valid, noisy, m_depth)
            d_r = convert_m_to_depth_completion_scaling_taskonomy(m_depth)

        rgbd = np.concatenate([rgb_n, d_r[..., None]], axis=-1)
        return {
            "rgbd": np.ascontiguousarray(rgbd, dtype=np.float32),
            "valid_depth": np.ascontiguousarray(valid),
            "target_depth": np.ascontiguousarray(t_r[..., None], dtype=np.float32),
            "target_valid_depth": np.ascontiguousarray(tv_r),
            "found": True,
        }

    def _jitter(self, rgb):
        """torchvision ColorJitter(b, c, s, h) equivalent in numpy/cv2
        (the reference uses one factor for all four, :451-454): factors
        drawn uniform(max(0, 1-j), 1+j) (hue: uniform(-j, j), clamped to
        ±0.5 turns), ops applied in a random permutation."""
        j = self.color_jitter
        rng = self.rng
        b = rng.uniform(max(0.0, 1 - j), 1 + j)
        c = rng.uniform(max(0.0, 1 - j), 1 + j)
        s = rng.uniform(max(0.0, 1 - j), 1 + j)
        hj = min(j, 0.5)
        h = rng.uniform(-hj, hj)
        gray_w = np.array([0.299, 0.587, 0.114], np.float32)

        def bright(x):
            return np.clip(x * b, 0, 1)

        def contrast(x):
            m = (x @ gray_w).mean()
            return np.clip((x - m) * c + m, 0, 1)

        def saturation(x):
            g = (x @ gray_w)[..., None]
            return np.clip((x - g) * s + g, 0, 1)

        def hue(x):
            hsv = cv2.cvtColor(x.astype(np.float32), cv2.COLOR_RGB2HSV)
            hsv[..., 0] = (hsv[..., 0] + h * 360.0) % 360.0
            return np.clip(cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), 0, 1)

        ops = [bright, contrast, saturation, hue]
        for i in rng.permutation(4):
            rgb = ops[int(i)](rgb)
        return rgb.astype(np.float32)


class ScanNetDataset:
    """Depth-completion example loader (reference ScanNetDataset :127-274):
    rgb + sensor depth (+ optional SfM-keypoint sparsification), ImageNet-
    normalized rgbd stacks. numpy host-side; iterate and batch manually."""

    def __init__(self, rgb_files, depth_files, feature_db: Optional[str] = None,
                 db_ids=None):
        self.rgb_files = list(rgb_files)
        self.depth_files = list(depth_files)
        self.feature_db = feature_db
        self.db_ids = db_ids

    def __len__(self):
        return len(self.rgb_files)

    def __getitem__(self, i: int) -> dict:
        rgb = cv2.imread(self.rgb_files[i])[:, :, ::-1].astype(np.float32) / 255.0
        depth, valid = read_depth(self.depth_files[i])
        if depth is None:
            raise FileNotFoundError(
                f"depth file missing or unreadable: {self.depth_files[i]}"
            )
        if self.feature_db is not None:
            depth, valid = sample_depth_at_image_features(
                depth, valid, self.feature_db, self.db_ids[i]
            )
        norm, _ = get_pretrained_normalize()
        mean, std = norm["rgb"]
        rgb_n = (rgb - mean) / std
        rgbd = np.concatenate([rgb_n, depth[..., None]], axis=-1)
        return {
            "rgbd": rgbd.astype(np.float32),
            "depth": depth[..., None],
            "valid_depth": valid,
        }
