"""Evaluation metrics: RMSE (reference metric/rmse.py), PSNR, SSIM.

``ssim`` is skimage.metrics.structural_similarity with SCADE's arguments
(reference run_scade_scannet.py:370: ``data_range=1., channel_axis=-1``):
7x7 uniform window, K1=0.01, K2=0.03, sample covariance, the mean over the
VALID windows of every channel. The box filter is two 1-D passes of
windowed sums (``unfold`` + ``sum``), each over only 7 elements, so the error
stays near an ulp of 7·|x| on a megapixel image; f32 unless given f64.
"""

from __future__ import annotations

import numpy as np
import torch

from scade_tpu_torch.ops.losses import mse2psnr


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def to16b(x: np.ndarray) -> np.ndarray:
    return ((2**16 - 1) * np.clip(x, 0, 1)).astype(np.uint16)


def compute_rmse(prediction, target, mask=None):
    """sqrt(mean((p - t)^2)), optionally over a boolean mask."""
    if mask is None:
        return torch.sqrt(torch.mean((prediction - target) ** 2))
    m = mask.to(prediction.dtype)
    se = torch.sum((prediction - target) ** 2 * m)
    return torch.sqrt(se / torch.clamp(torch.sum(m), min=1.0))


# the same function under the reference's second name
psnr_from_mse = mse2psnr


def _box_filter_valid(img, win: int):
    """Mean over win x win windows, VALID. img: (H, W) or (H, W, C)."""
    s = img.unfold(0, win, 1).sum(-1)
    s = s.unfold(1, win, 1).sum(-1)
    return s / (win * win)


def ssim(img0, img1, data_range: float = 1.0, win_size: int = 7, k1: float = 0.01,
         k2: float = 0.03):
    """Mean structural similarity, skimage-compatible. img0/img1: (H, W) or
    (H, W, C) in [0, data_range]. Returns a 0-d tensor."""
    dtype = torch.float64 if img0.dtype == torch.float64 else torch.float32
    img0 = img0.to(dtype)
    img1 = img1.to(dtype)

    np_win = win_size * win_size
    cov_norm = np_win / (np_win - 1.0)  # sample covariance (skimage's default)

    ux = _box_filter_valid(img0, win_size)
    uy = _box_filter_valid(img1, win_size)
    uxx = _box_filter_valid(img0 * img0, win_size)
    uyy = _box_filter_valid(img1 * img1, win_size)
    uxy = _box_filter_valid(img0 * img1, win_size)

    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return torch.mean((a1 * a2) / (b1 * b2))
