"""SCADE training losses.

The space-carving loss matches samples drawn from the NeRF's ray-termination
distribution against K monocular depth hypotheses per image.
"""

from __future__ import annotations

import math

import torch


def img2mse(x, y):
    return torch.mean((x - y) ** 2)


def mse2psnr(x):
    return -10.0 * torch.log(x) / math.log(10.0)


def compute_space_carving_loss(
    pred_depth,
    target_hypothesis,
    is_joint: bool = False,
    mask=None,
    norm_p: int = 2,
    threshold: float = 0.0,
    mean_over_ranks=None,
):
    """Space-carving loss.

    pred_depth:        (n_rays, n_points) P_depth draws.
    target_hypothesis: (K, n_rays, 1), or (K, n_rays, n_points).
    mask:              optional (n_rays,) multiplier on the distances.

    The reference takes a p-norm over a singleton axis, which is |x| for
    every p; ``norm_p`` is kept for flag compatibility only.

    is_joint=False: min over the K hypotheses per (ray, point), then the
    mean. is_joint=True: mean over rays per hypothesis, min over K per
    point, then the mean over points.

    mean_over_ranks: under data parallelism, a differentiable mean over the
    ranks (``Ranks.mean``). The is_joint mean over rays must be the whole
    batch's before the min over K, so it is averaged over the ranks there;
    every other form is a plain mean that equal blocks average afterwards.
    """
    del norm_p
    n_points = pred_depth.shape[-1]
    if target_hypothesis.shape[-1] == 1:
        target_hypothesis = target_hypothesis.expand(
            *target_hypothesis.shape[:-1], n_points
        )

    distances = torch.abs(pred_depth[None, ...] - target_hypothesis)  # (K, R, P)
    if mask is not None:
        distances = distances * mask[None, :, None]
    if threshold > 0:
        distances = torch.where(
            distances < threshold, torch.zeros_like(distances), distances
        )

    if is_joint:
        quantile_mean = torch.mean(distances, dim=1)  # (K, P)
        if mean_over_ranks is not None:
            quantile_mean = mean_over_ranks(quantile_mean)
        return torch.mean(torch.min(quantile_mean, dim=0).values)
    best_hyp = torch.min(distances, dim=0).values  # (R, P)
    return torch.mean(torch.mean(best_hyp, dim=-1))
