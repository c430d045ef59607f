"""Prior depth eval metrics + metric-depth alignment: the port's copy of
``scade_tpu/prior/metrics.py`` (numpy only).

Mirrors the reference eval fns (reference:
ambiguity_aware_prior/tools/output_depth_hypothesis_scannet.py:165-324,
lib/utils/evaluate_depth_error.py:7-130): absRel, sqRel, silog, δ<1.25,
WHDR, and the per-hypothesis linear fit against sparse SfM depth that
converts relative prior output into metric depth. Host-side numpy — these
run once per image in offline tools.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def recover_metric_depth(pred, gt, mask_threshold: float = 0.1,
                         default_scale: float = 0.5,
                         default_shift: float = 0.0):
    """Per-image deg-1 polyfit of pred→gt over gt > threshold
    (output_depth_hypothesis_scannet.py:302-324; threshold 0.5 for wild
    scenes). When no SfM point clears the threshold the reference returns
    pred UNSCALED — FLAGS.default_scale/default_shift (:55-56) are reported
    as metadata only (:312-314), never applied."""
    gt = np.asarray(gt).squeeze()
    pred = np.asarray(pred).squeeze()
    mask = gt > mask_threshold
    if mask.sum() == 0:
        return pred, default_scale, default_shift
    a, b = np.polyfit(pred[mask], gt[mask], deg=1)
    return a * pred + b, a, b


def evaluate_rel_err(pred, gt, mask_invalid=None, scale: float = 10.0,
                     rng: Optional[np.random.Generator] = None):
    """(absRel, sqRel, silog, δ1, WHDR) (output_depth_hypothesis_scannet.py
    :165-230). Returns −1s when fewer than 10 valid pixels."""
    pred = np.asarray(pred).squeeze()
    gt = np.asarray(gt).squeeze()
    if pred.shape != gt.shape:
        raise ValueError(f"shape mismatch {pred.shape} vs {gt.shape}")
    if mask_invalid is not None:
        keep = ~np.asarray(mask_invalid).squeeze()
        gt, pred = gt[keep], pred[keep]

    mask = gt > 1e-8
    gt, pred = gt[mask], pred[mask]
    n = gt.size
    if n < 10:
        return (-1.0,) * 5
    gt_s, pred_s = gt * scale, pred * scale

    abs_rel = float(np.sum(np.abs(gt - pred) / gt) / n)
    sq_rel = float(np.sum(((gt_s - pred_s) ** 2) / (gt_s**2)) / n)
    # note: the reference's "silog" is the plain mean log-diff (:211-214)
    silog = float(np.sum(np.log(pred_s) - np.log(gt_s)) / n)
    ratio = np.maximum(gt_s / pred_s, pred_s / gt_s)
    delta1 = float(np.sum(ratio < 1.25) / n)
    whdr_err, whdr_n = weighted_human_disagreement_rate(gt_s, pred_s, rng)
    whdr = float(whdr_err) / float(whdr_n)
    return abs_rel, sq_rel, silog, delta1, whdr


def weighted_human_disagreement_rate(gt, pred, rng=None, select_size=10000):
    """Ordinal disagreement over random pixel pairs
    (output_depth_hypothesis_scannet.py:233-267)."""
    rng = rng or np.random.default_rng()
    gt_flat = gt.reshape(-1)
    pred_flat = pred.reshape(-1)
    mask = gt_flat > 0
    gv, pv = gt_flat[mask], pred_flat[mask]
    n_valid = gv.size
    if n_valid >= 2 * select_size:
        p = rng.choice(n_valid, select_size * 2, replace=False)
    else:
        p = rng.choice(n_valid, select_size * 4, replace=True)
    rng.shuffle(p)
    p1 = p[0 : select_size * 2 : 2]
    p2 = p[1 : select_size * 2 : 2]

    def rank(a, b):
        return np.sign(a - b)

    err = np.sum(rank(gv[p1], gv[p2]) != rank(pv[p1], pv[p2]))
    return err, p1.size
