"""The numbers that decide ``correct`` for a training cell, and their limits.

Set-up drives the program's own training object from the seed through its
first steps with the window's own call; the plain reference follows the
first three from the same weights and inputs. Compared:

- ``loss1_gap``: the relative gap between the first step's loss and the
  reference's, before any update could compound a rounding;
- ``loss_gap``: the largest relative gap between a step's loss and the
  reference's, over the steps followed;
- ``grad_gap``: the first gradient as the optimizer got it, by the worst
  leaf: the gap between the program's norm of the leaf and the reference's,
  over the reference's norm of that leaf or of the median leaf, whichever is
  larger (some gradients are all but zero); ``grad_median_gap`` the
  median of the leaves' gaps, for a model whose worst leaf is noise of
  its configured precision (see ``PERF.md``);
- ``change_gap``: the same measure of the parameters' change over the steps
  followed, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding moves by round-off alone under Adam or momentum);
  ``change_median_gap`` the median of those leaves' gaps, for a model whose
  worst leaf after three steps is noise (see ``PERF.md``).

A cell's file names which of these it compares, with their limits.

A leaf that one side lacks reads infinity.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional

import torch

KEEP_FLOOR = 1e-3


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's L2 norm, summed in float64."""
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    names = list(ref) if keep is None else list(keep)
    med = statistics.median(ref[n] for n in names) if names else 0.0
    gaps = {}
    for n in names:
        p, r = prog.get(n), ref[n]
        scale = max(r, med)
        if p is None or not math.isfinite(p):
            gaps[n] = math.inf
        else:
            gaps[n] = abs(p - r) / scale if scale > 0 else (0.0 if p == r else math.inf)
    return gaps


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap (infinity with no leaf)."""
    gaps = leaf_gaps(prog, ref, keep)
    return max(gaps.values()) if gaps else math.inf


def worst(gaps: Dict[str, float], n: int = 3) -> list:
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n]]


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [n for n, v in ref_grad.items() if v >= KEEP_FLOOR * med]


def training_checks(record: dict, ref_losses: List[float], ref_grad: Dict[str, float],
                    ref_change: Dict[str, float]) -> Dict[str, float]:
    losses = record["losses"][:len(ref_losses)]
    if len(losses) < len(ref_losses) or not all(math.isfinite(x) for x in losses):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(losses, ref_losses))
    grads = leaf_gaps(record["grad_norms"], ref_grad)
    changes = leaf_gaps(record["change_norms"], ref_change, kept_leaves(ref_grad))
    gaps = [abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p) else math.inf
            for p, r in zip(losses, ref_losses)]
    checks = {"loss1_gap": gaps[0] if gaps else math.inf, "loss_gap": loss_gap,
              "grad_gap": max(grads.values()) if grads else math.inf,
              "change_gap": max(changes.values()) if changes else math.inf,
              "change_median_gap": statistics.median(changes.values()) if changes else math.inf,
              "grad_median_gap": statistics.median(grads.values()) if grads else math.inf}
    # for the record, not compared: each step's gap, the leaves that read worst
    checks["loss_gaps"] = gaps
    checks["grad_worst"], checks["change_worst"] = worst(grads), worst(changes)
    return checks


def verdict(checks: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared at or below its limit (a missing number fails)."""
    return all(name in checks and checks[name] <= limit for name, limit in limits.items())


def lines(checks: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"check {name} {checks.get(name, math.nan)!r} limit {limit!r}"
            for name, limit in limits.items()]


def block(checks: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {name: {"value": checks.get(name, math.nan), "limit": limit}
            for name, limit in limits.items()}
