"""tools/signed_rank.py, the exact one-sided signed-rank test that decides
paired-seed comparisons of training runs (ROADMAP 7b): against hand-counted
cases and scipy's exact test."""

import os
import sys

import numpy as np
import pytest
import scipy.stats

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import signed_rank  # noqa: E402


def test_all_positive_is_one_assignment_in_2_to_the_n():
    r = signed_rank.signed_rank([2.0] * 10, [1.0] * 10)
    assert (r["n"], r["positive"], r["w_plus"], r["p_one_sided"]) == (10, 10, 55.0, 2.0**-10)


def test_ties_share_ranks_and_zeros_drop():
    # |d| = 0.5, 1, 0.5 rank 1.5, 3, 1.5; W+ = 3; the 8 sign assignments give
    # W+ of 0, 1.5, 1.5, 3, 3, 4.5, 4.5, 6, so P(W+ >= 3) = 5/8
    r = signed_rank.signed_rank([1.0, 2.0, 3.0, 4.0], [1.5, 1.0, 3.5, 4.0])
    assert (r["n"], r["positive"], r["w_plus"], r["p_one_sided"]) == (3, 1, 3.0, 0.625)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_scipy_exact(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(0.3, 0.5, 10), rng.uniform(0.3, 0.5, 10) - 0.03 * seed
    ref = scipy.stats.wilcoxon(a, b, alternative="greater", method="exact")
    r = signed_rank.signed_rank(list(a), list(b))
    assert r["w_plus"] == ref.statistic and r["p_one_sided"] == pytest.approx(ref.pvalue)
