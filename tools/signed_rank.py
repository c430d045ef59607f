#!/usr/bin/env python3
"""One-sided Wilcoxon signed-rank test of paired results, exact.

    python3 tools/signed_rank.py A1,A2,... B1,B2,...

Tests whether A tends to exceed B, pair by pair (for example the depth RMSE
of two training variants run at the same seeds). Prints the differences
A - B, how many are positive, W+ (the sum of the ranks of |A - B| over the
positive differences; tied magnitudes share their mean rank; zero
differences are dropped) and the exact p-value, P(W+ >= observed) over all
2^n equally likely sign assignments, as one JSON line.
"""

import itertools
import json
import sys


def ranks(values):
    """1-based ranks of ``values``, ties given their mean rank."""
    order = sorted(range(len(values)), key=lambda i: values[i])
    out = [0.0] * len(values)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and values[order[j + 1]] == values[order[i]]:
            j += 1
        for k in range(i, j + 1):
            out[order[k]] = (i + j) / 2 + 1
        i = j + 1
    return out


def signed_rank(a, b):
    d = [x - y for x, y in zip(a, b, strict=True)]
    nonzero = [x for x in d if x != 0]
    r = ranks([abs(x) for x in nonzero])
    w = sum(rk for rk, x in zip(r, nonzero) if x > 0)
    at_least = sum(sum(rk for rk, s in zip(r, signs) if s) >= w
                   for signs in itertools.product((False, True), repeat=len(r)))
    return dict(differences=d, n=len(nonzero), positive=sum(x > 0 for x in nonzero),
                w_plus=w, p_one_sided=at_least / 2 ** len(r))


def main() -> int:
    a, b = ([float(x) for x in arg.split(",")] for arg in sys.argv[1:3])
    print(json.dumps(signed_rank(a, b)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
