"""Random index subsets (reference: data/dataset_sampling.py:12-16).

Sizes full-image pixel batches for test-time camera-embedding optimization
(run_scade_scannet.py:278). Host-side numpy, as the JAX package's
``scade_tpu/data/dataset_sampling.py`` has it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def compute_samples_per_subset(sample_count: int, at_least_n: int):
    """The reference's sizing (data/dataset_sampling.py:4-10): every subset
    gets at least ``at_least_n`` samples; subsets hold floor(N / floor(N / n))
    or one more, never a short remainder (``at_least_n`` is a minimum batch
    size at the call site: run_scade_scannet.py:278 passes 2*N_rand)."""
    at_least_n = min(at_least_n, sample_count)
    number_subsets = sample_count // at_least_n
    samples_per_subset = sample_count // number_subsets
    extra_sample_subsets = sample_count % samples_per_subset
    normal_subsets = number_subsets - extra_sample_subsets
    return samples_per_subset, normal_subsets, extra_sample_subsets


def create_random_subsets(
    indices, subset_size: int, rng: Optional[np.random.Generator] = None
) -> List[np.ndarray]:
    """Shuffle ``indices`` and split them with the reference's random_split
    sizing (:12-16): ``normal`` subsets of samples_per_subset, then ``extra``
    subsets of samples_per_subset + 1, all at least ``subset_size``."""
    rng = rng or np.random.default_rng()
    idx = np.asarray(list(indices))
    per, normal, extra = compute_samples_per_subset(len(idx), subset_size)
    shuffled = idx[rng.permutation(len(idx))]
    sizes = [per] * normal + [per + 1] * extra
    out, s = [], 0
    for size in sizes:
        out.append(shuffled[s: s + size])
        s += size
    return out
