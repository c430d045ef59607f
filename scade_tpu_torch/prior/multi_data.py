"""Multi-corpus input for prior pretraining.

The port's own copy of ``scade_tpu/prior/multi_data.py`` (reference:
ambiguity_aware_prior/data/multi_dataset.py:15-528,
load_dataset_distributed.py:40-171), host-side numpy with the same outputs
and the same numpy RNG draws in the same order:

- ``MultipleDataset``: several datasets concatenated, with global indexing;
- ``MultiDataset``: one taskonomy-style annotations corpus
  (``<dataroot>/<name>/annotations/<phase>_annotations.json``), decoded as
  the reference's ``load_test_data_v2`` does;
- ``InterleavedShardedSampler``: each dataset's curriculum shuffled and
  extended to the longest, interleaved round-robin, padded and sharded over
  replicas, with the size-based offsets of ``PARITY.md`` #10.

A replica is one process of the JAX tool, one per host;
``python -m scade_tpu_torch.prior.train --dataset multi`` builds these.
OpenCV is required to read and resize the images.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional, Sequence

import numpy as np

from scade_tpu_torch.prior.data import RGB_MEANS as _RGB_MEANS
from scade_tpu_torch.prior.data import RGB_VARS as _RGB_VARS

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class MultipleDataset:
    """Concatenation of datasets with global indexing
    (load_dataset_distributed.py MultipleDatasetDistributed :40-57)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._sizes = np.array([len(d) for d in self.datasets])
        self._cum = np.cumsum(np.append([0], self._sizes))

    def __len__(self):
        return int(self._sizes.sum())

    def __getitem__(self, global_idx: int):
        d = int(np.searchsorted(self._cum, global_idx, side="right") - 1)
        return self.datasets[d][int(global_idx - self._cum[d])]


# per-source focal lengths (multi_dataset.py:52-53)
FOCAL_LENGTH_DICT = {
    "diml_ganet": 1380.0 / 2.0,
    "taskonomy": 512.0,
    "online": 256.0,
    "apolloscape2": 2304.0 / 2.0,
    "3d-ken-burns": 512.0,
}

# sky/road semantic label ids (multi_dataset.py:476-477)
SKY_LABEL = 17
ROAD_LABEL = 49


class MultiDataset:
    """The annotations/curriculum reader for prior *pretraining* —
    `<dataroot>/<dataset_name>/annotations/<phase>_annotations.json`
    (reference: ambiguity_aware_prior/data/multi_dataset.py:15-528).

    Each annotation entry carries `rgb_path` and optionally `depth_path`,
    `disp_path`, `mask_path` (semantic: sky=17, road=49) and
    `ins_planes_path`. The shipped __getitem__ path is `load_test_data_v2`
    for BOTH phases (the online_aug call is commented out, :102-108); it

    - synthesizes the missing one of depth/disp as the reciprocal of the
      other, rescaled to uint16 max 60000 (:488-516),
    - resizes to CROP_SIZE (bilinear rgb / nearest depth+masks, no
      crop/pad, :159-200),
    - normalizes depth and disp to max→10 (:202-204),
    - marks invalid → −1, sky → 0 in disp and 20 in depth (:207-211),
    - ImageNet-normalizes rgb and attaches the per-source quality flag
      (taskonomy/3d-ken-burns 3, diml 2, else 1 — :229-234) and focal
      length (:52-53, default 256).

    Returns numpy NHWC dicts with the reference's key names; `planes`
    merges the ground mask as a new instance id (:193).
    """

    def __init__(self, dataroot: str, dataset_name: str,
                 phase_anno: str = "train", crop_size=(448, 448),
                 rng: Optional[np.random.Generator] = None):
        if cv2 is None:  # pragma: no cover
            raise ImportError("MultiDataset requires cv2")
        self.dataroot = dataroot
        self.dataset_name = dataset_name
        self.crop_size = tuple(crop_size)
        self.dir_anno = os.path.join(
            dataroot, dataset_name, "annotations",
            f"{phase_anno}_annotations.json",
        )
        with open(self.dir_anno, "r") as f:
            self.all_annos = json.load(f)
        n = len(self.all_annos)
        rng = rng or np.random.default_rng()
        # the reference draws the curriculum with np.random.choice
        # (replace=False) — a random visit order re-drawn per epoch by the
        # sampler (:58)
        self.curriculum_list = list(rng.choice(n, n, replace=False))

        def path_of(anno, key):
            if key not in anno or anno[key] is None:
                return None
            return os.path.join(dataroot, anno[key])

        self.rgb_paths = [os.path.join(dataroot, a["rgb_path"]) for a in self.all_annos]
        self.depth_paths = [path_of(a, "depth_path") for a in self.all_annos]
        self.disp_paths = [path_of(a, "disp_path") for a in self.all_annos]
        self.sem_masks = [path_of(a, "mask_path") for a in self.all_annos]
        self.ins_paths = [path_of(a, "ins_planes_path") for a in self.all_annos]
        self.focal_length = FOCAL_LENGTH_DICT.get(dataset_name.lower(), 256.0)
        name = dataset_name.lower()
        if "taskonomy" in name or "3d-ken-burns" in name:
            self.quality_flg = 3
        elif "diml" in name:
            self.quality_flg = 2
        else:
            self.quality_flg = 1

    def __len__(self):
        return len(self.all_annos)

    # -- raw loading --------------------------------------------------------

    def _loading_check(self, depth, depth_path):
        """Source-specific invalid-value fixes (multi_dataset.py:545-552)."""
        if "taskonomy" in depth_path:
            depth[depth >= 28000] = 0
        if "3d-ken-burns" in depth_path:
            depth[depth >= 47000] = 0
        return depth

    def load_training_data(self, idx):
        """disp/depth synthesis + masks (multi_dataset.py:472-528)."""
        rgb = cv2.imread(self.rgb_paths[idx])[:, :, ::-1]
        dp, pp = self.depth_paths[idx], self.disp_paths[idx]
        if dp is not None and pp is not None:
            disp = cv2.imread(pp, -1)
            disp = (disp / disp.max() * 60000).astype(np.uint16)
            depth = cv2.imread(dp, -1)
            depth = (depth / depth.max() * 60000).astype(np.uint16)
            depth_path = dp
        elif pp is not None:
            disp = cv2.imread(pp, -1)
            disp_mask = disp < 1e-8
            depth = 1 / (disp + 1e-8)
            depth[disp_mask] = 0
            depth = (depth / depth.max() * 60000).astype(np.uint16)
            depth_path = pp
        elif dp is not None:
            depth_path = dp
            depth = cv2.imread(dp, -1)
            depth = self._loading_check(depth, depth_path).astype(np.uint16)
            depth_mask = depth < 1e-8
            disp = 1 / (depth + 1e-8)
            disp[depth_mask] = 0
            disp = (disp / disp.max() * 60000).astype(np.uint16)
        else:
            depth = np.zeros(rgb.shape[:2], np.uint16)
            disp = np.zeros(rgb.shape[:2], np.uint16)
            depth_path = "None"

        if self.sem_masks[idx] is not None:
            sem = cv2.imread(self.sem_masks[idx], -1).astype(np.uint8)
        else:
            sem = np.zeros(disp.shape, np.uint8)
        if self.ins_paths[idx] is not None:
            ins = cv2.imread(self.ins_paths[idx], -1).astype(np.uint8)
        else:
            ins = np.zeros(disp.shape, np.uint8)

        return dict(
            rgb=rgb, disp=disp, depth=depth,
            invalid_disp=disp < 1e-8, invalid_depth=depth < 1e-8,
            ins_planes_mask=ins, sky_mask=sem == SKY_LABEL,
            ground_mask=sem == ROAD_LABEL, depth_path=depth_path,
        )

    # -- the shipped example path -------------------------------------------

    def _resize(self, img, nearest=False):
        h, w = self.crop_size
        interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
        return cv2.resize(img, (w, h), interpolation=interp)

    def load_test_data_v2(self, idx):
        d = self.load_training_data(idx)

        rgb = self._resize(d["rgb"])
        depth = self._resize(d["depth"], nearest=True).astype(np.float32)
        disp = self._resize(d["disp"], nearest=True).astype(np.float32)
        sky = self._resize(d["sky_mask"].astype(np.uint8), nearest=True).astype(bool)
        inv_disp = self._resize(d["invalid_disp"].astype(np.uint8), nearest=True).astype(bool)
        inv_depth = self._resize(d["invalid_depth"].astype(np.uint8), nearest=True).astype(bool)
        ins = d["ins_planes_mask"].copy()
        ins[d["ground_mask"]] = int(np.unique(ins).max() + 1)
        ins = self._resize(ins.astype(np.uint8), nearest=True)

        depth = depth / (depth.max() + 1e-8) * 10
        disp = disp / (disp.max() + 1e-8) * 10
        disp[inv_disp | (disp > 1e7) | (disp < 0)] = -1
        depth[inv_depth | (depth > 1e7) | (depth < 0)] = -1
        disp[sky] = 0
        depth[sky] = 20

        rgb_n = ((rgb.astype(np.float32) / 255.0) - _RGB_MEANS) / _RGB_VARS
        return {
            "rgb": rgb_n.astype(np.float32),
            "depth": depth[..., None],
            "disp": disp[..., None],
            "gt_depth": depth[..., None],
            "A_paths": self.rgb_paths[idx],
            "B_paths": d["depth_path"],
            "quality_flg": np.array(self.quality_flg),
            "planes": ins,
            "focal_length": np.float32(self.focal_length),
        }

    def __getitem__(self, idx):
        # both phases take load_test_data_v2 — the reference's online_aug
        # call is commented out (multi_dataset.py:102-108)
        return self.load_test_data_v2(idx)


class InterleavedShardedSampler:
    """CustomerMultiDataSampler semantics (load_dataset_distributed.py:81-171):

    - per dataset: shuffle its curriculum, then extend by re-shuffled copies
      to the max dataset length (so small datasets repeat — :144-160);
    - train order interleaves datasets round-robin [A0, B0, C0, A1, ...];
    - pad to a multiple of world size, then each rank takes a contiguous
      shard.

    Deliberate deviation (PARITY.md #10): global offsets come from the
    concatenated dataset's SIZE cumsum (`self.ds._cum`), not the reference's
    max-index cumsum (:111-113) — the reference decodes through
    ConcatDataset's size-based offsets, so its encode/decode disagree and
    samples cross dataset boundaries.
    """

    def __init__(self, multi_dataset: MultipleDataset, num_replicas: int = 1,
                 rank: int = 0, split: str = "train", sample_ratio: float = 1.0,
                 rng: Optional[np.random.Generator] = None):
        self.ds = multi_dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.split = split
        self.sample_ratio = sample_ratio
        self.rng = rng or np.random.default_rng()

        sizes = self.ds._sizes
        if (np.asarray(sizes) == 0).any():
            # an empty member would spin _extended_indices forever (size 0
            # never fills max_len); the reference at least crashes with a
            # ZeroDivisionError (load_dataset_distributed.py:146) — fail
            # loudly with the culprit instead
            empty = [i for i, s in enumerate(np.asarray(sizes)) if s == 0]
            raise ValueError(
                f"empty member dataset(s) at index {empty}: every dataset "
                "in a MultipleDataset needs at least one example"
            )
        max_len = int(sizes.max())
        self._extended_len = (
            np.full(len(sizes), max_len) if split == "train" else sizes
        )
        self.num_samples = (self._extended_len * sample_ratio).astype(np.int64)
        self.total_sampled = int(self.num_samples.sum())
        self.num_dist_samples = int(
            math.ceil(self.total_sampled / self.num_replicas)
        )
        self.total_dist_size = self.num_dist_samples * self.num_replicas

    def _extended_indices(self) -> List[np.ndarray]:
        out = []
        max_len = int(self._extended_len.max()) if self.split == "train" else None
        for size in self.ds._sizes:
            perm = self.rng.permutation(size)
            if self.split != "train":
                out.append(perm)
                continue
            reps = [perm]
            filled = size
            while filled + size <= max_len:
                reps.append(self.rng.permutation(size))
                filled += size
            rem = max_len - filled
            if rem > 0:
                reps.append(self.rng.choice(size, rem, replace=False))
            out.append(np.concatenate(reps))
        return out

    def __iter__(self):
        per_ds = self._extended_indices()
        offsets = self.ds._cum[:-1]
        sampled = [
            per_ds[i][: self.num_samples[i]] + offsets[i]
            for i in range(len(per_ds))
        ]
        if self.split == "train":
            # round-robin interleave (:118-120)
            stacked = np.stack(sampled, axis=0)  # (D, n)
            indices = stacked.T.reshape(-1)
        else:
            indices = np.concatenate(sampled)

        diff = self.total_dist_size - indices.size
        if diff > 0:
            indices = np.append(indices, indices[:diff])
        start = self.num_dist_samples * self.rank
        yield from indices[start : start + self.num_dist_samples].tolist()

    def __len__(self):
        return self.num_dist_samples
