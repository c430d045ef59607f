"""Host-side data of the cIMLE prior: one scene's training images.

The port's copy of ``scade_tpu/prior/data.py``'s FinetuneDataset, which
follows the reference's on-disk contract and preprocessing (reference:
ambiguity_aware_prior/data/finetune_dataset.py:460-660):

- frame list from ``<scene>/transforms_train.json`` (file_path basenames),
  rgb from ``<scene>/train/rgb/``, depth from ``train/target_depth/`` (GT)
  or ``train/depth/`` ("processed" scenes), SfM-sparse depth from
  ``train/depth/``;
- depth: mm → m, invalid < 1e-8, rescaled to max 60000 uint16, resized
  nearest to the crop, then normalized to max → 10 with invalids at −1;
- rgb: bilinear resize to the crop, ImageNet mean/var normalization.

Everything is numpy, HWC, as read from disk; the dump and the trainer turn
an image into an NCHW tensor on the device. OpenCV is required to read the images.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

RGB_MEANS = np.array([0.485, 0.456, 0.406], np.float32)
RGB_VARS = np.array([0.229, 0.224, 0.225], np.float32)
CROP_SIZE = (448, 448)
FOCAL_LENGTH = {"scannet": 577.870605, "nsvf": 1111.111}


def normalize_rgb(rgb_uint8: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB → normalized float32 HWC."""
    x = rgb_uint8.astype(np.float32) / 255.0
    return (x - RGB_MEANS) / RGB_VARS


def denormalize_rgb(x: np.ndarray) -> np.ndarray:
    """Normalized float HWC → uint8 RGB."""
    return np.clip((x * RGB_VARS + RGB_MEANS) * 255.0, 0, 255).astype(np.uint8)


@dataclasses.dataclass
class PriorExample:
    rgb: np.ndarray  # (crop, crop, 3) normalized
    depth: np.ndarray  # (crop, crop, 1), max → 10, invalid −1
    disp: np.ndarray  # (crop, crop, 1)
    planes: np.ndarray  # (crop, crop) uint8 instance ids (0 = none)
    focal_length: float
    quality_flg: int
    rgb_path: str
    depth_path: str
    sfm_depth_path: str
    raw_size: tuple  # (H, W) of the raw image


def _imread(path: str, unchanged: bool = False) -> np.ndarray:
    if cv2 is None:
        raise ImportError("the prior's data pipeline needs OpenCV (cv2) to read images")
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED) if unchanged else cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


class FinetuneDataset:
    """Per-scene prior dataset (finetune_dataset.py:460-537)."""

    def __init__(self, scene_train_dir: str, dataset_name: str = "scannet",
                 crop_size=CROP_SIZE):
        self.root = scene_train_dir
        self.dataset_name = dataset_name
        self.crop_size = crop_size
        image_dir = os.path.join(self.root, "rgb")
        depth_dir = os.path.join(self.root, "depth" if dataset_name == "processed"
                                 else "target_depth")
        sfm_depth_dir = os.path.join(self.root, "depth")
        with open(os.path.join(self.root, "..", "transforms_train.json")) as fp:
            meta = json.load(fp)
        names = [f["file_path"].split("/")[-1] for f in meta["frames"]]
        self.rgb_paths = [os.path.join(image_dir, n) for n in names]
        self.depth_paths = [os.path.join(depth_dir, n[:-3] + "png") for n in names]
        self.sfm_depth_paths = [os.path.join(sfm_depth_dir, n[:-3] + "png") for n in names]
        self.focal_length = FOCAL_LENGTH.get(dataset_name.lower(), 256.0)

    def __len__(self):
        return len(self.rgb_paths)

    def __getitem__(self, idx: int) -> PriorExample:
        rgb = _imread(self.rgb_paths[idx])[:, :, ::-1]
        raw_size = rgb.shape[:2]

        depth_raw = _imread(self.depth_paths[idx], unchanged=True)
        depth = depth_raw.astype(np.float64) / 1000.0  # mm → m (:399-402)
        invalid = depth < 1e-8
        depth = (depth / max(depth.max(), 1e-8) * 60000).astype(np.uint16)
        disp = 1.0 / (depth.astype(np.float64) + 1e-8)
        disp[invalid] = 0
        disp = (disp / max(disp.max(), 1e-8) * 60000).astype(np.uint16)

        H, W = self.crop_size
        rgb_r = cv2.resize(rgb, (W, H), interpolation=cv2.INTER_LINEAR)
        depth_r = cv2.resize(depth, (W, H), interpolation=cv2.INTER_NEAREST).astype(np.float64)
        disp_r = cv2.resize(disp, (W, H), interpolation=cv2.INTER_NEAREST).astype(np.float64)
        invalid_r = cv2.resize(invalid.astype(np.uint8), (W, H),
                               interpolation=cv2.INTER_NEAREST).astype(bool)

        # normalize to max → 10; invalid → −1 (:607-615)
        depth_r = depth_r / (depth_r.max() + 1e-8) * 10.0
        disp_r = disp_r / (disp_r.max() + 1e-8) * 10.0
        depth_r[invalid_r | (depth_r > 1e7) | (depth_r < 0)] = -1.0
        disp_r[invalid_r | (disp_r > 1e7) | (disp_r < 0)] = -1.0

        return PriorExample(
            rgb=normalize_rgb(rgb_r),
            depth=depth_r.astype(np.float32)[..., None],
            disp=disp_r.astype(np.float32)[..., None],
            planes=np.zeros((H, W), np.uint8),  # no plane annotations (:422)
            focal_length=self.focal_length,
            quality_flg=2,  # finetune data is mid-quality (:188)
            rgb_path=self.rgb_paths[idx],
            depth_path=self.depth_paths[idx],
            sfm_depth_path=self.sfm_depth_paths[idx],
            raw_size=raw_size,
        )

    def load_sfm_depth(self, idx: int) -> np.ndarray:
        """Raw-resolution sparse SfM depth in meters (the dump's alignment target)."""
        return _imread(self.sfm_depth_paths[idx], unchanged=True).astype(np.float64) / 1000.0


def collate(examples: List[PriorExample]) -> dict:
    """Stacks examples into the batch the loss criterion reads
    (multi_depth_model_auxiv2.py:209-341), numpy and HWC as the JAX
    package's ``collate`` gives it; ``prior.train.batch_to_torch`` makes it
    NCHW tensors on a device."""
    return {
        "rgb": np.stack([e.rgb for e in examples]),
        "depth": np.stack([e.depth for e in examples]),
        "disp": np.stack([e.disp for e in examples]),
        "planes": np.stack([e.planes for e in examples]).astype(np.int32),
        "focal_length": np.array([e.focal_length for e in examples], np.float32),
        "quality_flg": np.array([e.quality_flg for e in examples], np.int32),
    }
