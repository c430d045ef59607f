"""Running metric means, image grids, and a TensorBoard writer.

``MeanTracker`` keeps the reference's weighted running means and print
format (train_utils/logging.py:5-34), so a ``metrics.txt`` of the port reads
like the JAX package's. ``Writer`` writes every scalar to ``scalars.jsonl``
and, when ``torch.utils.tensorboard`` imports, to TensorBoard too, under the
reference's tag names (run_scade_scannet.py:1022-1074); images go to
TensorBoard only.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


class MeanTracker:
    """Weighted running means over metric dicts."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sums = {}
        self._count = 0

    def add(self, metrics: dict, weight: float = 1.0):
        for key, value in metrics.items():
            value = float(value)
            if key not in self._sums:
                self._sums[key] = value * weight
            else:
                self._sums[key] += value * weight
        self._count += weight

    def has(self, key: str) -> bool:
        return key in self._sums

    def get(self, key: str) -> float:
        return self._sums[key] / max(self._count, 1e-12)

    def as_dict(self) -> dict:
        return {k: self.get(k) for k in self._sums}

    def print(self, f=None):
        f = f or sys.stdout
        for key in self._sums:
            f.write(f"{key}: {self.get(key)}\n")


def make_image_grid(images) -> np.ndarray:
    """A batch of HWC images stacked into one tall image (torchvision
    make_grid(nrow=1), train_utils/logging.py:49-58); 1-channel images are
    repeated to 3, 4-channel rgbd batches give [rgb | depth] side by side."""
    imgs = np.asarray(images)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    C = imgs.shape[-1]
    if C == 4:
        grid_rgb = np.concatenate(list(imgs[..., :3]), axis=0)
        grid_d = np.concatenate(list(np.repeat(imgs[..., 3:], 3, axis=-1)), axis=0)
        return np.concatenate([grid_rgb, grid_d], axis=1)
    if C == 1:
        imgs = np.repeat(imgs, 3, axis=-1)
    return np.concatenate(list(imgs), axis=0)


class Writer:
    """TensorBoard scalar/image writer beside a JSONL scalar log."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:  # no tensorboard package: scalars.jsonl only
            pass
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalars(self, tag: str, values: dict, step: int):
        if self._tb is not None:
            self._tb.add_scalars(tag, values, step)
        self._jsonl.write(json.dumps({"tag": tag, "values": values, "step": step}) + "\n")

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")

    def add_image(self, tag: str, image, step: int):
        """image: (H, W, 3) float in [0, 1] or uint8."""
        if self._tb is not None:
            img = np.asarray(image)
            if img.dtype != np.uint8:
                img = (255 * img.clip(0, 1)).astype(np.uint8)
            self._tb.add_image(tag, img, step, dataformats="HWC")

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
