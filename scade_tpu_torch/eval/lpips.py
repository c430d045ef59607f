"""LPIPS(alex), the perceptual metric the reference scores test renders with
(lpips.LPIPS(net='alex'), reference run_scade_scannet.py:371,1254).

The forward is the lpips package's: AlexNet's five conv+ReLU feature maps
(max-pool after the first two), each unit-normalized over channels, squared
differences weighted by the learned 1x1 heads, spatial means summed. The
weights come from the ``.npz`` that ``tools/export_lpips_weights.py`` writes
(the JAX package reads the same file), at ``$SCADE_LPIPS_WEIGHTS`` or
``~/.cache/scade_tpu/lpips_alex.npz``. They are not in the repository and are
never fetched: without the file the metric is NaN, and ``metrics.txt`` keeps
its ``lpips`` column.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (out_ch, kernel, stride, pad) of torchvision AlexNet's features
_ALEX_CFG = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}  # maxpool(3, 2) after these convs

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def default_weights_path() -> str:
    return os.environ.get("SCADE_LPIPS_WEIGHTS",
                          os.path.expanduser("~/.cache/scade_tpu/lpips_alex.npz"))


class LPIPSAlex(nn.Module):
    """Callable on two (H, W, 3) images in [0, 1] (numpy or tensors); returns
    a float, NaN when the weights file is absent."""

    def __init__(self, weights_path: Optional[str] = None):
        super().__init__()
        path = weights_path or default_weights_path()
        self.ok = os.path.exists(path)
        if self.ok:
            data = np.load(path)
            for name in data.files:
                self.register_buffer(name, torch.from_numpy(np.array(data[name], np.float32)))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1))

    def _features(self, x):
        feats = []
        for i, (_, _, stride, pad) in enumerate(_ALEX_CFG):
            x = F.relu(F.conv2d(x, getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b"),
                                stride=stride, padding=pad))
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats

    def distance(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """LPIPS with normalize=True: inputs (H, W, 3) in [0, 1]."""

        def prep(img):
            x = img.float() * 2.0 - 1.0  # [0, 1] → [-1, 1]
            return ((x.permute(2, 0, 1)[None] - self.shift) / self.scale)

        # convolutions in full f32, not cuDNN's TF32 default
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            f0s = self._features(prep(img0))
            f1s = self._features(prep(img1))
        total = torch.zeros((), device=self.shift.device)
        for i, (f0, f1) in enumerate(zip(f0s, f1s)):
            n0 = f0 / torch.sqrt(torch.sum(f0**2, dim=1, keepdim=True) + 1e-10)
            n1 = f1 / torch.sqrt(torch.sum(f1**2, dim=1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}_w").reshape(1, -1, 1, 1)  # learned 1x1 head
            total = total + torch.mean(torch.sum((n0 - n1) ** 2 * w, dim=1))
        return total

    def forward(self, img0, img1) -> float:
        if not self.ok:
            return float("nan")
        dev = self.shift.device
        with torch.no_grad():
            return float(self.distance(torch.as_tensor(img0, device=dev),
                                       torch.as_tensor(img1, device=dev)))
