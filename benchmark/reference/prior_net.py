"""LeReS's depth network (Yin et al., CVPR 2021) with SCADE's cIMLE AdaIn
taps, written for the benchmark from the method: a ResNeXt101-32x8d
encoder (torchvision's ResNet-V1.5 bottleneck law), AdaIn(z) after the stem
convolution and after layers 1-3, the LeReS top-down decoder (feature
transfer blocks, fusion modules, adaptive output). Plain ``torch.nn``
modules with PyTorch's own BatchNorm; imports nothing of the program.

The submodules carry the upstream checkpoint's names (``encoder_modules``,
``decoder_modules``, ``style_mod{i}.mlp``, ``conv_branch``, ``adapt_conv``),
so the weights the benchmark makes load into this network and into the
program's under the same keys.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

STEM = 64
PLANES = (64, 128, 256, 512)
EXPANSION = 4
DECODER_MID = (256, 256, 256, 512)  # the decoder's widths at 1/4 ... 1/32


def up2(x: torch.Tensor) -> torch.Tensor:
    """Twice the size, bilinear with the corners aligned."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class AdaIn(nn.Module):
    """z → a per-channel gain and offset through an MLP (512, 256, 128,
    leaky ReLU 0.01); the dataset's shifts are taken off both:
    ``x·(1 + gain − var_shift) + offset − mean_shift``."""

    def __init__(self, d_latent: int, channels: int):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Linear(d_latent, 512), nn.LeakyReLU(0.01), nn.Linear(512, 256),
            nn.LeakyReLU(0.01), nn.Linear(256, 128), nn.LeakyReLU(0.01),
            nn.Linear(128, 2 * channels))

    def forward(self, x, z, mean_shift, var_shift):
        gain, offset = self.mlp(z).unflatten(1, (2, -1)).unbind(1)
        gain = 1.0 + gain - var_shift
        offset = offset - mean_shift
        return x * gain[:, :, None, None] + offset[:, :, None, None]


class Bottleneck(nn.Module):
    """1×1 → grouped 3×3 (the stride here) → 1×1 (×4 channels), each
    BatchNorm'd, ReLU between, the shortcut added before the last ReLU."""

    def __init__(self, cin: int, planes: int, stride: int, groups: int, base_width: int):
        super().__init__()
        width = planes * base_width // 64 * groups
        cout = planes * EXPANSION
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout))

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        h = self.bn1(self.conv1(x)).relu()
        h = self.bn2(self.conv2(h)).relu()
        return (self.bn3(self.conv3(h)) + shortcut).relu()


class Encoder(nn.Module):
    """The ResNeXt's four stages (1/4 ... 1/32) with AdaIn taps 0-3."""

    def __init__(self, d_latent: int, layers: Sequence[int], groups: int, base_width: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, STEM, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(STEM)
        taps = (STEM,) + tuple(p * EXPANSION for p in PLANES[:3])
        for i, ch in enumerate(taps):
            self.add_module(f"style_mod{i}", AdaIn(d_latent, ch))
        cin = STEM
        for i, (planes, n) in enumerate(zip(PLANES, layers)):
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(cin, planes, 2 if (b == 0 and i > 0) else 1, groups,
                                         base_width))
                cin = planes * EXPANSION
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def style(self, i: int, x, z, shifts):
        return getattr(self, f"style_mod{i}")(x, z, shifts[f"mean{i}"], shifts[f"var{i}"])

    def forward(self, x, z, shifts, taps: bool = False) -> List[torch.Tensor]:
        """The four stages' maps, or with ``taps`` the four AdaIn outputs."""
        h = self.style(0, self.conv1(x), z, shifts)
        styled = [h]
        h = F.max_pool2d(self.bn1(h).relu(), 3, 2, 1)
        maps = []
        for i in range(4):
            h = getattr(self, f"layer{i + 1}")(h)
            if i < 3:
                h = self.style(i + 1, h, z, shifts)
                styled.append(h)
            maps.append(h)
        return styled if taps else maps


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1)


class FTB(nn.Module):
    """Feature transfer: h = ReLU(conv(x)); ReLU(h + conv(ReLU(BN(conv(h)))))."""

    def __init__(self, cin: int, mid: int):
        super().__init__()
        self.conv1 = conv3x3(cin, mid)
        self.conv_branch = nn.Sequential(nn.ReLU(), conv3x3(mid, mid), nn.BatchNorm2d(mid),
                                         nn.ReLU(), conv3x3(mid, mid))

    def forward(self, x):
        h = self.conv1(x).relu()
        return (h + self.conv_branch(h)).relu()


class FFM(nn.Module):
    """Fusion: FTB of the encoder's map plus the coarser path, FTB, ×2."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.ftb1 = FTB(cin, mid)
        self.ftb2 = FTB(mid, cout)

    def forward(self, lateral, top):
        return up2(self.ftb2(self.ftb1(lateral) + top))


class AO(nn.Module):
    """Adaptive output: conv, BN, ReLU, conv to one channel, ×2."""

    def __init__(self, cin: int):
        super().__init__()
        self.adapt_conv = nn.Sequential(conv3x3(cin, cin // 2), nn.BatchNorm2d(cin // 2),
                                        nn.ReLU(), conv3x3(cin // 2, 1))

    def forward(self, x):
        return up2(self.adapt_conv(x))


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        enc = [p * EXPANSION for p in PLANES]
        m = DECODER_MID
        self.conv = FTB(enc[3], m[3])
        self.conv1 = conv3x3(m[3], m[2])
        self.ffm2 = FFM(enc[2], m[2], m[2])
        self.ffm1 = FFM(enc[1], m[1], m[1])
        self.ffm0 = FFM(enc[0], m[0], m[0])
        self.outconv = AO(m[0])

    def forward(self, maps):
        top = up2(self.conv1(self.conv(maps[3])))
        for i, ffm in ((2, self.ffm2), (1, self.ffm1), (0, self.ffm0)):
            top = ffm(maps[i], top)
        return self.outconv(top)


class DepthNet(nn.Module):
    """rgb (B, 3, S, S), z (B, d_latent), shifts ``mean0..3``/``var0..3`` →
    the depth logit (B, 1, S, S)."""

    def __init__(self, d_latent: int, layers: Sequence[int], groups: int, base_width: int):
        super().__init__()
        self.encoder_modules = Encoder(d_latent, layers, groups, base_width)
        self.decoder_modules = Decoder()

    def forward(self, x, z, shifts):
        return self.decoder_modules(self.encoder_modules(x, z, shifts))

    def taps(self, x, z, shifts) -> List[torch.Tensor]:
        return self.encoder_modules(x, z, shifts, taps=True)

    def tap_channels(self) -> List[int]:
        return [getattr(self.encoder_modules, f"style_mod{i}").mlp[-1].out_features // 2
                for i in range(4)]


def from_config(config: dict) -> DepthNet:
    """The network the configuration file describes."""
    return DepthNet(config["d_latent"], config["layers"], config["groups"],
                    config["base_width"])


def zero_shifts(net: DepthNet, device) -> Dict[str, torch.Tensor]:
    out = {}
    for i, ch in enumerate(net.tap_channels()):
        out[f"mean{i}"] = torch.zeros(ch, device=device)
        out[f"var{i}"] = torch.zeros(ch, device=device)
    return out
