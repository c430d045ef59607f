"""Building blocks of the cIMLE depth prior, in NCHW ``nn.Module`` form.

The counterparts of ``scade_tpu/prior/blocks.py`` (reference:
ambiguity_aware_prior/lib/models/network_auxi.py AdaIn :233-264, FTB :709,
FFM :804, AO :851; Resnext_torch.py Bottleneck :84-130, AdaIn_v2
:538-590). Submodules carry the reference's state_dict names (``mlp.{0,2,4,6}``,
``conv.{0,3,6}``, ``conv_branch.{1,2,4}``, ``adapt_conv.{0,1,3}``,
``downsample.{0,1}``), so a reference checkpoint loads into them as it is.
Every BatchNorm is ``BatchNorm2d`` below: eps 1e-5, and in train mode the
JAX package's (flax's) law for the running statistics; inside
``parallel.dist.global_batch(ranks)`` its train-mode statistics are the
global batch's, over every rank's images. The baseline model's auxi branch
adds ``AuxiBlock`` (network_auxi.py:58-75) and ``ASPP`` (:897-946).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scade_tpu_torch.parallel.dist import batch_ranks


def resize_align_corners(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` = (h, w) with aligned corners."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


def upsample_align_corners(x: torch.Tensor, factor: int) -> torch.Tensor:
    return resize_align_corners(x, (x.shape[2] * factor, x.shape[3] * factor))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, the same state_dict) whose train-mode
    forward follows flax's ``nn.BatchNorm(momentum=momentum)``: it normalizes
    with the batch's biased variance, as torch does, but also moves
    ``running_var`` towards that biased variance, where torch would use the
    unbiased one. ``momentum`` is flax's (the share of the old running
    value: 0.9 everywhere but ``AuxiBlock``'s 0.5); torch's is one minus it.
    The statistics are taken in f32 at least, whatever the input's dtype
    (flax's ``force_float32_reductions``). Eval mode is torch's own.

    Inside ``dist.global_batch(ranks)`` the train-mode mean and biased variance
    are the global batch's, in two passes over differentiable all-reduces
    (the sum, then the sum of squared deviations from the global mean: one
    E[x²] − E[x]² pass would cancel digits in f32), so a rank's forward and
    backward are the single-process step's on the global batch and the
    running statistics move identically on every rank."""

    def __init__(self, num_features: int, momentum: float = 0.9):
        super().__init__(num_features, eps=1e-5, momentum=1.0 - momentum)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        ranks = batch_ranks()
        if ranks is not None:
            return self._global_forward(x, ranks)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            var, mean = torch.var_mean(xs, dim=(0, 2, 3), unbiased=False)
            self._update(mean, var)
        return y

    def _update(self, mean, var):
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        self.num_batches_tracked.add_(1)

    def _global_forward(self, x, ranks):
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        n = xs.numel() // xs.shape[1] * ranks.world
        mean = ranks.all_sum(xs.sum((0, 2, 3))) / n
        dev = xs - mean[None, :, None, None]
        var = ranks.all_sum((dev * dev).sum((0, 2, 3))) / n
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = dev * scale[None, :, None, None] + self.bias[None, :, None, None]
        with torch.no_grad():
            self._update(mean, var)
        return y.to(x.dtype)


def _bn(channels: int, momentum: float = 0.9) -> BatchNorm2d:
    return BatchNorm2d(channels, momentum)


def _conv3x3(cin: int, cout: int, bias: bool = True, stride: int = 1, groups: int = 1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, groups=groups, bias=bias)


def _style(x, var, mean, var_scale: float = 1.0, mean_scale: float = 1.0):
    return x * (var[:, :, None, None] * var_scale) + mean[:, :, None, None] * mean_scale


class AdaIn(nn.Module):
    """z → per-channel (scale, shift) through a 512/256/128 MLP:
    ``x·(s0 + 1 − var_shift) + (s1 − mean_shift)``."""

    def __init__(self, d_latent: int, out_channels: int):
        super().__init__()
        self.out_channels = out_channels
        widths = (d_latent, 512, 256, 128)
        layers = []
        for a, b in zip(widths, widths[1:]):
            layers += [nn.Linear(a, b), nn.LeakyReLU(0.01)]
        self.mlp = nn.Sequential(*layers, nn.Linear(128, 2 * out_channels))

    def forward(self, x, z, mean_shift, var_shift):
        s = self.mlp(z).view(-1, 2, self.out_channels)
        return _style(x, s[:, 0] + 1.0 - var_shift, s[:, 1] - mean_shift)


class AdaInV2(nn.Module):
    """Image-conditioned AdaIn: three 3×3 convs (32, 16, 8 channels, each
    followed by a 3×3 max pool of stride 4) over [image ⊕ z broadcast],
    resized to 7×7 where the crop is not 448, flattened channel-major, then a
    128/128 MLP. ``var_scale``/``mean_scale`` are 1 on the encoder side and 2
    on the decoder side (network_auxi.py:290)."""

    def __init__(self, d_latent: int, out_channels: int, var_scale: float = 1.0,
                 mean_scale: float = 1.0):
        super().__init__()
        self.out_channels = out_channels
        self.var_scale, self.mean_scale = var_scale, mean_scale
        layers, cin = [], 3 + d_latent
        for ch in (32, 16, 8):
            layers += [_conv3x3(cin, ch), nn.LeakyReLU(0.01), nn.MaxPool2d(3, 4, 1)]
            cin = ch
        self.conv = nn.Sequential(*layers)
        self.mlp = nn.Sequential(nn.Linear(8 * 7 * 7, 128), nn.LeakyReLU(0.01),
                                 nn.Linear(128, 128), nn.LeakyReLU(0.01),
                                 nn.Linear(128, 2 * out_channels))

    def forward(self, x, z, input_image, mean_shift, var_shift):
        B, _, H, W = input_image.shape
        z_map = z[:, :, None, None].expand(B, z.shape[1], H, W)
        h = self.conv(torch.cat([input_image, z_map], 1))
        if h.shape[2:] != (7, 7):
            h = resize_align_corners(h, (7, 7))
        s = self.mlp(h.flatten(1)).view(B, 2, self.out_channels)
        return _style(x, s[:, 0] + 1.0 - var_shift, s[:, 1] - mean_shift,
                      self.var_scale, self.mean_scale)


class Bottleneck(nn.Module):
    """torchvision ResNet-V1.5 bottleneck: 1×1, grouped 3×3 with the stride,
    1×1; width = planes · base_width/64 · groups."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, groups: int = 32,
                 base_width: int = 8, has_downsample: bool = False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = _bn(width)
        self.conv2 = _conv3x3(width, width, bias=False, stride=stride, groups=groups)
        self.bn2 = _bn(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = _bn(out_ch)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, out_ch, 1, stride=stride, bias=False),
                                         _bn(out_ch)) if has_downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class BasicBlock(nn.Module):
    """torchvision ResNet basic block (Resnet.py:27-56): two 3×3 convs, the
    stride on the first."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = _conv3x3(inplanes, planes, bias=False, stride=stride)
        self.bn1 = _bn(planes)
        self.conv2 = _conv3x3(planes, planes, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                                         _bn(planes)) if has_downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class FTB(nn.Module):
    """Feature-transfer block: conv, then a ReLU-conv-BN-ReLU-conv branch
    added back, then ReLU. The reference's branch starts with an in-place
    ReLU that also rewrites the residual, so the residual is relu(conv1(x));
    that is what ``forward`` computes."""

    def __init__(self, inchannels: int, midchannels: int):
        super().__init__()
        self.conv1 = _conv3x3(inchannels, midchannels)
        self.conv_branch = nn.Sequential(nn.ReLU(), _conv3x3(midchannels, midchannels),
                                         _bn(midchannels), nn.ReLU(),
                                         _conv3x3(midchannels, midchannels))

    def forward(self, x):
        h = F.relu(self.conv1(x))
        return F.relu(h + self.conv_branch(h))


class FFM(nn.Module):
    """Feature fusion: FTB(low) + high → FTB → 2× upsample."""

    def __init__(self, inchannels: int, midchannels: int, outchannels: int):
        super().__init__()
        self.ftb1 = FTB(inchannels, midchannels)
        self.ftb2 = FTB(midchannels, outchannels)

    def forward(self, low_x, high_x):
        return upsample_align_corners(self.ftb2(self.ftb1(low_x) + high_x), 2)


class AO(nn.Module):
    """Adaptive output: conv-BN-ReLU-conv to one channel, then 2× upsample."""

    def __init__(self, inchannels: int):
        super().__init__()
        mid = inchannels // 2
        self.adapt_conv = nn.Sequential(_conv3x3(inchannels, mid), _bn(mid), nn.ReLU(),
                                        _conv3x3(mid, 1))

    def forward(self, x):
        return upsample_align_corners(self.adapt_conv(x), 2)


class AuxiBlock(nn.Module):
    """The auxi branch's fusion block (network_auxi.py:58-75): ``top``
    resized to ``lateral``'s size, [lateral ⊕ top], then a 1×1 conv
    (no bias)-BN-ReLU and a 3×3 conv-BN-ReLU, both BatchNorms of momentum
    0.5."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim_in, dim_out, 1, bias=False)
        self.bn1 = _bn(dim_out, 0.5)
        self.conv2 = _conv3x3(dim_out, dim_out)
        self.bn2 = _bn(dim_out, 0.5)

    def forward(self, top, lateral):
        if top.shape[2:] != lateral.shape[2:]:
            top = resize_align_corners(top, lateral.shape[2:])
        out = F.relu(self.bn1(self.conv1(torch.cat([lateral, top], 1))))
        return F.relu(self.bn2(self.conv2(out)))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (network_auxi.py:897-946): four
    parallel convs (1×1 at rate 1, 3×3 dilated at rates 6, 12, 18), each
    conv-ReLU-BN, concatenated to 4·``planes`` channels."""

    def __init__(self, inchannels: int, planes: int = 128, rates=(1, 6, 12, 18)):
        super().__init__()
        self.rates = tuple(rates)
        for i, rate in enumerate(self.rates):
            k, pad = (1, 0) if rate == 1 else (3, rate)
            self.add_module(f"atrous_{i}", nn.Sequential(
                nn.Conv2d(inchannels, planes, k, padding=pad, dilation=rate), nn.ReLU(),
                _bn(planes)))

    def forward(self, x):
        return torch.cat([getattr(self, f"atrous_{i}")(x) for i in range(len(self.rates))], 1)
