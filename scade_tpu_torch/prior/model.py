"""The cIMLE-conditioned monocular depth model, encoder- and decoder-side.

Encoder side (``DepthModelCIMLE``): a ResNeXt101-32x8d (or another zoo
backbone) feature pyramid with AdaIn(z) after conv1 and after layer1/2/3
(reference: ambiguity_aware_prior/lib/models/Resnext_torch.py:336-508 and
:592-768 for the image-conditioned v3 taps), then the LeReS top-down decoder
(network_auxi.py:173-231). Decoder side (``DepthModelCIMLEDec``): the plain
backbone, then a decoder with AdaIn(z) at up to 4 taps (network_auxi.py
:320-520). The counterpart of ``scade_tpu/prior/model.py``.

The modules are named as the reference's state_dict is
(``encoder_modules.*``, ``decoder_modules.*``), so a reference checkpoint
loads with ``load_state_dict(strict=True)`` once ``convert.strip_prefixes``
has removed its wrapper prefixes. The AdaIn dataset statistics (the mean/var
shifts of ``mean_var_adain.npy``) enter the forward as an explicit dict of
tensors, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scade_tpu_torch.prior.blocks import (
    AO,
    FFM,
    FTB,
    AdaIn,
    AdaInV2,
    AuxiBlock,
    BasicBlock,
    BatchNorm2d,
    Bottleneck,
    upsample_align_corners,
)


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    d_latent: int = 32
    layers: Sequence[int] = (3, 4, 23, 3)  # ResNeXt101
    groups: int = 32
    base_width: int = 8
    block: str = "bottleneck"  # "bottleneck" (50/101/152/X101) | "basic" (18/34)
    bottleneck_dims: Sequence[int] = (256, 512, 1024, 2048)
    lateral_out: Sequence[int] = (512, 256, 256, 256)  # cfg.MODEL.LATERAL_OUT
    small: bool = False  # tiny variant for tests

    @property
    def expansion(self) -> int:
        return 1 if self.block == "basic" else 4

    def with_small(self):
        """A shape-compatible small model (layers [1, 1, 1, 1], full widths)."""
        return dataclasses.replace(self, layers=(1, 1, 1, 1), small=True)


# The reference encoder zoo (network_auxi.py:16-50, Resnet.py,
# Resnext_torch.py): (layers, groups, base_width, block).
_BACKBONES = {
    "resnet18": ((2, 2, 2, 2), 1, 64, "basic"),
    "resnet34": ((3, 4, 6, 3), 1, 64, "basic"),
    "resnet50": ((3, 4, 6, 3), 1, 64, "bottleneck"),
    "resnet101": ((3, 4, 23, 3), 1, 64, "bottleneck"),
    "resnet152": ((3, 8, 36, 3), 1, 64, "bottleneck"),
    "resnext101_32x8d": ((3, 4, 23, 3), 32, 8, "bottleneck"),
}


def backbone_config(name: str = "resnext101_32x8d", d_latent: int = 32,
                    **overrides) -> PriorConfig:
    """PriorConfig for a named reference backbone."""
    layers, groups, base_width, block = _BACKBONES[name]
    exp = 1 if block == "basic" else 4
    dims = tuple(p * exp for p in (64, 128, 256, 512))
    return PriorConfig(d_latent=d_latent, layers=layers, groups=groups, base_width=base_width,
                       block=block, bottleneck_dims=dims, **overrides)


def encoder_adain_dims(cfg: PriorConfig):
    """Channels at the 4 encoder AdaIn taps: after conv1 (64) and after
    layer1/2/3."""
    return (64,) + tuple(p * cfg.expansion for p in (64, 128, 256))


def decoder_adain_dims(cfg: PriorConfig):
    """Channels at the 4 decoder AdaIn taps (train_single.py:310-313:
    2048/512/256/256)."""
    return (cfg.bottleneck_dims[3],) + tuple(cfg.lateral_out[:3])


def _zeros(dims) -> Dict[str, torch.Tensor]:
    out = {}
    for i, d in enumerate(dims):
        out[f"mean{i}"] = torch.zeros(d)
        out[f"var{i}"] = torch.zeros(d)
    return out


def zero_shifts(cfg: PriorConfig) -> Dict[str, torch.Tensor]:
    return _zeros(encoder_adain_dims(cfg))


def zero_shifts_dec(cfg: PriorConfig) -> Dict[str, torch.Tensor]:
    return _zeros(decoder_adain_dims(cfg))


def load_mean_var_adain(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Read a reference-format ``mean_var_adain.npy`` (a pickled dict of
    arrays; tools/utils.py:222-245) as float32 tensors."""
    d = np.load(path, allow_pickle=True).item()
    return {k: torch.as_tensor(np.asarray(v, np.float32).squeeze(), device=device)
            for k, v in d.items()}


class ResNeXtCIMLE(nn.Module):
    """4-level feature pyramid (1/4 … 1/32) with AdaIn taps.

    ``adain_version`` "v2": z-only AdaIn MLPs; "v3": image-conditioned
    AdaInV2. ``use_adain=False``: the plain backbone (z and shifts unused).
    """

    def __init__(self, cfg: PriorConfig, use_adain: bool = True, adain_version: str = "v2"):
        super().__init__()
        self.cfg, self.use_adain, self.adain_version = cfg, use_adain, adain_version
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        if use_adain:
            for i, ch in enumerate(encoder_adain_dims(cfg)):
                mod = (AdaInV2(cfg.d_latent, ch) if adain_version == "v3"
                       else AdaIn(cfg.d_latent, ch))
                self.add_module(f"style_mod{i}", mod)
        inplanes = 64
        for li, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
            out_ch = planes * cfg.expansion
            blocks = []
            for b in range(cfg.layers[li]):
                s = stride if b == 0 else 1
                has_ds = b == 0 and (s != 1 or inplanes != out_ch)
                if cfg.block == "basic":
                    blocks.append(BasicBlock(inplanes, planes, s, has_ds))
                else:
                    blocks.append(Bottleneck(inplanes, planes, s, cfg.groups, cfg.base_width,
                                             has_ds))
                inplanes = out_ch
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))

    def _style(self, i, h, z, input_image, shifts):
        if not self.use_adain:
            return h
        mod = getattr(self, f"style_mod{i}")
        if self.adain_version == "v3":
            return mod(h, z, input_image, shifts[f"mean{i}"], shifts[f"var{i}"])
        return mod(h, z, shifts[f"mean{i}"], shifts[f"var{i}"])

    def forward(self, x, z=None, shifts=None, return_adain: bool = False):
        """The 4 feature maps; with ``return_adain`` the 4 activations just
        after the AdaIn taps instead (Resnext_torch.py:486-508)."""
        input_image = x
        x = self._style(0, self.conv1(x), z, input_image, shifts)
        adains = [x]
        x = F.max_pool2d(F.relu(self.bn1(x)), 3, 2, 1)
        features = []
        for li in range(4):
            x = getattr(self, f"layer{li + 1}")(x)
            if li < 3:
                x = self._style(li + 1, x, z, input_image, shifts)
                adains.append(x)
            features.append(x)
        return adains if return_adain else features


class Decoder(nn.Module):
    """LeReS top-down decoder: FTB on the 1/32 map, three FFMs, AO. With
    ``return_auxi`` also the 6 intermediate maps the auxi branch reads
    (network_auxi.py:216-220)."""

    def __init__(self, cfg: PriorConfig):
        super().__init__()
        inch = list(cfg.bottleneck_dims)
        mid = list(cfg.lateral_out[::-1])  # [256, 256, 256, 512]
        self.conv = FTB(inch[3], mid[3])
        self.conv1 = nn.Conv2d(mid[3], mid[2], 3, padding=1)
        self.ffm2 = FFM(inch[2], mid[2], mid[2])
        self.ffm1 = FFM(inch[1], mid[1], mid[1])
        self.ffm0 = FFM(inch[0], mid[0], mid[0])
        self.outconv = AO(mid[0])

    def forward(self, features, return_auxi: bool = False):
        x_32x = self.conv(features[3])
        x_32 = self.conv1(x_32x)
        x_16 = upsample_align_corners(x_32, 2)
        x_8 = self.ffm2(features[2], x_16)
        x_4 = self.ffm1(features[1], x_8)
        x_2 = self.ffm0(features[0], x_4)
        out = self.outconv(x_2)
        if return_auxi:
            return out, [x_32x, x_32, x_16, x_8, x_4, x_2]
        return out


# Decoder-side cIMLE: how many of the 4 taps each version styles.
DEC_TAPS = {"v2": 4, "v3": 4, "v4": 3, "v5": 2, "v6": 1}


class DecoderCIMLE(Decoder):
    """The decoder with AdaIn(z) at the 1/32 features, after the FTB, after
    ffm2 and after ffm1 (network_auxi.py:320-520): z-MLP AdaIn for "v2",
    image-conditioned AdaInV2 with 2× scales (network_auxi.py:290) at the
    first 4/3/2/1 taps for "v3"–"v6"."""

    def __init__(self, cfg: PriorConfig, version: str = "v2"):
        super().__init__(cfg)
        if version not in DEC_TAPS:
            raise ValueError(f"decoder cIMLE supports version v2-v6, got {version!r}")
        self.version, self.n_taps = version, DEC_TAPS[version]
        for i, ch in enumerate(decoder_adain_dims(cfg)[:self.n_taps]):
            self.add_module(f"style_mod{i}", AdaIn(cfg.d_latent, ch) if version == "v2"
                            else AdaInV2(cfg.d_latent, ch, 2.0, 2.0))

    def _style(self, i, h, z, input_image, shifts):
        if i >= self.n_taps:
            return h
        mod = getattr(self, f"style_mod{i}")
        if self.version == "v2":
            return mod(h, z, shifts[f"mean{i}"], shifts[f"var{i}"])
        return mod(h, z, input_image, shifts[f"mean{i}"], shifts[f"var{i}"])

    def forward(self, features, z, shifts, input_image, return_adain: bool = False):
        """The depth logit; with ``return_adain`` the 4 tap activations
        (styled where the version taps; Decoder_cIMLE.get_adain_init_act,
        network_auxi.py:570-616)."""
        f3 = self._style(0, features[3], z, input_image, shifts)
        x_32x = self._style(1, self.conv(f3), z, input_image, shifts)
        x_16 = upsample_align_corners(self.conv1(x_32x), 2)
        x_8 = self._style(2, self.ffm2(features[2], x_16), z, input_image, shifts)
        x_4 = self._style(3, self.ffm1(features[1], x_8), z, input_image, shifts)
        if return_adain:
            return [f3, x_32x, x_8, x_4]
        return self.outconv(self.ffm0(features[0], x_4))


class DepthModelCIMLE(nn.Module):
    """encoder(x, z) → decoder → (B, 1, H, W) depth logit. ``version``: "v2"
    (z-MLP AdaIn, the shipped path) or "v3" (image-conditioned AdaInV2)."""

    def __init__(self, cfg: PriorConfig, version: str = "v2"):
        super().__init__()
        if version not in ("v2", "v3"):
            raise ValueError(f"encoder cIMLE supports version v2/v3, got {version!r}; "
                             "v4-v6 are decoder-side versions")
        self.cfg, self.version = cfg, version
        self.encoder_modules = ResNeXtCIMLE(cfg, adain_version=version)
        self.decoder_modules = Decoder(cfg)

    def forward(self, x, z, shifts, return_adain: bool = False):
        feats = self.encoder_modules(x, z, shifts, return_adain)
        return feats if return_adain else self.decoder_modules(feats)


class DepthModelCIMLEDec(nn.Module):
    """Decoder-side cIMLE: the plain backbone, then ``DecoderCIMLE``
    (RelDepthModel_cIMLE_decoder / DepthModel_cIMLE_v2,
    multi_depth_model_auxiv2.py:115-178, 506-548)."""

    def __init__(self, cfg: PriorConfig, version: str = "v2"):
        super().__init__()
        self.cfg, self.version = cfg, version
        self.encoder_modules = ResNeXtCIMLE(cfg, use_adain=False)
        self.decoder_modules = DecoderCIMLE(cfg, version)

    def forward(self, x, z, shifts, return_adain: bool = False):
        return self.decoder_modules(self.encoder_modules(x), z, shifts, x, return_adain)


class AuxiNetV2(nn.Module):
    """The auxi disparity branch over the decoder's 6 intermediate maps
    (network_auxi.py:77-124): five ``AuxiBlock``s of ``width`` channels,
    each fusing the running map into the next lateral, then AO.
    ``AuxiNetV1`` (network_auxi.py:125-172) is the same at width 256."""

    width = 128

    def __init__(self, cfg: PriorConfig):
        super().__init__()
        mid = list(cfg.lateral_out[::-1])  # the decoder's [256, 256, 256, 512]
        # channels of x_32x, x_32, x_16, x_8, x_4, x_2
        dims = [mid[3], mid[2], mid[2], mid[2], mid[1], mid[0]]
        self.auxi_block1 = AuxiBlock(dims[0] + dims[1], self.width)
        for i in range(2, 6):
            self.add_module(f"auxi_block{i}", AuxiBlock(self.width + dims[i], self.width))
        self.out_conv = AO(self.width)

    def forward(self, auxi_in):
        out = self.auxi_block1(auxi_in[0], auxi_in[1])
        for i, lateral in enumerate(auxi_in[2:], start=2):
            out = getattr(self, f"auxi_block{i}")(out, lateral)
        return self.out_conv(out)


class AuxiNetV1(AuxiNetV2):
    width = 256


class DepthModelBaseline(nn.Module):
    """The plain (non-cIMLE) LeReS model with the auxi disparity branch
    (RelDepthModel / DepthModel, multi_depth_model_auxiv2.py:14-52,451-469):
    the plain backbone of ``cfg``, the decoder, and ``AuxiNetV2`` (width 128,
    ``auxi_version`` "v2") or ``AuxiNetV1`` (256, "v1") on its intermediate
    maps. x (B, 3, H, W) → (depth logit, auxi disparity), each (B, 1, H, W)."""

    def __init__(self, cfg: PriorConfig, auxi_version: str = "v2"):
        super().__init__()
        if auxi_version not in ("v1", "v2"):
            raise ValueError(f"auxi_version is v1 or v2, got {auxi_version!r}")
        self.cfg, self.auxi_version = cfg, auxi_version
        self.encoder_modules = ResNeXtCIMLE(cfg, use_adain=False)
        self.decoder_modules = Decoder(cfg)
        self.auxi_modules = (AuxiNetV1 if auxi_version == "v1" else AuxiNetV2)(cfg)

    def forward(self, x):
        logit, auxi_in = self.decoder_modules(self.encoder_modules(x), return_auxi=True)
        return logit, self.auxi_modules(auxi_in)


def build_prior_model(cfg: PriorConfig, version: str = "v2", cimle_version: str = "enc"
                      ) -> nn.Module:
    """``DepthModelCIMLE`` (z into the encoder, ``cimle_version`` "enc") or
    ``DepthModelCIMLEDec`` ("dec"), as the JAX package's ``init_prior``
    dispatches (multi_depth_model_auxiv2.py:55-178)."""
    if cimle_version == "dec":
        return DepthModelCIMLEDec(cfg, version)
    return DepthModelCIMLE(cfg, version)


def zero_shifts_for(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Zero AdaIn shifts with the dims of ``model``'s taps."""
    if isinstance(model, DepthModelCIMLEDec):
        return zero_shifts_dec(model.cfg)
    return zero_shifts(model.cfg)


def init_weights_(model: nn.Module, generator: torch.Generator, random_stats: bool = True
                  ) -> nn.Module:
    """Seeded weights in place: conv and linear weights lecun-normal (the JAX
    package's init), biases 0, BN scale/bias 1/0 and running statistics drawn
    around 0 and 1, so eval-mode BN does not reduce to the identity; with
    ``random_stats=False`` the running statistics are flax's initial 0 and 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if random_stats:
                    m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=generator))
                    m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=generator))
                else:
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
    return model


def prior_apply(model: nn.Module, shifts: Dict[str, torch.Tensor], x: torch.Tensor,
                z: torch.Tensor, train: bool = False) -> torch.Tensor:
    """The forward. x: (B, 3, H, W) normalized rgb; z: (B, d_latent).
    Returns (B, 1, H, W). ``train`` (the model in train mode) normalizes with
    the batch's statistics and moves every BatchNorm's running statistics,
    in place, as the JAX package's ``prior_apply(train=True)`` returns them."""
    if model.training != train:
        mode = "train" if train else "eval"
        raise ValueError(f"prior_apply(train={train}) runs the model in {mode} mode: "
                         f"call model.{mode}() first")
    return model(x, z, shifts)


def get_adain_init_act(model: nn.Module, shifts: Dict[str, torch.Tensor], x: torch.Tensor,
                       z: torch.Tensor):
    """The 4 AdaIn-tap activations the AdaIn statistics are taken from
    (Resnext_torch.py:486-508; the decoder's for the decoder-side model)."""
    return model(x, z, shifts, return_adain=True)


def prior_inference(model: DepthModelCIMLE, shifts, x, z, rescaled: bool = False,
                    ) -> torch.Tensor:
    """The raw decoder logit (RelDepthModel_cIMLE.inference, :84-113);
    ``rescaled`` applies depth − min + 0.01."""
    depth = prior_apply(model, shifts, x, z)
    if rescaled:
        depth = depth - depth.min() + 0.01
    return depth

