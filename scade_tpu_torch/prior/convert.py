"""Prior weights between the JAX package's flax trees and the reference's
state_dict names, and loading of reference-format checkpoints.

The name map is the port's own copy of ``scade_tpu/prior/translate.py``'s
(reference names: Resnext_torch.py ResNet_cIMLE, network_auxi.py
Decoder/FTB/FFM/AO/AdaIn, Decoder_cIMLE), for the encoder- and decoder-side
models this package builds.
The baseline model's auxi branch maps as ``translate.py``'s ``auxi`` branch
does. Conventions: flax conv kernel (kH, kW, I/g, O) is torch (O, I/g, kH, kW);
flax Dense (I, O) is Linear (O, I); flax BatchNorm scale/bias and its
batch_stats mean/var are weight/bias/running_mean/running_var.

A JAX-trained flax msgpack reaches the port through
``tools/export_prior_to_torch.py``, which writes these names into a ``.pth``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scade_tpu_torch.prior.model import DEC_TAPS, PriorConfig

_PREFIXES = ("module.", "depth_model.", "model.")


def strip_prefixes(state_dict: dict) -> dict:
    """Remove ``module.`` / ``depth_model.`` / ``model.`` wrapper prefixes
    (net_tools.py strip_prefix_if_present :63-70) and the extra nesting of
    DepthNet_cIMLE (``encoder_modules.encoder.*``, network_auxi.py:655-697)."""
    out = {}
    for k, v in state_dict.items():
        for prefix in _PREFIXES:
            while k.startswith(prefix):
                k = k[len(prefix):]
        out[k.replace("encoder_modules.encoder.", "encoder_modules.")] = v
    return out


def _block_pairs(tli: int, tb: int, has_downsample: bool, block: str):
    ours = f"encoder.layer{tli}_{tb}"
    base = f"encoder_modules.layer{tli}.{tb}"
    n_bn = 2 if block == "basic" else 3
    pairs = []
    for i in range(n_bn):
        pairs += [(f"{base}.conv{i + 1}", f"{ours}.Conv_{i}", "conv"),
                  (f"{base}.bn{i + 1}", f"{ours}.BatchNorm_{i}", "bn")]
    if has_downsample:
        pairs += [(f"{base}.downsample.0", f"{ours}.downsample_conv", "conv"),
                  (f"{base}.downsample.1", f"{ours}.BatchNorm_{n_bn}", "bn")]
    return pairs


def _ftb_pairs(torch_base: str, our_base: str):
    return [
        (f"{torch_base}.conv1", f"{our_base}.Conv_0", "conv"),
        (f"{torch_base}.conv_branch.1", f"{our_base}.Conv_1", "conv"),
        (f"{torch_base}.conv_branch.2", f"{our_base}.BatchNorm_0", "bn"),
        (f"{torch_base}.conv_branch.4", f"{our_base}.Conv_2", "conv"),
    ]


def _adain_pairs(torch_base: str, our_base: str):
    """z-MLP AdaIn: Linear at Sequential indices 0/2/4/6."""
    return [(f"{torch_base}.mlp.{ti}", f"{our_base}.Dense_{fi}", "linear")
            for fi, ti in enumerate((0, 2, 4, 6))]


def _adain_v2_pairs(torch_base: str, our_base: str):
    """AdaIn_v2: convs at Sequential indices 0/3/6, the MLP at 0/2/4."""
    return ([(f"{torch_base}.conv.{ti}", f"{our_base}.Conv_{fi}", "conv")
             for fi, ti in enumerate((0, 3, 6))]
            + [(f"{torch_base}.mlp.{ti}", f"{our_base}.Dense_{fi}", "linear")
               for fi, ti in enumerate((0, 2, 4))])


def _ao_pairs(torch_base: str, our_base: str):
    return [(f"{torch_base}.adapt_conv.0", f"{our_base}.Conv_0", "conv"),
            (f"{torch_base}.adapt_conv.1", f"{our_base}.BatchNorm_0", "bn"),
            (f"{torch_base}.adapt_conv.3", f"{our_base}.Conv_1", "conv")]


def name_map(cfg: PriorConfig, version: str = "v2", adain: bool = True,
             dec_version: Optional[str] = None, auxi: bool = False
             ) -> List[Tuple[str, str, str]]:
    """(torch name, flax path, kind) for every layer of DepthModelCIMLE:
    ``version`` "v2" (AdaIn) or "v3" (AdaIn_v2) encoder taps; ``adain=False``
    the plain backbone. ``dec_version`` "v2"–"v6": DepthModelCIMLEDec, the
    plain backbone and Decoder_cIMLE's taps (translate.py:106-183).
    ``auxi``: the auxi branch's 5 AuxiBlocks and AO (``auxi_modules.*``,
    translate.py:166-180), which DepthModelBaseline adds to the plain
    backbone and decoder."""
    if dec_version is not None:
        adain = False
    pairs = [("encoder_modules.conv1", "encoder.conv1", "conv"),
             ("encoder_modules.bn1", "encoder.BatchNorm_0", "bn")]
    if adain:
        fn = _adain_v2_pairs if version == "v3" else _adain_pairs
        for i in range(4):
            pairs += fn(f"encoder_modules.style_mod{i}", f"encoder.style_mod{i}")
    inplanes = 64
    for li, planes in enumerate((64, 128, 256, 512)):
        stride = 1 if li == 0 else 2
        out_ch = planes * cfg.expansion
        for b in range(cfg.layers[li]):
            s = stride if b == 0 else 1
            has_ds = b == 0 and (s != 1 or inplanes != out_ch)
            pairs += _block_pairs(li + 1, b, has_ds, cfg.block)
            inplanes = out_ch
    if dec_version is not None:
        fn = _adain_pairs if dec_version == "v2" else _adain_v2_pairs
        for i in range(DEC_TAPS[dec_version]):
            pairs += fn(f"decoder_modules.style_mod{i}", f"decoder.style_mod{i}")
    pairs += _ftb_pairs("decoder_modules.conv", "decoder.conv")
    pairs += [("decoder_modules.conv1", "decoder.conv1", "conv")]
    for name in ("ffm2", "ffm1", "ffm0"):
        pairs += _ftb_pairs(f"decoder_modules.{name}.ftb1", f"decoder.{name}.FTB_0")
        pairs += _ftb_pairs(f"decoder_modules.{name}.ftb2", f"decoder.{name}.FTB_1")
    pairs += _ao_pairs("decoder_modules.outconv", "decoder.outconv")
    if auxi:
        for bi in range(1, 6):
            tb, ob = f"auxi_modules.auxi_block{bi}", f"auxi.auxi_block{bi}"
            pairs += [(f"{tb}.conv{i + 1}", f"{ob}.Conv_{i}", "conv") for i in range(2)]
            pairs += [(f"{tb}.bn{i + 1}", f"{ob}.BatchNorm_{i}", "bn") for i in range(2)]
        pairs += _ao_pairs("auxi_modules.out_conv", "auxi.out_conv")
    return pairs


def _node(tree: dict, path: str) -> dict:
    for part in path.split("."):
        tree = tree[part]
    return tree


def _leaf(tree: dict, path: str, leaf: str) -> np.ndarray:
    return np.asarray(_node(tree, path)[leaf], np.float32)


def tree_to_state_dict(params: dict, batch_stats: dict, pairs) -> Dict[str, torch.Tensor]:
    """flax trees (numpy leaves) → state_dict for the (torch, flax, kind)
    ``pairs``, with the ``num_batches_tracked`` buffer of every BatchNorm."""
    sd = {}

    def put(name, array):
        sd[name] = torch.from_numpy(np.array(array, np.float32, order="C"))

    for tn, fp, kind in pairs:
        if kind == "conv":
            put(tn + ".weight", np.transpose(_leaf(params, fp, "kernel"), (3, 2, 0, 1)))
            if "bias" in _node(params, fp):
                put(tn + ".bias", _leaf(params, fp, "bias"))
        elif kind == "linear":
            put(tn + ".weight", _leaf(params, fp, "kernel").T)
            put(tn + ".bias", _leaf(params, fp, "bias"))
        else:
            put(tn + ".weight", _leaf(params, fp, "scale"))
            put(tn + ".bias", _leaf(params, fp, "bias"))
            put(tn + ".running_mean", _leaf(batch_stats, fp, "mean"))
            put(tn + ".running_var", _leaf(batch_stats, fp, "var"))
            sd[tn + ".num_batches_tracked"] = torch.tensor(0)
    return sd


def state_dict_from_flax(params: dict, batch_stats: dict, cfg: PriorConfig,
                         version: str = "v2", cimle_version: str = "enc"
                         ) -> Dict[str, torch.Tensor]:
    """The JAX package's prior variables (numpy trees) → a state_dict that
    ``build_prior_model(cfg, version, cimle_version)`` loads strictly."""
    dec = version if cimle_version == "dec" else None
    return tree_to_state_dict(params, batch_stats, name_map(cfg, version, dec_version=dec))


def baseline_state_dict_from_flax(params: dict, batch_stats: dict, cfg: PriorConfig
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``DepthModelBaseline`` variables (numpy trees) → a
    state_dict that ``model.DepthModelBaseline(cfg, v)`` loads strictly
    (either auxi width: the names are the same)."""
    return tree_to_state_dict(params, batch_stats, name_map(cfg, adain=False, auxi=True))


def load_prior_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format ``.pth``/``.tar`` holding ``model_state_dict``,
    ``state_dict`` or a bare state_dict → the state_dict with its prefixes
    stripped and every BatchNorm's ``num_batches_tracked`` present (files
    written by ``tools/export_prior_to_torch.py`` carry none)."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = strip_prefixes(raw.get("model_state_dict", raw.get("state_dict", raw)))
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd.setdefault(k[: -len("running_mean")] + "num_batches_tracked", torch.tensor(0))
    return sd


_SPVCNN_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def spvcnn_params_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's SPVCNN params (``scade_tpu/prior/spvcnn.py::init_spvcnn``'s
    pytree, numpy leaves) → ``prior/spvcnn.py::SPVCNN``'s state_dict. A conv
    ``w`` keeps its (ks³, Cin, Cout) layout; a Linear ``w`` (Cin, Cout) is
    the transposed ``weight``, ``b`` its ``bias``; a BN's scale, bias, mean
    and var are its weight, bias, running_mean and running_var."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: dict, prefix: str):
        for key, value in node.items():
            name = f"{prefix}{key}"
            if isinstance(value, dict):
                walk(value, name + ".")
                continue
            a = np.array(value, np.float32)
            if prefix.endswith("bn."):
                name = prefix + _SPVCNN_BN[key]
            elif key == "w" and a.ndim == 2:
                name, a = prefix + "weight", np.ascontiguousarray(a.T)
            elif key == "b":
                name = prefix + "bias"
            out[name] = torch.from_numpy(a)

    walk(params, "")
    return out
