"""Operations of one fine-tune step of the ``leres-cimle-rx101``
configuration: three times the forward's convolutions and linear layers
(the backward takes two products of the forward's size), 2 per
multiply-add, counted by forward hooks on the reference model run on the
``meta`` device (shapes only). The criterion, BatchNorm and the optimizer
add no counted operations."""

from typing import Dict

import torch

from reference.prior_net import from_config, zero_shifts

_PER_IMAGE: Dict[tuple, int] = {}


def conv_linear_flops(model, x, z, shifts) -> int:
    """Operations (2 per multiply-add) of every Conv2d and Linear in one
    forward of ``model``, counted from their weights and output shapes."""
    total = [0]

    def count(mod, _inputs, out):
        total[0] += 2 * mod.weight[0].numel() * out.numel()  # weight[0]: in/groups·kh·kw

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.inference_mode():
            model(x, z, shifts)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def forward_flops_per_image(config: dict) -> int:
    key = (config["d_latent"], tuple(config["layers"]), config["image_size"], config["version"])
    if key not in _PER_IMAGE:
        with torch.device("meta"):
            model = from_config(config).eval()
            S = config["image_size"]
            x, z = torch.empty((1, 3, S, S)), torch.empty((1, config["d_latent"]))
            shifts = zero_shifts(model, "meta")
            _PER_IMAGE[key] = conv_linear_flops(model, x, z, shifts)
    return _PER_IMAGE[key]


def work(config: dict, step: dict) -> Dict[str, float]:
    return {"model_flops": 3.0 * forward_flops_per_image(config) * step["batch"]}
