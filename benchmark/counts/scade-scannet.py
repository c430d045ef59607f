"""Operations and bytes of one step of the ``scade-scannet`` configuration,
from its shapes: a train step, or a render step (one whole view, which the
render driver's step info describes: its rays and its chunk).

K1 (the positional encoding and the 8x256 MLP, per point) runs on the
coarse network's N_samples points a ray and the fine network's
N_samples + N_importance: a train step's n_rand rays, a view's H x W. Its
operations are 2 per multiply-add; its bytes each input once (points and
directions, 3 floats each, and the network's weights, read by each launch)
and each output once (4 floats a point).

K1's backward (train steps only) is counted from the mathematics of the
gradient, whatever implements it: one multiply-add per weight per point for
the weight gradients, and one per weight whose input leads back to another
weight for the input gradients. That leaves out the encoding's columns of
layer 0 and of the skip layer and the view directions' columns of the view
layer, whose inputs have no weight behind them (the points and directions
carry no gradient). Per point at D=8, W=256, E=57: 587,264 weight-gradient
multiply-adds and 7 x 256 x 256 (the trunk's layers 1-7, the skip layer's
256 hidden columns included) + 256 (density) + 256 x 256 (feature) +
128 x 256 (the view layer's feature columns) + 3 x 128 (RGB) = 557,696
input-gradient ones: 1,144,960, twice the forward's less the input layers'.
Biases' gradients are sums, not counted. At the TF32 rate, as the forward's
count is taken, whatever precision the kernels run in. Its bytes: the
points, directions and upstream gradient in, each weight in and its
gradient out, once.

K2 draws N_importance importance samples from the coarse weights (bins
N_samples - 1 midpoints, weights one fewer) and N_importance P_depth draws
from the fine weights. A call reads bins, weights and draws and writes the
samples; in a render the draws are one row of evenly spaced u that every
ray shares, read once a call. Only a train step's P_depth draws carry a
gradient, so its backward runs once a step: it reads bins, weights, draws
and the samples' gradient and writes the weights' gradient. Bound by bytes:
its operations are a few per entry.

The model's operations are the forward MLPs' in a render, and three times
them in a train step (a forward and a backward of twice its cost).
"""

import math
from typing import Dict

F32 = 4


def nerf_macs(D: int, W: int, E: int) -> int:
    """Multiply-adds per point of the network (the skip after layer 4):
    D layers of width W on an E-wide encoding, the skip's extra rows, the
    density head, the feature layer, the view layer and the RGB head."""
    trunk = E * W + (D - 1) * W * W + E * W
    return trunk + W + W * W + (W + 3) * (W // 2) + (W // 2) * 3


def input_grad_macs(D: int, W: int) -> int:
    """Multiply-adds per point of the input gradients that lead back to a
    weight: the trunk's layers 1 to D-1 (hidden columns only at the skip),
    the density head, the feature layer, the view layer's feature columns
    and the RGB head."""
    return (D - 1) * W * W + W + W * W + (W // 2) * W + 3 * (W // 2)


def encoding_width(config: dict) -> int:
    return 3 + 2 * config["multires"] * 3


def weight_count(config: dict) -> int:
    D, W, E = config["netdepth"], config["netwidth"], encoding_width(config)
    weights = nerf_macs(D, W, E)
    biases = D * W + 1 + W + W // 2 + 3
    return weights + biases


def k2_bytes(rays: int, bins: int, draws: int) -> int:
    """A forward call: bins (R, M), weights (R, M - 1), draws in, samples out."""
    return rays * (bins + (bins - 1) + 2 * draws) * F32


def k2_shared_draws_bytes(rays: int, bins: int, draws: int) -> int:
    """A forward call whose rays share one row of draws, read once."""
    return (rays * (bins + (bins - 1) + draws) + draws) * F32


def k2_backward_bytes(rays: int, bins: int, draws: int) -> int:
    """The backward: bins, weights, draws, the samples' gradient in; the
    weights' gradient out."""
    return rays * (bins + (bins - 1) + 2 * draws + (bins - 1)) * F32


def render_work(config: dict, rays: int, chunk: int) -> Dict[str, float]:
    """A view of ``rays`` rays in chunks of ``chunk``: two K1 launches and
    two K2 calls a chunk."""
    S, I = config["N_samples"], config["N_importance"]
    points = rays * S + rays * (S + I)
    chunks = math.ceil(rays / chunk)
    k1_flops = 2 * nerf_macs(config["netdepth"], config["netwidth"], encoding_width(config)) * points
    return {
        "k1_flops": float(k1_flops),
        "k1_bytes": float(points * (3 + 3 + 4) * F32 + chunks * 2 * weight_count(config) * F32),
        "k2_bytes": float(sum(k2_shared_draws_bytes(min(chunk, rays - k * chunk), S - 1, I)
                              + k2_shared_draws_bytes(min(chunk, rays - k * chunk), S + I - 1, I)
                              for k in range(chunks))),
        "model_flops": float(k1_flops),
    }


def work(config: dict, step: dict) -> Dict[str, float]:
    if "rays" in step:
        return render_work(config, step["rays"], step["chunk"])
    R, S, I = config["N_rand"], config["N_samples"], config["N_importance"]
    D, W = config["netdepth"], config["netwidth"]
    points = R * S + R * (S + I)
    k1_flops = 2 * nerf_macs(D, W, encoding_width(config)) * points
    k1_bytes = points * (3 + 3 + 4) * F32 + 2 * weight_count(config) * F32
    return {
        "k1_flops": float(k1_flops),
        "k1_bytes": float(k1_bytes),
        "k1_backward_flops": float(2 * (nerf_macs(D, W, encoding_width(config))
                                        + input_grad_macs(D, W)) * points),
        "k1_backward_bytes": float(points * (3 + 3 + 4) * F32 + 4 * weight_count(config) * F32),
        "k2_bytes": float(k2_bytes(R, S - 1, I) + k2_bytes(R, S + I - 1, I)
                          + k2_backward_bytes(R, S + I - 1, I)),
        "model_flops": 3.0 * k1_flops,
    }
