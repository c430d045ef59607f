"""Operations and bytes of one train step of the ``scade-scannet``
configuration, from its shapes.

K1 (the positional encoding and the 8x256 MLP, per point) runs on the
coarse network's n_rand x N_samples points and the fine network's
n_rand x (N_samples + N_importance) points. Its operations are 2 per
multiply-add; its bytes each input once (points and directions, 3 floats
each, and the network's weights) and each output once (4 floats a point).

K2 draws N_importance importance samples from the coarse weights (bins
N_samples - 1 midpoints, weights one fewer) and N_importance P_depth draws
from the fine weights; only the P_depth draws carry a gradient, so its
backward runs once. A call reads bins, weights and draws and writes the
samples; the backward reads bins, weights, draws and the samples' gradient
and writes the weights' gradient. Bound by bytes: its operations are a few
per entry.

The step's model operations are three times the forward MLPs' (a forward
and a backward of twice its cost); K1's backward recomputes the forward,
which is not counted.
"""

from typing import Dict

F32 = 4


def nerf_macs(D: int, W: int, E: int) -> int:
    """Multiply-adds per point of the network (the skip after layer 4):
    D layers of width W on an E-wide encoding, the skip's extra rows, the
    density head, the feature layer, the view layer and the RGB head."""
    trunk = E * W + (D - 1) * W * W + E * W
    return trunk + W + W * W + (W + 3) * (W // 2) + (W // 2) * 3


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


def k2_backward_bytes(rays: int, bins: int, draws: int) -> int:
    """The backward: bins, weights, draws, the samples' gradient in; the
    weights' gradient out."""
    return rays * (bins + (bins - 1) + 2 * draws + (bins - 1)) * F32


def work(config: dict, step: dict) -> Dict[str, float]:
    R, S, I = config["N_rand"], config["N_samples"], config["N_importance"]
    points = R * S + R * (S + I)
    k1_flops = 2 * nerf_macs(config["netdepth"], config["netwidth"], encoding_width(config)) * points
    k1_bytes = points * (3 + 3 + 4) * F32 + 2 * weight_count(config) * F32
    return {
        "k1_flops": float(k1_flops),
        "k1_bytes": float(k1_bytes),
        "k2_bytes": float(k2_bytes(R, S - 1, I) + k2_bytes(R, S + I - 1, I)
                          + k2_backward_bytes(R, S + I - 1, I)),
        "model_flops": 3.0 * k1_flops,
    }
