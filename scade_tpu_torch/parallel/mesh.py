"""The JAX mesh's model axis for the NeRF: which tensors shard, and how.

Counterpart of ``scade_tpu/parallel/mesh.py``. There a (data, model)
``jax.sharding.Mesh`` shards every hidden layer whose output width is a
multiple of 128 over the model axis, with the Adam moments sharded like
their params, and XLA inserts the collectives. Here the grid is one process
per card (``parallel/dist.py::make_grid``) and the collectives are written
out:

- ``nerf_param_specs`` applies the JAX rule by parameter name: an
  ``nn.Linear`` weight is (out, in), so a 2-D ``weight`` whose out dim is a
  multiple of 128, and a 1-D ``bias`` of such a length, shard on dim 0; at
  the default 8x256 that is the eight ``pts_linears``, ``feature_linear``
  and ``views_linears.0`` (128 out), and not the two heads;
- ``shard_params`` keeps this rank's rows of them and records the sharded
  layers on the model (``NeRF.model_axis``), whose forward then runs them
  column-parallel, and whose K1 launch gathers them whole first
  (``ops/fused_mlp.py::flat_weights``);
- ``state_shardings`` extends the rule to a TrainState by path: the NeRF
  params and, by position, their Adam moments; everything else (scales,
  shifts, their moments, whatever its shape) replicates;
- ``gather_params`` and ``gather_nerf`` return whole tensors, for
  checkpoints and comparisons.

As in the JAX package no CLI flag reaches the model axis: it is a library
path, ``make_train_step(..., ranks=make_grid(n_model))`` on a state made by
``create_train_state(..., grid=...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence

import torch

from scade_tpu_torch.parallel.dist import Ranks

# the JAX rule's unit: a dim shards when it is a multiple of this
SHARD_MULTIPLE = 128


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """What ``shard_params`` records on a NeRF: the grid, and the names of
    the layers whose weight and bias hold this rank's rows."""

    ranks: Ranks
    layers: FrozenSet[str]


def nerf_param_specs(model) -> Dict[str, Optional[int]]:
    """For each parameter of a NeRF, by name, the dim it shards on over the
    model axis (0, the output rows) or None (replicated): the rule of
    ``scade_tpu/parallel/mesh.py::nerf_param_pspecs`` on a whole model, the
    recorded layers on a sharded one."""
    axis = model.model_axis
    specs = {}
    for name, p in model.named_parameters():
        layer, leaf = name.rsplit(".", 1)
        if axis is not None:
            shard = layer in axis.layers
        else:
            shard = ((leaf == "weight" and p.dim() == 2 or leaf == "bias" and p.dim() == 1)
                     and p.shape[0] % SHARD_MULTIPLE == 0)
        specs[name] = 0 if shard else None
    return specs


def _rows(t: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    """This rank's rows of ``t`` (dim 0 split evenly over the model group)."""
    if t.shape[0] % ranks.n_model:
        raise ValueError(f"{t.shape[0]} rows do not split over n_model={ranks.n_model}")
    return t.detach().chunk(ranks.n_model, 0)[ranks.model_index].clone()


def shard_params(model, ranks: Ranks):
    """Keeps, in place, this rank's rows of each tensor ``nerf_param_specs``
    shards, and records the sharded layers on the model. Returns it."""
    if model.model_axis is not None:
        raise ValueError("shard_params: the model is sharded already")
    specs = nerf_param_specs(model)
    layers = {name.rsplit(".", 1)[0] for name, dim in specs.items() if dim is not None}
    for layer in layers:
        if specs[f"{layer}.weight"] is None or specs[f"{layer}.bias"] is None:
            raise ValueError(f"shard_params: {layer}'s weight and bias must shard together")
    with torch.no_grad():
        for name, dim in specs.items():
            if dim is not None:
                p = model.get_parameter(name)
                p.data = _rows(p, ranks)
    model.model_axis = ModelAxis(ranks, frozenset(layers))
    return model


def _models(state):
    models = [("model_coarse", state.model_coarse)]
    if state.model_fine is not state.model_coarse:
        models.append(("model_fine", state.model_fine))
    return models


def state_shardings(state, ranks: Ranks, shard_model: bool = False) -> Dict[str, Optional[int]]:
    """The sharded dim (or None) of every tensor of a TrainState, by path:
    ``model_coarse.<param>``/``model_fine.<param>`` by ``nerf_param_specs``,
    ``opt.mu.<i>``/``opt.nu.<i>`` as the i-th of ``state.nerf_params()``
    (the moments mirror the params by position), and ``scales``, ``shifts``
    and ``ss_opt.*`` replicated whatever their shape. Without
    ``shard_model`` everything replicates. A sharded dim must split evenly
    over ``ranks.n_model``."""
    specs: Dict[str, Optional[int]] = {}
    nerf: List[Optional[int]] = []
    for prefix, model in _models(state):
        for name, dim in nerf_param_specs(model).items():
            if dim is not None and shard_model:
                size = model.get_parameter(name).shape[dim]
                if model.model_axis is None and size % ranks.n_model:
                    raise ValueError(f"{prefix}.{name}: {size} rows do not split over "
                                     f"n_model={ranks.n_model}")
            else:
                dim = None
            specs[f"{prefix}.{name}"] = dim
            nerf.append(dim)
    for i, dim in enumerate(nerf):
        specs[f"opt.mu.{i}"] = specs[f"opt.nu.{i}"] = dim
    specs["scales"] = specs["shifts"] = None
    for i in range(len(state.ss_opt.mu)):
        specs[f"ss_opt.mu.{i}"] = specs[f"ss_opt.nu.{i}"] = None
    return specs


def shard_state(state, ranks: Ranks):
    """Shards a whole TrainState in place by ``state_shardings``: the NeRF
    params (``shard_params``) and their Adam moments. Returns it."""
    specs = state_shardings(state, ranks, shard_model=True)
    for _, model in _models(state):
        shard_params(model, ranks)
    for i in range(len(state.opt.mu)):
        if specs[f"opt.mu.{i}"] is not None:
            state.opt.mu[i] = _rows(state.opt.mu[i], ranks)
            state.opt.nu[i] = _rows(state.opt.nu[i], ranks)
    return state


def nerf_dims(state) -> List[Optional[int]]:
    """The sharded dim (or None) of each of ``state.nerf_params()``."""
    return [dim for _, model in _models(state) for dim in nerf_param_specs(model).values()]


def _whole(t: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    with torch.no_grad():
        return ranks.model_gather(t.detach(), 0)


def gather_nerf(state, tensors: Sequence[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
    """Tensors laid out like ``state.nerf_params()`` (grads, moments), each
    sharded one gathered whole over the model group. Every rank of the
    model group must call it."""
    axis = state.model_coarse.model_axis
    if axis is None:
        return list(tensors)
    return [t if dim is None or t is None else _whole(t, axis.ranks)
            for t, dim in zip(tensors, nerf_dims(state))]


def gather_params(model) -> Dict[str, torch.Tensor]:
    """The model's state_dict with every sharded tensor whole (detached), as
    an unsharded model holds it. Every rank of the model group must call
    it."""
    axis = model.model_axis
    if axis is None:
        return {name: t.detach() for name, t in model.state_dict().items()}
    return {name: (t.detach() if name not in axis.layers and name.rsplit(".", 1)[0]
                   not in axis.layers else _whole(t, axis.ranks))
            for name, t in model.state_dict().items()}
