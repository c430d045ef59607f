"""``.tar`` checkpoints in the reference's schema, read and written.

The reference saves ``{global_step, network_fn_state_dict,
network_fine_state_dict, optimizer_state_dict, depth_shifts, depth_scales
[, embedded_cam]}`` with torch.save to ``<ckpt_dir>/<expname>/{iter:06d}.tar``
(run_scade_scannet.py:1004-1020), its state dicts with DataParallel's
``module.`` prefix. This module writes the same keys from the modules'
``state_dict()``s, ``optimizer_state_dict`` empty, and both Adams' state
under a key of its own, tensors only:

    "scade_tpu_torch": {"opt":    {"mu": {name: t}, "nu": {name: t}, "count": int},
                        "ss_opt": {"mu": {...}, "nu": {...}, "count": int},
                        "version": 1}

with ``coarse.<param>`` / ``fine.<param>`` names for the NeRF Adam and
``scales`` / ``shifts`` for the scale/shift Adam.

Resuming reads whichever optimizer state the file holds:
- this package's key: the moments and counts, exactly;
- the JAX package's ``scade_tpu`` key (optax states): the ``mu``/``nu`` leaves
  mapped to state-dict names through the params tree's paths, exactly. The
  optax classes are unpickled as stand-ins, so neither optax nor JAX is
  imported;
- neither (a reference checkpoint): fresh moments with both counts
  fast-forwarded to ``global_step``, so the staircase LR resumes decayed (the
  reference too resets Adam on resume, run_scade_scannet.py:478-485);
- an optimizer whose entries do not match the model's parameters: that one
  alone is reinitialized, its count fast-forwarded.
"""

from __future__ import annotations

import os
import pickle
import types
from typing import Dict, List, Tuple

import numpy as np
import torch

from scade_tpu_torch.convert import params_to_state_dict
from scade_tpu_torch.models.nerf import NeRF

_KEY = "scade_tpu_torch"
_JAX_KEY = "scade_tpu"
_PREFIX = "module."  # the reference's DataParallel prefix


def find_checkpoints(ckpt_dir: str, expname: str) -> List[str]:
    """Every ``*.tar`` of a run, sorted by name (newest last)."""
    path = os.path.join(ckpt_dir, expname)
    if not os.path.isdir(path):
        return []
    return [os.path.join(path, f) for f in sorted(os.listdir(path)) if f.endswith(".tar")]


def _opt_entries(state) -> Dict[str, Tuple[List[str], list]]:
    """Each optimizer's parameter names, in the order of its moment lists,
    and the optimizer state."""
    names = [f"coarse.{n}" for n, _ in state.model_coarse.named_parameters()]
    if state.model_fine is not state.model_coarse:
        names += [f"fine.{n}" for n, _ in state.model_fine.named_parameters()]
    return {"opt": (names, state.opt), "ss_opt": (["scales", "shifts"], state.ss_opt)}


def _cpu_state_dict(model: NeRF) -> Dict[str, torch.Tensor]:
    return {_PREFIX + k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def save_checkpoint(path: str, state, embedded_cam=None) -> None:
    """A reference-schema ``.tar`` of a ``train.step.TrainState``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    extra = {"version": 1}
    for key, (names, opt) in _opt_entries(state).items():
        extra[key] = {
            "mu": {n: t.detach().cpu().clone() for n, t in zip(names, opt.mu)},
            "nu": {n: t.detach().cpu().clone() for n, t in zip(names, opt.nu)},
            "count": int(opt.count),
        }
    save_dict = {
        "global_step": int(state.step),
        "network_fn_state_dict": _cpu_state_dict(state.model_coarse),
        "network_fine_state_dict": _cpu_state_dict(state.model_fine),
        # the reference keeps torch Adam's state here; the key stays, empty
        "optimizer_state_dict": {},
        "depth_shifts": state.shifts.detach().cpu().clone(),
        "depth_scales": state.scales.detach().cpu().clone(),
        _KEY: extra,
    }
    if embedded_cam is not None:
        save_dict["embedded_cam"] = torch.as_tensor(embedded_cam).detach().cpu().clone()
    torch.save(save_dict, path)


class _Opaque(tuple):
    """Stands in for a class of optax, JAX or flax while unpickling: keeps
    the constructor's arguments (a NamedTuple's fields) and its name."""

    kind = ""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)


class _Unpickler(pickle.Unpickler):
    """Builds the classes of torch, numpy and the standard containers a
    checkpoint holds, stand-ins for those of optax, JAX and flax, and
    refuses any other class."""

    _stand_ins: Dict[str, type] = {}

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in ("optax", "jax", "jaxlib", "flax"):
            kind = f"{module}.{name}"
            if kind not in self._stand_ins:
                self._stand_ins[kind] = type(name, (_Opaque,), {"kind": kind})
            return self._stand_ins[kind]
        if root in ("torch", "numpy", "collections", "_codecs") or (
                module == "builtins" and name in ("set", "frozenset", "slice", "complex")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint holds {module}.{name}, which a checkpoint "
                                     "of the reference, the JAX package or this package "
                                     "never does")


_pickle_module = types.ModuleType("scade_tpu_torch_ckpt_pickle")
_pickle_module.Unpickler = _Unpickler
_pickle_module.load = lambda f, **kw: _Unpickler(f, **kw).load()


def load_checkpoint_raw(path: str) -> dict:
    """The ``.tar`` as saved, on the CPU. Classes of optax, JAX or flax in a
    checkpoint of the JAX package come back as stand-ins (``_Opaque``)."""
    return torch.load(path, map_location="cpu", pickle_module=_pickle_module,
                      weights_only=False)


def _state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    return {k.removeprefix(_PREFIX): v for k, v in sd.items()}


def load_params_from_checkpoint(path: str, rc) -> Tuple[Dict[str, NeRF], int, dict]:
    """({"coarse": NeRF, "fine": NeRF} on ``rc.device``, global_step, raw) from
    a checkpoint of this package, of the JAX package or of the reference.
    "fine" is the coarse model when the file or ``rc`` has no fine network."""
    raw = load_checkpoint_raw(path)
    device = torch.device(rc.device)
    coarse = NeRF(rc.nerf_coarse)
    coarse.load_state_dict(_state_dict(raw["network_fn_state_dict"]), strict=True)
    coarse = coarse.to(device)
    if "network_fine_state_dict" in raw and rc.nerf_fine is not None:
        fine = NeRF(rc.nerf_fine)
        fine.load_state_dict(_state_dict(raw["network_fine_state_dict"]), strict=True)
        fine = fine.to(device)
    else:
        fine = coarse
    return {"coarse": coarse, "fine": fine}, int(raw.get("global_step", 0)), raw


def _from_port(entry) -> Tuple[Dict, Dict, int]:
    return entry["mu"], entry["nu"], int(entry["count"])


def _from_jax(opt_state, key: str, with_fine: bool) -> Tuple[Dict, Dict, int]:
    """mu, nu (state-dict names → arrays) and count of an optax adam state:
    a chain tuple whose ScaleByAdamState holds (count, mu, nu). The JAX
    params tree always has a "fine" entry (the coarse params again when there
    is no fine network); ``with_fine`` says whether the port's model has one."""
    adam = next(s for s in opt_state if getattr(s, "kind", "").endswith("ScaleByAdamState"))
    count, mu, nu = adam
    if key == "ss_opt":
        return dict(mu), dict(nu), int(np.asarray(count))

    def names(tree):
        out = {f"coarse.{k}": v for k, v in params_to_state_dict(tree["coarse"]).items()}
        if with_fine:
            out.update({f"fine.{k}": v for k, v in params_to_state_dict(tree["fine"]).items()})
        return out

    return names(mu), names(nu), int(np.asarray(count))


def load_weights(path: str, state, rc) -> Tuple[int, dict]:
    """Copies a ``.tar``'s weights and depth scales/shifts into ``state`` in
    place, nothing else (a warm start). Returns (global_step, raw)."""
    models, step, raw = load_params_from_checkpoint(path, rc)
    with torch.no_grad():
        state.model_coarse.load_state_dict(models["coarse"].state_dict(), strict=True)
        if state.model_fine is not state.model_coarse:
            state.model_fine.load_state_dict(models["fine"].state_dict(), strict=True)
        for name, t in (("depth_scales", state.scales), ("depth_shifts", state.shifts)):
            if name in raw:
                t.copy_(torch.as_tensor(raw[name], dtype=torch.float32).reshape(t.shape))
    return step, raw


def restore_train_state(path: str, state, rc):
    """Resumes ``state`` (a fresh ``train.step.TrainState``) in place from a
    ``.tar``: weights, scales/shifts and step always, optimizer state as the
    module docstring says. Returns ``state``."""
    step, raw = load_weights(path, state, rc)
    state.step = step

    if _KEY in raw:
        read = lambda key: _from_port(raw[_KEY][key])  # noqa: E731
    elif _JAX_KEY in raw:
        with_fine = state.model_fine is not state.model_coarse
        read = lambda key: _from_jax(raw[_JAX_KEY][f"{key}_state"], key, with_fine)  # noqa: E731
    else:
        read = None
    for key, (names, opt) in _opt_entries(state).items():
        got = None
        if read is not None:
            try:
                got = read(key)
            except (KeyError, TypeError, ValueError, StopIteration, AttributeError):
                got = None
            if got is not None and not _matches(got, names, opt):
                got = None
            if got is None:
                print(f"WARNING: checkpoint {path} holds no usable {key} state for this "
                      f"model; reinitializing its moments and fast-forwarding its count "
                      f"to step {step}")
        with torch.no_grad():
            if got is None:
                for t in opt.mu + opt.nu:
                    t.zero_()
                opt.count = step
            else:
                mu, nu, count = got
                for n, m, v in zip(names, opt.mu, opt.nu):
                    m.copy_(torch.as_tensor(mu[n]))
                    v.copy_(torch.as_tensor(nu[n]))
                opt.count = count
    return state


def _matches(got, names, opt) -> bool:
    mu, nu, _ = got
    if set(mu) != set(names) or set(nu) != set(names):
        return False
    return all(np.shape(mu[n]) == np.shape(nu[n]) == tuple(m.shape)
               for n, m in zip(names, opt.mu))
