"""Data parallelism over ranks: the port's form of the JAX package's mesh.

``scade_tpu/parallel/mesh.py`` runs one program over a ``jax.sharding.Mesh``
whose data axis splits the ray batch over devices, with XLA inserting the
psums. PyTorch's form of that is one process per card: ``--multihost``
starts a ``torch.distributed`` process group (NCCL for ``cuda``, gloo for
``cpu``), rank r works on ``cuda:LOCAL_RANK``, and the code reduces by hand
what XLA reduced:

- the train step: every rank draws the whole step's batch and its draws
  from the same per-step generator and keeps its contiguous block of rays
  (``Ranks.block``); losses are scaled by 1/world and the grads summed
  (``Ranks.sum_``), so every rank takes the same Adam step;
- ``is_joint``'s (K, P) mean over rays is averaged over ranks with a
  differentiable collective before its min over K (``Ranks.mean``);
- eval renders split an image's rays into contiguous blocks and reassemble
  the maps on every rank (``Ranks.gather_rows``).

Without a process group a run uses one device, and nothing here is called.
Importing this module initialises nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in the process group."""

    rank: int
    world: int

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def block(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows; ``n`` must divide
        evenly over the ranks."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split evenly over {self.world} ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def sum_(self, tensors: List[torch.Tensor]) -> None:
        """Sums each tensor over the ranks, in place, in one collective."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        off = 0
        for t in tensors:
            t.copy_(flat[off: off + t.numel()].view_as(t))
            off += t.numel()

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks, differentiable: the backward
        sums the ranks' output grads, so a loss scaled by 1/world on every
        rank and grads summed over ranks give the grad of the global loss."""
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(x) / self.world

    def gather_rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """Every rank's ``x`` (its block of ``per`` rows, ``per`` equal on all
        ranks) stacked in rank order and cut to ``n`` rows, on every rank.
        A sum of zero-padded blocks: all_reduce is the one collective gloo
        runs on CUDA tensors as well, and adding zeros is exact."""
        per = x.shape[0]
        full = x.new_zeros((per * self.world,) + tuple(x.shape[1:]))
        full[self.rank * per: (self.rank + 1) * per] = x
        dist.all_reduce(full)
        return full[:n]


def current() -> Optional[Ranks]:
    """The process group's Ranks, or None without one (a one-device run)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return Ranks(dist.get_rank(), dist.get_world_size())


def is_primary() -> bool:
    ranks = current()
    return ranks is None or ranks.primary


def barrier() -> None:
    if current() is not None:
        dist.barrier()


@contextlib.contextmanager
def primary_first():
    """Runs the body on rank 0 first and on the other ranks after it, for
    work that writes a file the others then read (the hypothesis blob)."""
    primary = is_primary()
    if not primary:
        barrier()
    yield
    if primary:
        barrier()


def init_from_env(device: str) -> Tuple[Ranks, str, str]:
    """Starts the process group of ``--multihost``. Rank and world come from
    torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/
    ``MASTER_PORT``, or from the JAX CLI's ``SCADE_COORDINATOR`` (host:port),
    ``SCADE_NUM_PROCESSES`` and ``SCADE_PROCESS_ID`` (run_scade_scannet.py:38-48).
    NCCL for ``cuda``, each rank on ``cuda:LOCAL_RANK``; gloo for ``cpu``,
    and for ``cuda`` when a host runs more ranks than it has cards (NCCL
    refuses two ranks on one card; gloo reduces CUDA tensors through the
    host). Returns (Ranks, the rank's device name, the backend)."""
    env = os.environ
    if "SCADE_COORDINATOR" in env and "RANK" not in env:
        rank, world = int(env["SCADE_PROCESS_ID"]), int(env["SCADE_NUM_PROCESSES"])
        local_rank, local_world = rank, world
        init_method = f"tcp://{env['SCADE_COORDINATOR']}"
    elif "RANK" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        init_method = "env://"
    else:
        raise RuntimeError("--multihost: set torchrun's RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT "
                           "(torchrun does) or SCADE_COORDINATOR/SCADE_NUM_PROCESSES/"
                           "SCADE_PROCESS_ID")
    backend = "gloo"
    if device == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("--device cuda: no CUDA device is available")
        device = f"cuda:{local_rank % cards}"
        torch.cuda.set_device(device)
        if local_world <= cards:
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=30))
    return Ranks(rank, world), device, backend


def destroy() -> None:
    if current() is not None:
        dist.destroy_process_group()
