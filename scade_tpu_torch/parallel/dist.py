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
  the maps on every rank (``Ranks.gather_rows``);
- the prior's data-parallel step (``prior/train.py --data_parallel``) splits
  the image batch the same way and sums the grads (``Ranks.sum_``); inside
  ``global_batch`` the step's two batch-wide sums, the BatchNorm statistics
  (``prior/blocks.py``, differentiable ``Ranks.all_sum``) and the plane
  loss's count of groups (``prior/losses.py``), run over every rank's images.

The JAX mesh's model axis (``scade_tpu/parallel/mesh.py``, tensor-parallel
NeRF hidden units) is a grid of ranks (``make_grid``): ``world = n_data x
n_model``, rank r at data row ``r // n_model`` and model column
``r % n_model``, as ``make_mesh`` reshapes the devices. The ranks of a data
row share their rays (``Ranks.block`` takes the data index) and each holds
its columns of the sharded layers (``parallel/mesh.py``); the losses and
grads reduce over the ranks of a model column, the data group.

Without a process group a run uses one device, and nothing here is called.
Importing this module initialises nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in the process group: a grid of ``world // n_model``
    data rows by ``n_model`` model columns. ``data_group`` holds the ranks of
    this rank's model column (they split the rays), ``model_group`` those of
    its data row (they split the sharded layers); None is the default group,
    which with ``n_model == 1`` is the data group."""

    rank: int
    world: int
    n_model: int = 1
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def primary(self) -> bool:
        return self.rank == 0

    @property
    def n_data(self) -> int:
        return self.world // self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def block(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows, by its data index (the
        ranks of a data row share it); ``n`` must divide evenly over the data
        rows."""
        if n % self.n_data:
            raise ValueError(f"{n} rows do not split evenly over {self.n_data} ranks")
        per = n // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def sum_(self, tensors: List[torch.Tensor], everywhere: bool = False) -> None:
        """Sums each tensor over the data group (``everywhere``: over every
        rank), in place, in one collective."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=None if everywhere else self.data_group)
        off = 0
        for t in tensors:
            t.copy_(flat[off: off + t.numel()].view_as(t))
            off += t.numel()

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data group, differentiable: the backward
        sums the ranks' output grads, so every rank's input gets the grad of
        the sum of all ranks' losses."""
        return _AllSum.apply(x, self.data_group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the data group, differentiable
        (``all_sum``): a loss scaled by 1/n_data on every rank and grads
        summed over the data group give the grad of the global loss."""
        return self.all_sum(x) / self.n_data

    def model_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's pieces of a tensor split along ``dim``, joined in
        model-column order, differentiable. The backward is this rank's slice
        of the output's grad: the ranks of a data row compute what follows on
        the same rays, so each holds the whole grad already."""
        return _ModelGather.apply(x, dim, self.n_model, self.model_index, self.model_group)

    def model_copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it is, whose grad is summed over the model group: the
        input of a column-parallel layer, whose grad on each rank comes from
        that rank's columns alone."""
        return _ModelCopy.apply(x, self.model_group)

    def hosts(self) -> int:
        """How many hosts the ranks run on: their distinct host names,
        gathered over the group (either launcher)."""
        names = [None] * self.world
        dist.all_gather_object(names, socket.gethostname())
        return len(set(names))

    def gather_rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """Every data row's ``x`` (its block of ``per`` rows, ``per`` equal on
        all ranks) stacked in data order and cut to ``n`` rows, on every
        rank. A sum of zero-padded blocks over the data group: all_reduce is
        the one collective gloo runs on CUDA tensors as well, and adding
        zeros is exact."""
        per = x.shape[0]
        full = x.new_zeros((per * self.n_data,) + tuple(x.shape[1:]))
        full[self.data_index * per: (self.data_index + 1) * per] = x
        dist.all_reduce(full, group=self.data_group)
        return full[:n]


def make_grid(n_model: int) -> Ranks:
    """The process group as ``world // n_model`` data rows by ``n_model``
    model columns (``scade_tpu/parallel/mesh.py::make_mesh``). Every rank
    must call it, in the same order as the other ranks' calls: it creates
    one group per model column and one per data row. ``n_model == 1`` is
    plain data parallelism over the default group."""
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} ranks not divisible by n_model={n_model}")
    if n_model == 1:
        return Ranks(rank, world)
    n_data = world // n_model
    columns = [dist.new_group([d * n_model + m for d in range(n_data)]) for m in range(n_model)]
    rows = [dist.new_group([d * n_model + m for m in range(n_model)]) for d in range(n_data)]
    return Ranks(rank, world, n_model, data_group=columns[rank % n_model],
                 model_group=rows[rank // n_model])


# The ranks whose blocks make one global batch: set by ``global_batch`` for
# the length of a data-parallel forward and criterion.
_BATCH_RANKS: List[Optional[Ranks]] = [None]


@contextlib.contextmanager
def global_batch(ranks: Optional[Ranks]):
    """Inside the block, whatever reduces over a whole batch reduces over
    every rank's block of it (each rank holds an equal block), as XLA's
    psums do in the JAX package's data-parallel step: the prior's train-mode
    BatchNorm statistics and its plane loss's normalizer. ``None``: this
    process's batch alone."""
    prev = _BATCH_RANKS[0]
    _BATCH_RANKS[0] = ranks
    try:
        yield
    finally:
        _BATCH_RANKS[0] = prev


def batch_ranks() -> Optional[Ranks]:
    """The ranks of the current ``global_batch``, or None."""
    return _BATCH_RANKS[0]


class _AllSum(torch.autograd.Function):
    """all_reduce (sum) over ``group`` (None: the default group), forward and
    backward. The group lives on the graph only until the backward has run
    (``torch.distributed.nn``'s deprecated ``all_reduce`` keeps it on the
    graph for good, so a graph that outlives the run keeps the group alive
    past ``destroy``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        ctx.group = None
        return g, None


class _ModelGather(torch.autograd.Function):
    """All-gather along ``dim`` over the model group, as a sum of zero-padded
    pieces (gloo gathers no CUDA tensors; adding zeros is exact). Backward:
    this rank's slice of the grad, not a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, dim, n, index, group):
        dim = dim % x.dim()
        ctx.dim, ctx.index, ctx.per = dim, index, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= n
        full = x.new_zeros(shape)
        full.narrow(dim, index * ctx.per, ctx.per).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.per, ctx.per), None, None, None, None


class _ModelCopy(torch.autograd.Function):
    """Identity forward; the grad summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        ctx.group = None
        return g, None


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


def launched() -> bool:
    """Whether this process was started as one of several ranks (torchrun's
    ``RANK`` or the JAX CLI's ``SCADE_COORDINATOR`` is set)."""
    return "RANK" in os.environ or "SCADE_COORDINATOR" in os.environ


def ranks_per_host(world: int) -> int:
    """How many of the ``world`` ranks run on this host: torchrun's
    ``LOCAL_WORLD_SIZE``; ranks started through ``SCADE_COORDINATOR`` count
    as one host's."""
    if "RANK" in os.environ:
        return int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return world


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
        local_rank = rank
        init_method = f"tcp://{env['SCADE_COORDINATOR']}"
    elif "RANK" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        init_method = "env://"
    else:
        raise RuntimeError("--multihost: set torchrun's RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT "
                           "(torchrun does) or SCADE_COORDINATOR/SCADE_NUM_PROCESSES/"
                           "SCADE_PROCESS_ID")
    local_world = ranks_per_host(world)
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
