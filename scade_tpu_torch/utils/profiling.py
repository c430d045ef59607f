"""Tracing and numeric-debug hooks.

The counterpart of ``scade_tpu/utils/profiling.py`` (the reference has only a
tic/toc Timer feeding ETA prints, lib/utils/timer.py, and a NaN sweep behind
a DEBUG flag, run_scade_scannet.py:37,747-749):

- ``trace(logdir)``: ``torch.profiler`` around the block (the host, and the
  card where there is one), written to ``logdir/trace.json`` (Chrome trace
  format; TensorBoard and Perfetto read it);
- ``span(name, step)``: the port's one span primitive, a named range on
  that timeline where a profiler records and nothing otherwise;
- ``enable_nan_debugging()``: autograd's anomaly mode, which raises at the
  backward op that produced a NaN and names its forward.

The spans the port opens, and where:

==========================  ===============================================
``scade.train.step``        ``train/step.py``'s step, the whole of it
``scade.train.forward``     the render and the losses (``compute_loss``)
``scade.train.backward``    ``torch.autograd.grad`` (over ranks, the sums)
``scade.train.adam``        both Adam updates and the step's metrics
``scade.k1.recompute``      K1's backward: its kernels
                            (``fused_mlp_backward_cuda``), or the plain
                            network and its ``autograd.grad`` where pts or
                            dirs want a gradient and on the CPU (on
                            autograd's device thread on the card)
``scade.prior.step``        ``prior/train.py::train_step``
``scade.prior.forward``     ``prior_apply`` (and the depth's cast to f32)
``scade.prior.criterion``   ``L.criterion`` and the batch's mean total
``scade.prior.backward``    ``backward()`` through model and criterion
``scade.prior.optimizer``   ``PriorOptimizer.step``: clip and SGD (over
                            ranks, the losses' sum too)
``scade.prior.draws``       ``prior/losses.py::draw_criterion``, the
                            criterion's sampled pairs, which the trainer
                            draws before each step
==========================  ===============================================

In a step, every kernel is launched inside a phase span on the caller's
thread or inside one of autograd's ``evaluate_function`` ranges, but for
the NeRF step's batch sampling, which precedes its forward; in the prior's
loop the draws' span holds the rest. The NeRF's spans carry the state's
step, the prior's the optimizer's update count; the draws, and the
recache's calls of ``loss_fn`` (its forward and criterion spans), carry
none and lie outside any step span.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

TRACE_FILE = "trace.json"

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block; the trace goes to
    ``logdir/trace.json``. Shapes are recorded, and with them each step
    span's step number (the range's ``Concrete Inputs``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=True)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class _Range:
    """``record_function``'s user range, with the step number as its
    argument where there is one: ``record_function``'s own string argument
    does not reach the Chrome trace, a number does."""

    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args: tuple):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(self.name, *self.args)
        return self

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


def span(name: str, step: Optional[int] = None):
    """A named range of the profiler's timeline while a ``torch.profiler``
    records, carrying ``step`` where given, so that the spans of one step
    share it; otherwise a shared no-op context, for the cost of one check."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Range(name, () if step is None else (step,))


def enable_nan_debugging(enable: bool = True) -> None:
    """Raise at the backward op that produces a NaN (autograd's anomaly mode;
    slow, for debugging only)."""
    torch.autograd.set_detect_anomaly(enable)
