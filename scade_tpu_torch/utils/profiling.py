"""Tracing, timing and numeric-debug hooks.

The counterpart of ``scade_tpu/utils/profiling.py`` (the reference has only a
tic/toc Timer feeding ETA prints, lib/utils/timer.py, and a NaN sweep behind
a DEBUG flag, run_scade_scannet.py:37,747-749):

- ``trace(logdir)``: ``torch.profiler`` around the block (the host, and the
  card where there is one), written to ``logdir/trace.json`` (Chrome trace
  format; TensorBoard and Perfetto read it);
- ``annotate(name)``: a named range on that timeline, and an NVTX range on
  the card;
- ``enable_nan_debugging()``: autograd's anomaly mode, which raises at the
  backward op that produced a NaN and names its forward;
- ``StepTimer``: per-step wall time with a warm-up and an ETA; once the
  process has started CUDA, each tic and toc first waits for the card, so a
  step's time is the card's too.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block; the trace goes to
    ``logdir/trace.json``."""
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


@contextlib.contextmanager
def annotate(name: str):
    """A named region of the profiler's timeline (``record_function``), and
    an NVTX range where a card is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def enable_nan_debugging(enable: bool = True) -> None:
    """Raise at the backward op that produces a NaN (autograd's anomaly mode;
    slow, for debugging only)."""
    torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    """Running per-step timing and ETA (reference lib/utils/timer.py:1-35 and
    TrainingStats' ETA, lib/utils/training_stats.py:77-88): the first
    ``warmup`` steps are timed but left out of the average. Where the
    process has started CUDA, each tic and toc waits for the card first."""

    def __init__(self, total_steps: Optional[int] = None, warmup: int = 2):
        self.total_steps = total_steps
        self.warmup = warmup
        self.reset()

    def reset(self):
        self._count = 0
        self._sum = 0.0
        self._t0 = None

    @staticmethod
    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def tic(self):
        self._sync()
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._sum += dt
        return dt

    @property
    def average(self) -> float:
        n = max(self._count - self.warmup, 1)
        return self._sum / n

    def eta_seconds(self, step: int) -> Optional[float]:
        if self.total_steps is None or self._count <= self.warmup:
            return None
        return (self.total_steps - step) * self.average

    def eta_string(self, step: int) -> str:
        eta = self.eta_seconds(step)
        if eta is None:
            return "eta --:--"
        h, rem = divmod(int(eta), 3600)
        m, s = divmod(rem, 60)
        return f"eta {h:d}:{m:02d}:{s:02d}"
