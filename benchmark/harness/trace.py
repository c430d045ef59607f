"""A ``torch.profiler`` trace of the window, reduced to what the per-layer
metrics read.

The traced run wraps its steps in one ``bench.window`` range that ends
after a synchronize, and each step in a ``bench.step`` range. The trace is
taken with CPU and CUDA activities and read from its Chrome-trace export:

- device operations: kernels, copies and sets on the card, each with the
  correlation id of the host call that launched it;
- host operations: the profiler's CPU ops and the benchmark's ranges, with
  their thread, and the autograd sequence number where the profiler gives one;
- launches: the host time and thread of each runtime call, by correlation id.

Times are microseconds on the profiler's clock, which it aligns between
the host and the card. Everything is clipped to the window.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

WINDOW, STEP = "bench.window", "bench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD_PREFIX = "autograd::engine::evaluate_function"


@dataclasses.dataclass
class Op:
    name: str
    ts: float
    end: float
    tid: int = 0
    corr: Optional[int] = None
    seq: Optional[int] = None

    @property
    def dur(self) -> float:
        return self.end - self.ts


def _int(x) -> Optional[int]:
    try:
        return int(x)
    except (TypeError, ValueError):
        return None


class Trace:
    def __init__(self, events: Iterable[dict]):
        self.device: List[Op] = []
        self.host: List[Op] = []
        self.launch: Dict[int, Tuple[float, int]] = {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, ts = e.get("cat"), float(e["ts"])
            end, args = ts + float(e["dur"]), e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append(Op(e["name"], ts, end, corr=_int(args.get("correlation"))))
            elif cat in HOST_CATS:
                self.host.append(Op(e["name"], ts, end, _int(e.get("tid")) or 0,
                                    seq=_int(args.get("Sequence number"))))
            elif cat in LAUNCH_CATS:
                corr = _int(args.get("correlation"))
                if corr is not None:
                    self.launch[corr] = (ts, _int(e.get("tid")) or 0)
        windows = [o for o in self.host if o.name == WINDOW]
        if len(windows) != 1:
            raise ValueError(f"the trace holds {len(windows)} '{WINDOW}' ranges, not one")
        self.t0, self.t1 = windows[0].ts, windows[0].end
        self.steps = sum(1 for o in self.host if o.name == STEP and self.t0 <= o.ts < self.t1)
        self.device.sort(key=lambda o: o.ts)

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as fp:
            data = json.load(fp)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def _clip(self, op: Op) -> float:
        return max(0.0, min(op.end, self.t1) - max(op.ts, self.t0))

    def device_ops(self) -> List[Op]:
        """Device operations that overlap the window."""
        return [o for o in self.device if o.end > self.t0 and o.ts < self.t1]

    def device_us(self, ops: Iterable[Op]) -> float:
        """Summed durations of ``ops`` inside the window."""
        return sum(self._clip(o) for o in ops)

    def named(self, match: Callable[[str], bool]) -> List[Op]:
        return [o for o in self.device_ops() if match(o.name)]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the window."""
        merged: List[List[float]] = []
        for o in self.device_ops():
            a, b = max(o.ts, self.t0), min(o.end, self.t1)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The window's intervals with no device operation running."""
        gaps, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.t1:
            gaps.append((t, self.t1))
        return gaps

    def host_label(self, a: float, b: float) -> str:
        """The host operation that overlaps [a, b] most (the shortest of
        equals), the benchmark's own ranges left out."""
        best, key = "idle host", (0.0, 0.0)
        for o in self.host:
            if o.name in (WINDOW, STEP) or o.end <= a or o.ts >= b:
                continue
            k = (min(o.end, b) - max(o.ts, a), -o.dur)
            if k > key:
                best, key = o.name, k
        return best

    def launched_in(self, ranges: Iterable[Op]) -> List[Op]:
        """Device operations whose launching call lies inside one of the host
        ``ranges`` on the same thread."""
        by_tid: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
        for r in ranges:
            by_tid[r.tid].append((r.ts, r.end))
        starts = {}
        for tid, spans in by_tid.items():
            spans.sort()
            starts[tid] = ([s for s, _ in spans], [e for _, e in spans])
        out = []
        for o in self.device_ops():
            hit = self.launch.get(o.corr)
            if hit is None or hit[1] not in starts:
                continue
            ts, tid = hit
            s, e = starts[tid]
            # ranges may nest: look back over every range that starts before ts
            i = bisect.bisect_right(s, ts) - 1
            while i >= 0:
                if e[i] >= ts:
                    out.append(o)
                    break
                i -= 1
        return out

    def backward_ops(self) -> List[Op]:
        return [o for o in self.host if o.name.startswith(BACKWARD_PREFIX)]

    def ranges(self, name: str) -> List[Op]:
        return [o for o in self.host if o.name == name]

    def sequence_numbers_in(self, ranges: Iterable[Op]) -> set:
        """Autograd sequence numbers of the host ops that run inside ``ranges``
        on their thread: the forward ops whose backward nodes they created."""
        seqs = set()
        spans = [(r.tid, r.ts, r.end) for r in ranges]
        for o in self.host:
            if o.seq is None or o.seq < 0 or o.name.startswith(BACKWARD_PREFIX):
                continue
            if any(o.tid == t and a <= o.ts and o.end <= b for t, a, b in spans):
                seqs.add(o.seq)
        return seqs

    def breakdown(self, n: int = 10, name_len: int = 160) -> dict:
        """The device operations that took most time and the longest idle
        gaps by what the host was doing, in seconds."""
        by_name: Dict[str, float] = defaultdict(float)
        for o in self.device_ops():
            by_name[o.name[:name_len]] += self._clip(o)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v / 1e6] for k, v in top],
                "idle_gaps": [[self.host_label(a, b)[:name_len], (b - a) / 1e6] for a, b in gaps]}
