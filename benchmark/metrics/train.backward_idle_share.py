"""The share of the traced window's device-idle time (its intervals with
no operation on the card) that overlaps the program's
``scade.train.backward`` spans, in %: how much of the idle time falls while
the caller waits on the backward. The profiler's cost for each host
operation stretches the gaps, so this is a share of the traced idle time,
comparable between runs with the same profiler settings, and not
milliseconds of the untraced step. The spans, one a step on the caller's
thread, do not overlap."""


def read(trace, ctx):
    spans = [(r.ts, r.end) for r in trace.ranges("scade.train.backward")]
    gaps = trace.idle_gaps()
    idle = sum(b - a for a, b in gaps)
    if not spans or idle <= 0 or not trace.device_ops():
        return None
    inside = sum(max(0.0, min(b, d) - max(a, c)) for a, b in gaps for c, d in spans)
    return 100.0 * inside / idle
