"""The share of an untraced step in which no operation runs on the card, in
%: one less the traced steps' device busy time (the union of the device
operations' intervals) over the host-clock time of as many untraced steps
just before the trace. The profiler's own host cost stretches the traced
window, not the device's work, so the traced window is not the denominator."""


def read(trace, ctx):
    if ctx.untraced_s <= 0 or not trace.device_ops():
        return None
    return 100.0 * (1.0 - trace.busy_us() / 1e6 / ctx.untraced_s)
