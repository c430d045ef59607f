"""The whole train step's share of the card's peak: three times the forward
MLPs' operations of the traced steps over the host-clock time of as many
untraced steps just before the trace (the profiler stretches the traced
window), against the TF32 rate (the highest at which the card takes float32
operands), in %."""

from harness import peaks


def read(trace, ctx):
    if ctx.untraced_s <= 0 or not trace.device_ops() or not ctx.work.get("model_flops"):
        return None
    return 100.0 * ctx.work["model_flops"] / ctx.untraced_s / peaks.TF32_FLOPS
