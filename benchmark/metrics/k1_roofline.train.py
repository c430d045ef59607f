"""K1's share of its roofline in the train step: the least time its work
could take on the card (the forward MLPs' operations at the TF32 rate, or
its bytes at the HBM rate, whichever is larger: the operations bind) over
the device time of ``fused_mlp_kernel`` launches, in %."""

import re

from harness import peaks

KERNEL = re.compile(r"\bfused_mlp_kernel\b")


def read(trace, ctx):
    ops = trace.named(KERNEL.search)
    if not ops:
        return None
    seconds = trace.device_us(ops) / 1e6
    return 100.0 * peaks.bound_s(ctx.work["k1_flops"], ctx.work["k1_bytes"]) / seconds
