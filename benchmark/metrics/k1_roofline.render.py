"""K1's share of its roofline in a test render: the least time a view's
forward MLPs could take on the card (their operations at the TF32 rate, or
their bytes at the HBM rate, whichever is larger: the operations bind) over
the device time of the view's ``fused_mlp_kernel`` launches, in %."""

import re

from harness import peaks

KERNEL = re.compile(r"\bfused_mlp_kernel\b")


def read(trace, ctx):
    ops = trace.named(KERNEL.search)
    if not ops:
        return None
    seconds = trace.device_us(ops) / 1e6
    return 100.0 * peaks.bound_s(ctx.work["k1_flops"], ctx.work["k1_bytes"]) / seconds
