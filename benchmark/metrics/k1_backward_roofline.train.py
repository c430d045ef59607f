"""K1's backward's share of its roofline in the train step: the least time
the gradient's mathematics could take on the card (its multiply-adds from
``counts/``, 2 operations each, at the TF32 rate, or its bytes at the HBM
rate, whichever is larger: the operations bind) over the device time of the
``k1_backward_*`` kernels, in %."""

import re

from harness import peaks

KERNEL = re.compile(r"\bk1_backward_\w*kernel\b")


def read(trace, ctx):
    ops = trace.named(KERNEL.search)
    if not ops:
        return None
    seconds = trace.device_us(ops) / 1e6
    return 100.0 * peaks.bound_s(ctx.work["k1_backward_flops"],
                                 ctx.work["k1_backward_bytes"]) / seconds
