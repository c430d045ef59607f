"""K2's share of its roofline in the train step, forward and backward
kernels together: the sum of their bounds (bytes at the HBM rate, which
bind) over the sum of the device times of ``sample_pdf_kernel`` and
``sample_pdf_backward_kernel`` launches, in %."""

import re

from harness import peaks

KERNEL = re.compile(r"\bsample_pdf_(backward_)?kernel\b")


def read(trace, ctx):
    ops = trace.named(KERNEL.search)
    if not ops:
        return None
    seconds = trace.device_us(ops) / 1e6
    return 100.0 * peaks.bound_s(0.0, ctx.work["k2_bytes"]) / seconds
