"""K2's share of its roofline in a test render: its calls' byte bound (at
the HBM rate, which binds) over the device time of the view's
``sample_pdf_kernel`` launches, in %. A render runs no K2 backward."""

import re

from harness import peaks

KERNEL = re.compile(r"\bsample_pdf_kernel\b")


def read(trace, ctx):
    ops = trace.named(KERNEL.search)
    if not ops:
        return None
    seconds = trace.device_us(ops) / 1e6
    return 100.0 * peaks.bound_s(0.0, ctx.work["k2_bytes"]) / seconds
