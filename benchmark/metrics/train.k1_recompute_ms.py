"""Device ms a step of the kernels launched inside the program's
``scade.k1.recompute`` spans (``ops/fused_mlp.py::_FusedMLP.backward``):
K1's backward, the plain network run again and its ``autograd.grad``, on
autograd's device thread. A part of ``train.backward_ms``."""


def read(trace, ctx):
    ops = trace.launched_in(trace.ranges("scade.k1.recompute"))
    if not ops or not trace.steps:
        return None
    return trace.device_us(ops) / trace.steps / 1e3
