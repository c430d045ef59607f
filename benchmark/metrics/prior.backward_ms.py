"""Device ms a step of the kernels launched inside autograd's
``evaluate_function`` ranges: the prior step's backward (model and
criterion)."""


def read(trace, ctx):
    ops = trace.launched_in(trace.backward_ops())
    if not ops or not trace.steps:
        return None
    return trace.device_us(ops) / trace.steps / 1e3
