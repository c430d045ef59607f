"""Device ms a step of the kernels launched inside autograd's
``evaluate_function`` ranges: the train step's backward, K1's recompute
through the plain network included."""


def read(trace, ctx):
    ops = trace.launched_in(trace.backward_ops())
    if not ops or not trace.steps:
        return None
    return trace.device_us(ops) / trace.steps / 1e3
