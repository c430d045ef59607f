"""Device ms a step of the kernels launched inside the program's
``scade.train.forward`` spans (``train/step.py::compute_grads`` around
``compute_loss``): the render, K1's and K2's forward launches and the
losses."""


def read(trace, ctx):
    ops = trace.launched_in(trace.ranges("scade.train.forward"))
    if not ops or not trace.steps:
        return None
    return trace.device_us(ops) / trace.steps / 1e3
