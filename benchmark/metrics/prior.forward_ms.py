"""Device ms a step of the kernels launched inside the program's
``scade.prior.forward`` spans (``prior/train.py::loss_fn`` around
``prior_apply``): the model's forward in train mode."""


def read(trace, ctx):
    ops = trace.launched_in(trace.ranges("scade.prior.forward"))
    if not ops or not trace.steps:
        return None
    return trace.device_us(ops) / trace.steps / 1e3
