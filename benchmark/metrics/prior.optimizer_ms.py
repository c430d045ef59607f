"""Device ms a step of the kernels launched inside the program's
``scade.prior.optimizer`` spans (``prior/train.py::train_step`` around
``PriorOptimizer.step``): the global-norm clip and grouped SGD."""


def read(trace, ctx):
    ops = trace.launched_in(trace.ranges("scade.prior.optimizer"))
    if not ops or not trace.steps:
        return None
    return trace.device_us(ops) / trace.steps / 1e3
