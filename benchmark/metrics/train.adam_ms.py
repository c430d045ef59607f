"""Device ms a step of the kernels launched inside the program's
``scade.train.adam`` spans (``train/step.py::make_train_step`` around
``apply_grads``): both Adam updates and the step's metrics."""


def read(trace, ctx):
    ops = trace.launched_in(trace.ranges("scade.train.adam"))
    if not ops or not trace.steps:
        return None
    return trace.device_us(ops) / trace.steps / 1e3
