"""Device ms a step of the kernels launched inside the program's
``scade.train.backward`` spans (``train/step.py``): the train step's
backward, K1's and K2's backward kernels and autograd's own. A replayed
step launches its backward graph there (one ``cudaGraphLaunch``, whose
kernels the profiler ties to it); an eager step's backward kernels are
launched from autograd's device thread, outside the span's thread, and are
not counted."""


def read(trace, ctx):
    ops = trace.launched_in(trace.ranges("scade.train.backward"))
    if not ops or not trace.steps:
        return None
    return trace.device_us(ops) / trace.steps / 1e3
