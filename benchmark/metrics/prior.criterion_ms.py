"""Device ms a step of the criterion (``prior/losses.py``): the kernels
launched inside the ``bench.criterion`` ranges the driver puts around each
call of ``L.criterion`` as ``prior/train.py`` makes it, and those launched
by the backward nodes their operations created (matched by autograd's
sequence numbers)."""


def read(trace, ctx):
    spans = trace.ranges("bench.criterion")
    if not spans or not trace.steps:
        return None
    seqs = trace.sequence_numbers_in(spans)
    backward = [o for o in trace.backward_ops() if o.seq in seqs]
    ops = {id(o): o for o in trace.launched_in(spans) + trace.launched_in(backward)}
    if not ops:
        return None
    return trace.device_us(ops.values()) / trace.steps / 1e3
