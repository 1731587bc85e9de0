"""Train step layer (``models/train.py``): device ms a step of the kernels
launched under the port's ``train.forward`` range (on a mesh the
parameters' gather, then the forward and the loss)."""


def read(r):
    if r.trace is None:
        return None
    s = r.trace.device_s(lambda name, ranges: "train.forward" in ranges)
    return 1000.0 * s / r.trace.steps if s > 0 else None
