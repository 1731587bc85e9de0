"""Train step layer (``models/train.py``): device ms a step of the kernels
launched under the port's ``train.backward`` range, which the backward
pass opens on the thread that runs it (the remat recompute included)."""


def read(r):
    if r.trace is None:
        return None
    s = r.trace.device_s(lambda name, ranges: "train.backward" in ranges)
    return 1000.0 * s / r.trace.steps if s > 0 else None
