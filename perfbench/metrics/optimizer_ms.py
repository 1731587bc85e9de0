"""Train step layer (``models/train.py``): device ms a step of the kernels
launched under the port's ``train.optimizer`` range (on a mesh the
gradients' reduction, then the global-norm clip and AdamW)."""


def read(r):
    if r.trace is None:
        return None
    s = r.trace.device_s(lambda name, ranges: "train.optimizer" in ranges)
    return 1000.0 * s / r.trace.steps if s > 0 else None
