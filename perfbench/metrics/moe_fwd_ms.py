"""MoE layer (``models/transformer.py``): device ms a step of the kernels
launched under the port's ``moe.route``, ``moe.dispatch``,
``moe.experts`` and ``moe.combine`` ranges (the forward and its remat
recompute; the backward's kernels carry no such range)."""


def read(r):
    if r.trace is None or not r.shape.experts:
        return None
    s = r.trace.device_s(
        lambda name, ranges: any(x.startswith("moe.") for x in ranges))
    return 1000.0 * s / r.trace.steps if s > 0 else None
