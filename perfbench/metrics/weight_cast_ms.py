"""Trunk and MoE layer (``models/transformer.py``): device ms a step of
the kernels launched under the port's ``weight_cast`` range (a master
weight cast to the compute dtype, in the forward and the remat recompute)
or ``bwd:weight_cast`` (its gradient's cast back)."""

RANGES = ("weight_cast", "bwd:weight_cast")


def read(r):
    if r.trace is None:
        return None
    s = r.trace.device_s(
        lambda name, ranges: any(x in RANGES for x in ranges))
    return 1000.0 * s / r.trace.steps if s > 0 else None
