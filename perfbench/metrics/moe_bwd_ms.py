"""MoE layer (``models/transformer.py``): device ms a step of the kernels
launched under a ``bwd:moe.*`` range (the backward of ``moe.route``,
``moe.dispatch``, ``moe.experts`` and ``moe.combine``, opened on the
thread that runs it) and under no forward range of the layer: the remat
recompute, which runs inside such a range, carries ``moe.*`` (read by
``moe_fwd_ms``) or, for the attention before the layer,
``remat.recompute``. The two metrics count no kernel twice."""

FORWARD = ("moe.", "remat.recompute")


def read(r):
    if r.trace is None or not r.shape.experts:
        return None
    s = r.trace.device_s(
        lambda name, ranges: any(x.startswith("bwd:moe.") for x in ranges)
        and not any(x.startswith(FORWARD) for x in ranges))
    return 1000.0 * s / r.trace.steps if s > 0 else None
