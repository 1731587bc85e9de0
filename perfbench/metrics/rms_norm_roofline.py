"""Kernel B4 (``csrc/rms_norm.cu``): the least time a step's RMSNorm
forwards need (the family's ``rms_norm_least_s``, bytes from shapes,
each norm once) over B4's device time in the step (the forward and its
remat recompute), in %."""


def read(r):
    if r.trace is None or r.chip is None:
        return None
    s = r.trace.device_s(lambda name, ranges: "rms_norm_kernel" in name)
    if s <= 0:
        return None
    batch = r.tokens_per_step // int(r.traffic["seq"])
    least = r.family.rms_norm_least_s(r.shape, batch, int(r.traffic["seq"]),
                                      r.chip)
    return 100.0 * least * r.trace.steps / s
