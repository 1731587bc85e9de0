"""Kernels B1-B3 (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``): the least
time the card needs for a step's attention (the family's
``attention_least_s``: the forward once and the backward, from shapes)
over the device time of every flash kernel the step launched (B1, its
remat recompute, B2 with its delta prologue, B3), in %."""

KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def read(r):
    if r.trace is None or r.chip is None:
        return None
    s = r.trace.device_s(lambda name, ranges: any(k in name for k in KERNELS))
    if s <= 0:
        return None
    batch = r.tokens_per_step // int(r.traffic["seq"])
    least = r.family.attention_least_s(r.shape, batch,
                                       int(r.traffic["seq"]), r.chip)
    return 100.0 * least * r.trace.steps / s
