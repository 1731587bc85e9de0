"""The yardstick's arithmetic: the chip's peaks, and the work a train step
needs, counted by the family of the configuration (``lib/family.py``;
the metric readers call ``r.family`` themselves). A count here is the
same function of the shape's family, for a caller that holds a shape
alone."""

from __future__ import annotations

from perfbench.lib import family
from perfbench.lib.shape import Shape

# Published dense peaks by torch.cuda.get_device_name(): bf16 tensor-core
# FLOP/s, fp32 FLOP/s outside the tensor cores, HBM bytes/s (NVIDIA's data
# sheet, SXM part, at its 700 W limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12,
                              "hbm_bytes": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    return PEAKS.get(device_name)


def model_flops(s: Shape, batch: int, seq: int) -> float:
    return family.of(s).model_flops(s, batch, seq)


def attention_least_s(s: Shape, batch: int, seq: int, chip: dict) -> float:
    return family.of(s).attention_least_s(s, batch, seq, chip)


def rms_norm_least_s(s: Shape, batch: int, seq: int, chip: dict) -> float:
    return family.of(s).rms_norm_least_s(s, batch, seq, chip)
