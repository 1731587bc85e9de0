"""Ops of the serving and training paths: RMSNorm and flash attention
(hand-written CUDA kernels on the card, plain PyTorch on the CPU, both
differentiable), RoPE and the cross-entropy loss (plain PyTorch)."""

from tony_tpu_torch.ops.attention import flash_attention, flash_attention_lse
from tony_tpu_torch.ops.losses import (
    softmax_cross_entropy,
    vocab_parallel_cross_entropy,
)
from tony_tpu_torch.ops.norms import rms_norm
from tony_tpu_torch.ops.rope import (
    apply_rope,
    cached_rope_frequencies,
    rope_frequencies,
)

__all__ = [
    "apply_rope",
    "cached_rope_frequencies",
    "flash_attention",
    "flash_attention_lse",
    "rms_norm",
    "rope_frequencies",
    "softmax_cross_entropy",
    "vocab_parallel_cross_entropy",
]
