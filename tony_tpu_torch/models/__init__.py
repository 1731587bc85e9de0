"""The flagship LM in PyTorch: config, parameters and KV-cache decoding."""

from tony_tpu_torch.models.decode import (
    DecodeSession,
    GenerateResult,
    advance,
    decode_weights,
    generate,
    init_cache,
)
from tony_tpu_torch.models.transformer import TransformerConfig, init_params

__all__ = [
    "DecodeSession",
    "GenerateResult",
    "TransformerConfig",
    "advance",
    "decode_weights",
    "generate",
    "init_cache",
    "init_params",
]
