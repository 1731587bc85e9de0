"""The flagship LM in PyTorch: config, parameters, the training forward and
train step, and KV-cache decoding."""

from tony_tpu_torch.models.decode import (
    DecodeSession,
    GenerateResult,
    advance,
    decode_weights,
    generate,
    init_cache,
)
from tony_tpu_torch.models.train import TrainState, lm_loss, make_train_step
from tony_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    forward_pipeline,
    init_params,
    param_roles,
)

__all__ = [
    "DecodeSession",
    "GenerateResult",
    "TrainState",
    "TransformerConfig",
    "advance",
    "decode_weights",
    "forward",
    "forward_pipeline",
    "generate",
    "init_cache",
    "init_params",
    "lm_loss",
    "make_train_step",
    "param_roles",
]
