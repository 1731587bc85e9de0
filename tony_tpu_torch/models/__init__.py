"""The models of the port: the flagship LM (config, parameters, the
training forward and train step, KV-cache decoding) and the image
classifiers (MNIST MLP and CNN, the ResNet family) with their supervised
step."""

from tony_tpu_torch.models.decode import (
    DecodeSession,
    GenerateResult,
    advance,
    decode_weights,
    generate,
    init_cache,
)
from tony_tpu_torch.models.mnist import MnistConfig, mnist_apply, mnist_init
from tony_tpu_torch.models.resnet import (
    ResNetConfig,
    resnet_apply,
    resnet_init,
)
from tony_tpu_torch.models.train import (
    TrainState,
    lm_loss,
    make_classifier_step,
    make_image_classifier_step,
    make_train_step,
    uint8_image_normalizer,
)
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
    "MnistConfig",
    "ResNetConfig",
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
    "make_classifier_step",
    "make_image_classifier_step",
    "make_train_step",
    "mnist_apply",
    "mnist_init",
    "param_roles",
    "resnet_apply",
    "resnet_init",
    "uint8_image_normalizer",
]
