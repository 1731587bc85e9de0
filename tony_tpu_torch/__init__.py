"""tony_tpu_torch: the PyTorch/CUDA port of tony_tpu's compute plane.

It serves and trains the flagship LM and trains the image classifiers on an
NVIDIA H100: ``models`` (config, parameters, the training forward,
``lm_loss``, ``make_train_step``, KV-cache decode, ``DecodeSession``; the
MNIST and ResNet classifiers and ``make_image_classifier_step``),
``observability`` (the metrics registry and every train step's anatomy:
phases and live MFU), ``serving`` (the continuous-batching
``ServingEngine`` and its HTTP front end), ``ops`` (RMSNorm, RoPE, flash
attention forward and backward, cross-entropy), ``checkpoint`` (the
``CheckpointManager``, in the JAX package's on-disk format), ``io`` (the
sharded record reader and the device prefetcher) and ``runtime`` (the task
identity, ``torch.distributed`` setup and sharded reader a launched script
needs). The TPU
kernels on those paths are hand-written CUDA kernels for Hopper under
``csrc/``, built with ``nvcc`` at first use (``kernels.py``); each has a plain
PyTorch twin that runs when the tensors lie on the CPU. The CLIs are
``python -m tony_tpu_torch.serve``, ``python -m tony_tpu_torch.train``,
``python -m tony_tpu_torch.generate`` and ``python -m
tony_tpu_torch.mnist_distributed``.

Every entry point takes ``device=`` and defaults to ``"cuda"``; asking for
CUDA where there is none raises. The package imports torch and numpy, and
nothing of JAX or of ``tony_tpu``.
"""

from tony_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
