"""tony_tpu_torch: the PyTorch/CUDA port of tony_tpu's compute plane.

This slice serves the flagship GQA language model on an NVIDIA H100:
``models`` (config, parameters, KV-cache decode, ``DecodeSession``),
``serving`` (the continuous-batching ``ServingEngine`` and its HTTP front
end) and ``ops`` (RMSNorm, RoPE, flash attention). The two TPU kernels on
that path are hand-written CUDA kernels for Hopper under ``csrc/``, built
with ``nvcc`` at first use (``kernels.py``); each has a plain PyTorch twin
that runs when the tensors lie on the CPU.

Every entry point takes ``device=`` and defaults to ``"cuda"``; asking for
CUDA where there is none raises. The package imports torch and numpy, and
nothing of JAX or of ``tony_tpu``.
"""

from tony_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
