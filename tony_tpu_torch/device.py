"""Device resolution for every entry point of the port.

The port runs on the card unless the caller asks for the CPU: ``"cuda"`` is
the default everywhere, and asking for it on a machine without CUDA raises.
Nothing here, or anywhere in the package, picks the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and
    CUDA is not available, and for device types the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not "
                f"available; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: cuda or cpu")
    return dev
