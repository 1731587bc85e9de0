"""The MNIST classifiers of the JAX package's ``models/mnist.py``: an MLP and
a CNN of two 3x3 stride-2 convolutions and a dense head, with the same
parameter tree, shapes and init scales.

The weights stay in the JAX package's layout at rest (conv kernels HWIO,
images NHWC), so converted weights and checkpoints carry over unchanged;
``conv2d_same`` runs each convolution through ``F.conv2d`` (cuDNN on the
card) on an NCHW view of the NHWC activations, with JAX's "SAME" padding
(asymmetric where the stride leaves one extra row or column: the extra
one goes after). There is no hand-written kernel on this path: the
reference computes it outside any Pallas kernel too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.transformer import _DTYPES


@dataclass(frozen=True)
class MnistConfig:
    arch: str = "cnn"           # "mlp" | "cnn"
    hidden: int = 128
    n_classes: int = 10
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        try:
            return _DTYPES[self.dtype]
        except KeyError:
            raise ValueError(
                f"dtype {self.dtype!r} not one of {sorted(_DTYPES)}"
            ) from None


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) of JAX's "SAME" padding along one dimension: the
    output has ceil(size / stride) positions, the padding that needs is
    split with the odd one after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1
                ) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, (stride, stride), "SAME",
    ("NHWC", "HWIO", "NHWC"))``: x [B, H, W, Cin], w [kh, kw, Cin, Cout]
    in x's dtype -> [B, H', W', Cout]."""
    kh, kw = w.shape[:2]
    (top, bottom), (left, right) = (same_padding(x.shape[1], kh, stride),
                                    same_padding(x.shape[2], kw, stride))
    x = x.permute(0, 3, 1, 2)  # NCHW view (channels_last when x is NHWC)
    weight = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    if top == bottom and left == right:
        y = F.conv2d(x, weight, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(x, (left, right, top, bottom)), weight,
                     stride=stride)
    return y.permute(0, 2, 3, 1)


def map_tree(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over every leaf of a tree of dicts and lists (the
    path is the tuple of keys and indices), in the tree's own order."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, (*path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def mnist_param_shapes(cfg: MnistConfig) -> dict:
    """The parameter tree with each leaf's shape (the JAX package's)."""
    if cfg.arch == "mlp":
        return {"w1": (784, cfg.hidden), "b1": (cfg.hidden,),
                "w2": (cfg.hidden, cfg.n_classes), "b2": (cfg.n_classes,)}
    # Two 3x3 stride-2 convs (28 -> 14 -> 7) and a dense head.
    return {"c1": (3, 3, 1, 32), "c2": (3, 3, 32, 64),
            "w1": (7 * 7 * 64, cfg.hidden), "b1": (cfg.hidden,),
            "w2": (cfg.hidden, cfg.n_classes), "b2": (cfg.n_classes,)}


def mnist_init(cfg: MnistConfig, generator: torch.Generator | None = None,
               device="cuda") -> dict:
    """fp32 parameters with the JAX package's tree, shapes and scales: a
    weight is normal over sqrt(fan_in) (every dimension but the last),
    a bias zero. ``generator`` must live on ``device`` (default: one
    seeded with 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)

    def leaf(path, shape):
        if len(shape) == 1:
            return torch.zeros(shape, device=device, dtype=torch.float32)
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * math.prod(shape[:-1]) ** -0.5

    return map_tree(leaf, mnist_param_shapes(cfg))


def mnist_apply(params: dict, images: torch.Tensor,
                cfg: MnistConfig) -> torch.Tensor:
    """images: [B, 28, 28, 1] (cnn) or [B, 784] (mlp) -> fp32 logits
    [B, n_classes], computed in ``cfg.compute_dtype``."""
    dt = cfg.compute_dtype
    x = images.to(dt)
    if cfg.arch == "mlp":
        x = x.reshape(x.shape[0], -1)
    else:
        if x.ndim == 2:
            x = x.reshape(-1, 28, 28, 1)
        for w in (params["c1"], params["c2"]):
            x = F.relu(conv2d_same(x, w.to(dt), 2))
        x = x.reshape(x.shape[0], -1)  # NHWC order: w1's rows are (h, w, c)
    x = F.relu(x @ params["w1"].to(dt) + params["b1"].to(dt))
    return (x @ params["w2"].to(dt) + params["b2"].to(dt)).float()
