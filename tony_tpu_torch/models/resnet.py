"""The ResNet family of the JAX package's ``models/resnet.py``: the same
stage plans, parameter tree (``stem``, ``stages`` as a list of lists of
block dicts, ``head``), leaf shapes and init scales, and the same function.

* NHWC activations with HWIO kernels at rest, as in the reference; each
  convolution runs through ``F.conv2d`` on an NCHW (channels_last) view
  with JAX's "SAME" padding (``mnist.conv2d_same``), and the stem's 3x3
  stride-2 max pool pads with -inf the same way.
* Compute in ``cfg.compute_dtype`` on fp32 master weights, cast at use.
* GroupNorm from single-accumulation moments: fp32 E[x^2] - E[x]^2,
  clamped at 0, taken off the activations in their own dtype, as the
  reference computes it (``F.group_norm``'s two-pass variance rounds
  differently).
* Stride-2 projection shortcuts (stride on the 3x3).

Depths 18/34 use basic blocks, 50/101/152 bottlenecks. This path has no
hand-written kernel: the reference computes convolutions and norms
outside any Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.mnist import conv2d_same, map_tree, same_padding
from tony_tpu_torch.models.transformer import _DTYPES

STAGE_PLANS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    width: int = 64          # stem channels; stages are 1x/2x/4x/8x
    n_classes: int = 1000
    gn_groups: int = 8
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        try:
            return _DTYPES[self.dtype]
        except KeyError:
            raise ValueError(
                f"dtype {self.dtype!r} not one of {sorted(_DTYPES)}"
            ) from None

    @property
    def plan(self) -> tuple[str, tuple[int, ...]]:
        try:
            return STAGE_PLANS[self.depth]
        except KeyError:
            raise ValueError(
                f"unsupported depth {self.depth}; legal: {sorted(STAGE_PLANS)}"
            ) from None


def resnet_param_shapes(cfg: ResNetConfig) -> dict:
    """The parameter tree with each leaf's shape (the JAX package's):
    ``stem`` (a 7x7 conv and its GroupNorm), ``stages`` (a list of lists
    of block dicts), ``head``."""
    block_kind, stages = cfg.plan
    expansion = 4 if block_kind == "bottleneck" else 1

    def gn(c):
        return {"scale": (c,), "bias": (c,)}

    tree: dict = {
        "stem": {"conv": (7, 7, 3, cfg.width), "gn": gn(cfg.width)},
        "stages": [],
    }
    cin = cfg.width
    for si, n_blocks in enumerate(stages):
        cmid = cfg.width * (2 ** si)
        cout = cmid * expansion
        blocks = []
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            if block_kind == "basic":
                block = {"conv1": (3, 3, cin, cmid), "gn1": gn(cmid),
                         "conv2": (3, 3, cmid, cout), "gn2": gn(cout)}
            else:
                block = {"conv1": (1, 1, cin, cmid), "gn1": gn(cmid),
                         "conv2": (3, 3, cmid, cmid), "gn2": gn(cmid),
                         "conv3": (1, 1, cmid, cout), "gn3": gn(cout)}
            if stride != 1 or cin != cout:
                block["proj"] = (1, 1, cin, cout)
                block["proj_gn"] = gn(cout)
            blocks.append(block)
            cin = cout
        tree["stages"].append(blocks)
    tree["head"] = {"w": (cin, cfg.n_classes), "b": (cfg.n_classes,)}
    return tree


def resnet_init(cfg: ResNetConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """fp32 parameters with the JAX package's tree, shapes and scales: He
    normal convolutions (sqrt(2 / fan_in)), GroupNorm scale 1 and bias 0,
    a head normal over sqrt(fan_in) with bias 0. ``generator`` must live
    on ``device`` (default: one seeded with 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)

    def leaf(path, shape):
        if path[-1] == "scale":
            return torch.ones(shape, device=device)
        if len(shape) == 1:
            return torch.zeros(shape, device=device)
        fan_in = math.prod(shape[:-1])
        scale = (2.0 / fan_in) ** 0.5 if len(shape) == 4 else fan_in ** -0.5
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * scale

    return map_tree(leaf, resnet_param_shapes(cfg))


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    return conv2d_same(x, w.to(dtype or x.dtype), stride)


def _group_norm(x: torch.Tensor, gn: dict, groups: int,
                eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of NHWC ``x`` over ``min(groups, C)`` channel groups, from
    single-accumulation moments: the mean and the mean square accumulated
    in fp32 straight off ``x``, the variance E[x^2] - E[x]^2 clamped at 0.
    Returns ``x``'s dtype."""
    b, h, w, c = x.shape
    g = min(groups, c)
    xg = x.reshape(b, h, w, g, c // g)
    xf = xg.float()
    mean = torch.mean(xg, dim=(1, 2, 4), keepdim=True, dtype=torch.float32)
    mean2 = torch.mean(xf.square(), dim=(1, 2, 4), keepdim=True)
    inv = torch.rsqrt(torch.clamp_min(mean2 - mean.square(), 0.0) + eps)
    y = (xf - mean) * inv
    y = y.reshape(b, h, w, c) * gn["scale"] + gn["bias"]
    return y.to(x.dtype)


def _block(x, p, kind, stride, groups, dt):
    out = x
    if kind == "basic":
        out = F.relu(_group_norm(_conv(out, p["conv1"], stride, dt),
                                 p["gn1"], groups))
        out = _group_norm(_conv(out, p["conv2"], 1, dt), p["gn2"], groups)
    else:
        out = F.relu(_group_norm(_conv(out, p["conv1"], 1, dt),
                                 p["gn1"], groups))
        out = F.relu(_group_norm(_conv(out, p["conv2"], stride, dt),
                                 p["gn2"], groups))
        out = _group_norm(_conv(out, p["conv3"], 1, dt), p["gn3"], groups)
    if "proj" in p:
        x = _group_norm(_conv(x, p["proj"], stride, dt), p["proj_gn"],
                        groups)
    return F.relu(out + x)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """``lax.reduce_window(x, -inf, max, (1, 3, 3, 1), (1, 2, 2, 1),
    "SAME")`` on NHWC ``x``."""
    (top, bottom), (left, right) = (same_padding(x.shape[1], 3, 2),
                                    same_padding(x.shape[2], 3, 2))
    y = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
              value=-torch.inf)
    return F.max_pool2d(y, 3, 2).permute(0, 2, 3, 1)


def resnet_apply(params: dict, images: torch.Tensor,
                 cfg: ResNetConfig) -> torch.Tensor:
    """images: [B, H, W, 3] -> fp32 logits [B, n_classes]. uint8 images
    are decoded here (cast, then times 1/255 in the compute dtype)."""
    block_kind, _ = cfg.plan
    dt = cfg.compute_dtype
    if images.dtype == torch.uint8:
        x = images.to(dt) * torch.tensor(1.0 / 255.0, dtype=dt,
                                         device=images.device)
    else:
        x = images.to(dt)
    x = _conv(x, params["stem"]["conv"], stride=2, dtype=dt)
    x = F.relu(_group_norm(x, params["stem"]["gn"], cfg.gn_groups))
    x = _max_pool_same(x)
    for si, blocks in enumerate(params["stages"]):
        for bi, bp in enumerate(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            x = _block(x, bp, block_kind, stride, cfg.gn_groups, dt)
    x = x.mean(dim=(1, 2)).float()  # global average pool
    return x @ params["head"]["w"] + params["head"]["b"]
