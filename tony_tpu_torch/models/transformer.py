"""Flagship decoder-only transformer LM: config and parameters.

The same config fields and defaults as the JAX package's
``TransformerConfig``, so one set of values describes the model in both, and
the same stacked ``[L, ...]`` parameter layout and initial scales. fp32
master weights; compute runs in ``cfg.compute_dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tony_tpu_torch.device import resolve_device

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    head_dim: int = 64
    d_ff: int = 1408
    max_seq: int = 2048
    rope_theta: float = 10_000.0
    # GQA: number of K/V heads; 0 = n_heads (MHA). The KV cache holds only
    # these heads, a n_heads/n_kv_heads shrink of the decode traffic.
    n_kv_heads: int = 0
    # MoE fields mirror the JAX config; the port's decode path serves dense
    # trunks only in this slice (n_experts > 0 raises there).
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    moe_balance_coef: float = 0.01
    moe_zloss_coef: float = 1e-3
    moe_decode_mode: str = "auto"
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    layer_scan_unroll: int = 1

    @property
    def compute_dtype(self) -> torch.dtype:
        try:
            return _DTYPES[self.dtype]
        except KeyError:
            raise ValueError(
                f"dtype {self.dtype!r} not one of {sorted(_DTYPES)}"
            ) from None

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads or self.n_heads
        if self.n_heads % kv:
            raise ValueError(
                f"n_kv_heads {kv} must divide n_heads {self.n_heads}"
            )
        return kv


def init_params(cfg: TransformerConfig,
                generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """fp32 parameters as a plain dict, per-layer weights stacked on a
    leading ``layers`` axis, with the JAX package's shapes and scales.
    ``generator`` must live on ``device`` (default: one seeded with 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    d, h, dh, f, n = (
        cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers,
    )
    hkv = cfg.kv_heads

    def norm(shape, scale):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * scale

    def ones(shape):
        return torch.ones(shape, device=device, dtype=torch.float32)

    layer = {
        "ln1": ones((n, d)),
        "wq": norm((n, d, h, dh), d ** -0.5),
        "wk": norm((n, d, hkv, dh), d ** -0.5),
        "wv": norm((n, d, hkv, dh), d ** -0.5),
        "wo": norm((n, h, dh, d), (h * dh) ** -0.5),
        "ln2": ones((n, d)),
    }
    if cfg.n_experts:
        e = cfg.n_experts
        layer["router"] = norm((n, d, e), d ** -0.5)
        layer["w_gate"] = norm((n, e, d, f), d ** -0.5)
        layer["w_up"] = norm((n, e, d, f), d ** -0.5)
        layer["w_down"] = norm((n, e, f, d), f ** -0.5)
    else:
        layer["w_gate"] = norm((n, d, f), d ** -0.5)
        layer["w_up"] = norm((n, d, f), d ** -0.5)
        layer["w_down"] = norm((n, f, d), f ** -0.5)
    return {
        "embed": norm((cfg.vocab_size, d), 1.0),
        "layers": layer,
        "final_norm": ones((d,)),
        "unembed": norm((d, cfg.vocab_size), d ** -0.5),
    }
