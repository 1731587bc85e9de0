"""Flagship decoder-only transformer LM: config, parameters and the training
forward.

The same config fields and defaults as the JAX package's
``TransformerConfig``, so one set of values describes the model in both, and
the same stacked ``[L, ...]`` parameter layout and initial scales. fp32
master weights; compute runs in ``cfg.compute_dtype``. ``forward`` is the
dense, single-device trunk of the JAX package's ``forward``: pre-norm
attention (RMSNorm, separate q/k/v projections, RoPE, flash attention with
GQA K/V as they are, output projection) and a SwiGLU MLP per layer, then the
final norm and the logits. On a data-parallel mesh it takes the gathered
(full) parameters; the other mesh axes and MoE trunks wait for the
model-parallel slice of the port.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch.utils import checkpoint

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.ops import (
    apply_rope,
    cached_rope_frequencies,
    flash_attention,
    rms_norm,
)
from tony_tpu_torch.parallel.mesh import mesh_spec

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


def param_roles(cfg: TransformerConfig) -> dict:
    """Logical-axis roles per leaf, the JAX package's table: tp splits
    heads/mlp/vocab, fsdp splits the embed dim, pp stages the stacked layers
    axis, ep splits experts. The single-device trunk places nothing by it;
    the sharded slices of the port will."""
    layer = {
        "ln1": ("layers", None),
        "wq": ("layers", "embed_fsdp", "heads", None),
        "wk": ("layers", "embed_fsdp", "heads", None),
        "wv": ("layers", "embed_fsdp", "heads", None),
        "wo": ("layers", "heads", None, "embed_fsdp"),
        "ln2": ("layers", None),
    }
    if cfg.n_experts:
        layer["router"] = ("layers", None, "expert")
        layer["w_gate"] = ("layers", "expert", "embed_fsdp", "mlp")
        layer["w_up"] = ("layers", "expert", "embed_fsdp", "mlp")
        layer["w_down"] = ("layers", "expert", "mlp", "embed_fsdp")
    else:
        layer["w_gate"] = ("layers", "embed_fsdp", "mlp")
        layer["w_up"] = ("layers", "embed_fsdp", "mlp")
        layer["w_down"] = ("layers", "mlp", "embed_fsdp")
    return {
        "embed": ("vocab", None),
        "layers": layer,
        "final_norm": (None,),
        "unembed": ("embed_fsdp", "vocab"),
    }


def _attention(x, lp, cfg, cos, sin):
    """Pre-norm attention block. x: [b, t, d] in the compute dtype."""
    dt = cfg.compute_dtype
    b, t, d = x.shape
    h = rms_norm(x, lp["ln1"]).to(dt)
    q = (h @ lp["wq"].to(dt).reshape(d, -1)).view(b, t, cfg.n_heads,
                                                   cfg.head_dim)
    k = (h @ lp["wk"].to(dt).reshape(d, -1)).view(b, t, cfg.kv_heads,
                                                   cfg.head_dim)
    v = (h @ lp["wv"].to(dt).reshape(d, -1)).view(b, t, cfg.kv_heads,
                                                   cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal=True)
    return o.to(dt).reshape(b, t, -1) @ lp["wo"].to(dt).reshape(-1, d)


def _dense_mlp(x, lp, cfg):
    """SwiGLU, with silu in fp32."""
    dt = cfg.compute_dtype
    h = rms_norm(x, lp["ln2"]).to(dt)
    g = h @ lp["w_gate"].to(dt)
    u = h @ lp["w_up"].to(dt)
    act = torch.nn.functional.silu(g.float()).to(dt) * u
    return act @ lp["w_down"].to(dt)


def _decoder_layer(x, lp, cfg, cos, sin):
    x = x + _attention(x, lp, cfg, cos, sin)
    return x + _dense_mlp(x, lp, cfg)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" remat policy: keep matrix-product outputs, recompute the
    rest (the JAX package's dots_with_no_batch_dims_saveable; attention's
    batched products live inside the flash kernels)."""
    if op in _MATMULS:
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(cfg: TransformerConfig):
    """``context_fn`` for torch.utils.checkpoint: "full" saves nothing and
    recomputes the whole layer; "dots" saves the matmul outputs."""
    if cfg.remat_policy == "full":
        return checkpoint.noop_context_fn
    if cfg.remat_policy == "dots":
        return functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _save_dots)
    raise ValueError(
        f"unknown remat_policy {cfg.remat_policy!r}; expected full|dots"
    )


def _layer_slices(layers: dict, n_layers: int) -> list[dict]:
    """Per-layer views of the stacked weights. ``unbind`` hands autograd one
    stack of the per-layer gradients instead of a full-size zero tensor
    per layer."""
    names = list(layers)
    columns = [layers[name].unbind(0) for name in names]
    return [dict(zip(names, (col[i] for col in columns)))
            for i in range(n_layers)]


def check_mesh(mesh) -> None:
    """Refuse a mesh whose model-parallel axes (pp, ep, sp, tp) are above
    1: only data parallelism is ported so far."""
    spec = mesh_spec(mesh)
    wide = {a: getattr(spec, a) for a in ("pp", "ep", "sp", "tp")
            if getattr(spec, a) > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} wait for the model-parallel slice (slice 4) "
            f"of the port; only dp may be above 1"
        )


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None, *, return_aux: bool = False):
    """tokens [B, T] int -> logits [B, T, V] in the compute dtype, on the
    device of ``params`` (which are never moved; tokens are). Differentiable
    in the params: B1/B4 forward and B2/B3 backward on the card.

    ``cfg.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, ``cfg.remat_policy`` "full" or "dots").
    ``return_aux=True`` additionally returns the MoE router aux dict, empty
    for the dense configs this trunk runs.

    With a data-parallel ``mesh`` (dp only), ``params`` are the full
    parameters, gathered from the rank's pieces (``make_train_step`` does
    that), and ``tokens`` are this rank's slice of the batch."""
    if mesh is not None:
        check_mesh(mesh)
        d_in = params["layers"]["wq"].shape[1]
        if d_in != cfg.d_model:
            raise ValueError(
                f"forward(mesh=) takes the gathered parameters: wq has "
                f"{d_in} of d_model {cfg.d_model} rows"
            )
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE trunks wait for the model-parallel slice (slice 4) of the "
            "port"
        )
    dt = cfg.compute_dtype
    device = params["embed"].device
    cos, sin = cached_rope_frequencies(cfg.head_dim, cfg.max_seq,
                                       theta=cfg.rope_theta, device=device)
    x = params["embed"][tokens.to(device).long()].to(dt)
    layer_fn = functools.partial(_decoder_layer, cfg=cfg, cos=cos, sin=sin)
    context_fn = _remat_context(cfg) if cfg.remat else None
    for lp in _layer_slices(params["layers"], cfg.n_layers):
        if cfg.remat:
            x = checkpoint.checkpoint(layer_fn, x, lp, use_reentrant=False,
                                      context_fn=context_fn)
        else:
            x = layer_fn(x, lp)
    x = rms_norm(x, params["final_norm"]).to(dt)
    logits = x @ params["unembed"].to(dt)
    return (logits, {}) if return_aux else logits
