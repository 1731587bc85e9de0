"""The Mistral family (``model_type`` "mistral", and "mixtral" through
``mixtral.py``): the Llama-shaped decoder the port's ``TransformerConfig``
builds. Every layer is RMSNorm, RoPE, causal GQA attention over the whole
sequence, RMSNorm and SwiGLU, or with ``num_local_experts`` the
capacity-based top-k MoE layer; untied embedding and unembedding. Its
plain reference is ``reference/model.py``.

The attention and RMSNorm counts are the B1-B4 bounds of the port's
``chip_smoke.py`` (``fwd_bound``, ``bwd_bounds``, ``time_rms_norm``),
frozen here so that a later change to a kernel is read against the same
work. Work is counted once, whatever implements it: a remat
recomputation, an embedding gather and an empty capacity slot are not
the model's work.
"""

from __future__ import annotations

from dataclasses import dataclass

from perfbench.lib.shape import Shape, run_settings
from perfbench.reference import model as reference

__all__ = ["MistralShape", "shape", "port_config", "leaf_table",
           "matmul_params", "model_flops", "attention_least_s",
           "rms_norm_least_s", "reference"]


@dataclass(frozen=True, kw_only=True)
class MistralShape(Shape):
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    max_seq: int
    theta: float
    eps: float
    top_k: int = 0
    capacity_factor: float = 0.0
    balance_coef: float = 0.0
    zloss_coef: float = 0.0
    remat: str = "full"


def shape(c: dict) -> MistralShape:
    run = c["run"]
    moe = {}
    if c.get("num_local_experts"):
        moe = dict(experts=int(c["num_local_experts"]),
                   top_k=int(c["num_experts_per_tok"]),
                   capacity_factor=float(run["capacity_factor"]),
                   balance_coef=float(c["router_aux_loss_coef"]),
                   zloss_coef=float(run["router_z_loss_coef"]))
    return MistralShape(
        vocab=int(c["vocab_size"]), d=int(c["hidden_size"]),
        layers=int(c["num_hidden_layers"]),
        heads=int(c["num_attention_heads"]),
        kv_heads=int(c["num_key_value_heads"]),
        head_dim=int(c["head_dim"]), ff=int(c["intermediate_size"]),
        max_seq=int(c["max_position_embeddings"]),
        theta=float(c["rope_theta"]), eps=float(c["rms_norm_eps"]),
        remat=run["remat"], **run_settings(c), **moe)


def port_config(s: MistralShape):
    """The port's ``TransformerConfig`` for a configuration file."""
    from tony_tpu_torch.models import TransformerConfig

    if s.eps != 1e-6:
        raise ValueError(f"the port's RMSNorm epsilon is 1e-6; the "
                         f"configuration states {s.eps}")
    if s.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {s.remat!r}")
    return TransformerConfig(
        vocab_size=s.vocab, d_model=s.d, n_layers=s.layers, n_heads=s.heads,
        head_dim=s.head_dim, d_ff=s.ff, max_seq=s.max_seq,
        rope_theta=s.theta, n_kv_heads=s.kv_heads, n_experts=s.experts,
        expert_top_k=s.top_k or 2,
        capacity_factor=s.capacity_factor or 1.25,
        moe_balance_coef=s.balance_coef, moe_zloss_coef=s.zloss_coef,
        dtype=s.compute_dtype, remat=s.remat != "none",
        remat_policy="full" if s.remat == "none" else s.remat)


def leaf_table(s: MistralShape) -> dict:
    """The port's parameter tree: per-layer leaves stacked on a leading
    layer axis, expert leaves [L, E, ...], at the port's initial scales
    (0: ones, the RMSNorm weights). The layer stack comes first, as in
    the tree the reference steps through."""
    d, h, kv, dh, f, n = s.d, s.heads, s.kv_heads, s.head_dim, s.ff, s.layers
    t = {
        "layers.ln1": ((n, d), 0.0, 1),
        "layers.ln2": ((n, d), 0.0, 1),
        "layers.wq": ((n, d, h, dh), d ** -0.5, 1),
        "layers.wk": ((n, d, kv, dh), d ** -0.5, 1),
        "layers.wv": ((n, d, kv, dh), d ** -0.5, 1),
        "layers.wo": ((n, h, dh, d), (h * dh) ** -0.5, 1),
    }
    if s.experts:
        e = s.experts
        t["layers.router"] = ((n, d, e), d ** -0.5, 1)
        t["layers.w_gate"] = ((n, e, d, f), d ** -0.5, 2)
        t["layers.w_up"] = ((n, e, d, f), d ** -0.5, 2)
        t["layers.w_down"] = ((n, e, f, d), f ** -0.5, 2)
    else:
        t["layers.w_gate"] = ((n, d, f), d ** -0.5, 1)
        t["layers.w_up"] = ((n, d, f), d ** -0.5, 1)
        t["layers.w_down"] = ((n, f, d), f ** -0.5, 1)
    t["embed"] = ((s.vocab, d), 1.0, 0)
    t["final_norm"] = ((d,), 0.0, 0)
    t["unembed"] = ((d, s.vocab), d ** -0.5, 0)
    return t


def matmul_params(s: MistralShape) -> int:
    """N of 6 N tokens: the parameters each token multiplies by, the
    unembedding and the router and the top-k experts it is routed to
    included, the embedding (a gather) not."""
    attn = s.d * (s.heads + 2 * s.kv_heads) * s.head_dim \
        + s.heads * s.head_dim * s.d
    mlp = 3 * s.d * s.ff * (s.top_k if s.experts else 1)
    router = s.d * s.experts
    return s.layers * (attn + mlp + router) + s.d * s.vocab


def attention_pairs(s: MistralShape, batch: int, seq: int) -> int:
    """Visible (query, key) pairs of causal attention over all heads."""
    return batch * s.heads * seq * (seq + 1) // 2


def model_flops(s: MistralShape, batch: int, seq: int) -> float:
    """One train step's model FLOPs: 6 N tokens, plus causal attention's
    two products forward and four backward (12 D a visible pair), every
    layer."""
    tokens = batch * seq
    attn = 12 * s.head_dim * attention_pairs(s, batch, seq)
    return 6.0 * matmul_params(s) * tokens + float(s.layers * attn)


def attention_least_s(s: MistralShape, batch: int, seq: int,
                      chip: dict) -> float:
    """The least time one step's attention needs on ``chip``, every layer:
    the forward (two products; q, k, v read, out and lse written) and the
    backward (four products; q, k, v, out, dO, lse read, dq, dk, dv
    written), each bound by the larger of operations and bytes, bf16."""
    pairs = attention_pairs(s, batch, seq)
    e = 2  # bf16
    q = batch * seq * s.heads * s.head_dim * e
    kv = batch * seq * s.kv_heads * s.head_dim * e
    rows = batch * s.heads * seq * 4
    fwd = max(4 * s.head_dim * pairs / chip["bf16_flops"],
              (2 * q + 2 * kv + rows) / chip["hbm_bytes"])
    bwd = max(8 * s.head_dim * pairs / chip["bf16_flops"],
              (4 * q + 4 * kv + rows) / chip["hbm_bytes"])
    return s.layers * (fwd + bwd)


def rms_norm_least_s(s: MistralShape, batch: int, seq: int,
                     chip: dict) -> float:
    """The least time one step's RMSNorm forwards need: two a layer and
    the final one, each reading x [tokens, d] and writing y in the compute
    dtype and reading its fp32 weight; bound by bytes or fp32 operations."""
    rows = batch * seq
    e = 2 if s.compute_dtype == "bfloat16" else 4
    calls = 2 * s.layers + 1
    nbytes = 2 * rows * s.d * e + s.d * 4
    t = max(nbytes / chip["hbm_bytes"], 4 * rows * s.d / chip["fp32_flops"])
    return calls * t
