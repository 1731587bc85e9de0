"""The yardstick's arithmetic: the work a train step needs, from shapes,
and the chip's peaks.

Work is counted once, whatever implements it: a remat recomputation, an
embedding gather and an empty capacity slot are not the model's work.
The attention and RMSNorm counts are the B1-B4 bounds of the port's
``chip_smoke.py`` (``fwd_bound``, ``bwd_bounds``, ``time_rms_norm``),
frozen here so that a later change to a kernel is read against the same
work.
"""

from __future__ import annotations

from perfbench.lib.shape import Shape

# Published dense peaks by torch.cuda.get_device_name(): bf16 tensor-core
# FLOP/s, fp32 FLOP/s outside the tensor cores, HBM bytes/s (NVIDIA's data
# sheet, SXM part, at its 700 W limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12,
                              "hbm_bytes": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    return PEAKS.get(device_name)


def matmul_params(s: Shape) -> int:
    """N of 6 N tokens: the parameters each token multiplies by, the
    unembedding and the router and the top-k experts it is routed to
    included, the embedding (a gather) not."""
    attn = s.d * (s.heads + 2 * s.kv_heads) * s.head_dim \
        + s.heads * s.head_dim * s.d
    mlp = 3 * s.d * s.ff * (s.top_k if s.experts else 1)
    router = s.d * s.experts
    return s.layers * (attn + mlp + router) + s.d * s.vocab


def attention_pairs(s: Shape, batch: int, seq: int) -> int:
    """Visible (query, key) pairs of causal attention over all heads."""
    return batch * s.heads * seq * (seq + 1) // 2


def model_flops(s: Shape, batch: int, seq: int) -> float:
    """One train step's model FLOPs: 6 N tokens, plus causal attention's
    two products forward and four backward (12 D a visible pair), every
    layer."""
    tokens = batch * seq
    attn = 12 * s.head_dim * attention_pairs(s, batch, seq)
    return 6.0 * matmul_params(s) * tokens + float(s.layers * attn)


def attention_least_s(s: Shape, batch: int, seq: int,
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


def rms_norm_least_s(s: Shape, batch: int, seq: int, chip: dict) -> float:
    """The least time one step's RMSNorm forwards need: two a layer and
    the final one, each reading x [tokens, d] and writing y in the compute
    dtype and reading its fp32 weight; bound by bytes or fp32 operations."""
    rows = batch * seq
    e = 2 if s.compute_dtype == "bfloat16" else 4
    calls = 2 * s.layers + 1
    nbytes = 2 * rows * s.d * e + s.d * 4
    t = max(nbytes / chip["hbm_bytes"], 4 * rows * s.d / chip["fp32_flops"])
    return calls * t
