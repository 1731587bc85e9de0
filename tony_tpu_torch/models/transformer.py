"""Flagship decoder-only transformer LM: config, parameters and the training
forward.

The same config fields and defaults as the JAX package's
``TransformerConfig``, so one set of values describes the model in both, and
the same stacked ``[L, ...]`` parameter layout and initial scales. fp32
master weights; compute runs in ``cfg.compute_dtype``. ``forward`` is the
dense, single-device trunk of the JAX package's ``forward``: pre-norm
attention (RMSNorm, separate q/k/v projections, RoPE, flash attention with
GQA K/V as they are, output projection) and a SwiGLU MLP per layer, then the
final norm and the logits. With ``n_experts`` every layer's MLP is the
capacity-based top-k MoE layer (``_moe_mlp``), which returns the router's
auxiliary losses beside its output.

On a mesh (dp, pp, ep, sp and tp) the forward takes the parameters
gathered over dp and pp, except the expert FFN weights, of which each rank
holds its E/ep experts, and the tp-split leaves, of which each rank holds
its tp block. ``forward_pipeline`` is the pipelined trunk over pp
(``parallel.pipeline``): each rank runs its own L/pp layers as a stage of a
microbatch schedule (GPipe or interleaved virtual stages), the embedding
before the pipeline and the logits after it on every pp rank. Over sp
each rank holds a block of the sequence: RoPE takes the block's global
positions, and the attention is the ring (``parallel.ring``), whose K/V
blocks travel over the sp axis. The MoE layer then runs the
JAX package's manual form (``_moe_mlp_manual``), routing the rank's own
tokens (its rows over dp x ep, its block of positions over sp) with a local
capacity and exchanging per-expert slabs over ep with one all_to_all each
way; over tp each rank holds its F/tp columns of every resident expert. The
trunk runs Megatron's split over tp,
the JAX package's manual trunk with explicit collectives: each rank holds
its heads of wq/wk/wv and rows of wo, its mlp columns of w_gate/w_up and
rows of w_down, its vocab rows of embed and columns of unembed; the
replicated activations enter each column-parallel product through
``copy_to_tp`` and the row-parallel partial sums leave through
``reduce_from_tp``, and the logits stay split over the vocab (the loss is
``vocab_parallel_cross_entropy``). The same code runs at tp = 1, where the
conjugate pair is the identity.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils import checkpoint

from tony_tpu_torch import profiling
from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.ops import (
    apply_rope,
    cached_rope_frequencies,
    flash_attention,
    rms_norm,
)
from tony_tpu_torch.parallel.collectives import (
    copy_to_tp,
    exchange_chunks,
    exchange_ep,
    pmean,
    reduce_from_tp,
)
from tony_tpu_torch.parallel.mesh import (
    DATA_AXES,
    axis_coordinate,
    axis_size,
    mesh_spec,
)
from tony_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_apply_in_process,
)
from tony_tpu_torch.parallel.ring import ring_attention

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
    # MoE: 0 experts = dense SwiGLU; else every layer is a top-k MoE layer
    # with capacity_factor token capacity and the Switch balance and router
    # z losses (see _moe_mlp). Decode evaluates the experts as
    # moe_decode_mode says (models/decode.py).
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
    axis, ep splits experts. ``make_train_step(cfg, mesh)`` places the
    state by it (``parallel.sharding.shard_pytree``)."""
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


def _cast(w, dt):
    """A master weight in the compute dtype: ``w.to(dt)``. While a
    profiler records, the cast runs under ``weight_cast`` (in the forward
    and the remat recompute) and its gradient's cast back to the master's
    dtype under ``bwd:weight_cast`` (``profiling.annotate_region``)."""
    if not profiling.recording():
        return w.to(dt)
    with profiling.annotate_region("weight_cast") as r:
        return r.leave(r.enter(w).to(dt))


def _attention(x, lp, cfg, cos, sin, mesh=None):
    """Pre-norm attention block. x: [b, t, d] in the compute dtype. The
    head counts are those of ``lp``: with a mesh, this rank's H/tp query
    and Hkv/tp K/V heads, whose partial output is summed over tp. Over sp
    above 1, x is this rank's block of t positions of the sequence: RoPE
    rotates by their global positions and the ring attends over every
    block (K/V at their Hkv heads)."""
    dt = cfg.compute_dtype
    b, t, d = x.shape
    h = rms_norm(x, lp["ln1"]).to(dt)
    if mesh is not None:
        h = copy_to_tp(h, mesh)
    heads, kv_heads = lp["wq"].shape[-2], lp["wk"].shape[-2]
    q = (h @ _cast(lp["wq"], dt).reshape(d, -1)).view(b, t, heads,
                                                      cfg.head_dim)
    k = (h @ _cast(lp["wk"], dt).reshape(d, -1)).view(b, t, kv_heads,
                                                      cfg.head_dim)
    v = (h @ _cast(lp["wv"], dt).reshape(d, -1)).view(b, t, kv_heads,
                                                      cfg.head_dim)
    sp = 1 if mesh is None else axis_size(mesh, "sp")
    positions = None
    if sp > 1:
        positions = (axis_coordinate(mesh, "sp") * t
                     + torch.arange(t, device=x.device))
    q = apply_rope(q, cos, sin, positions=positions)
    k = apply_rope(k, cos, sin, positions=positions)
    if sp > 1:
        o = ring_attention(q, k, v, mesh, axis_name="sp", causal=True,
                           scale=cfg.head_dim ** -0.5)
    else:
        o = flash_attention(q, k, v, causal=True)
    out = o.to(dt).reshape(b, t, -1) @ _cast(lp["wo"], dt).reshape(-1, d)
    return out if mesh is None else reduce_from_tp(out, mesh)


def _dense_mlp(x, lp, cfg, mesh=None):
    """SwiGLU, with silu in fp32. With a mesh, over this rank's F/tp
    columns of w_gate/w_up and rows of w_down, summed over tp."""
    dt = cfg.compute_dtype
    h = rms_norm(x, lp["ln2"]).to(dt)
    if mesh is not None:
        h = copy_to_tp(h, mesh)
    g = h @ _cast(lp["w_gate"], dt)
    u = h @ _cast(lp["w_up"], dt)
    act = torch.nn.functional.silu(g.float()).to(dt) * u
    out = act @ _cast(lp["w_down"], dt)
    return out if mesh is None else reduce_from_tp(out, mesh)


# The expert FFN leaves: on an ep mesh each rank keeps its E/ep experts of
# these (the router is gathered whole: every rank routes over all E).
EXPERT_LEAVES = frozenset({"w_gate", "w_up", "w_down"})


def _route_tokens(hn, router, top_k: int):
    """Router gating shared by training and decode: fp32 logits and
    softmax, top-k over the probabilities, the selected weights renormalized
    with an epsilon guard. A stable descending sort breaks ties toward the
    lower expert index, as ``lax.top_k`` does, and is deterministic, so a
    remat recomputation picks the same experts. Returns (gate_logits [.., E]
    fp32, probs [.., E], gvals [.., k] normalized, gidx [.., k])."""
    gate_logits = hn.float() @ router.float()
    probs = torch.softmax(gate_logits, dim=-1)
    gvals, gidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gvals, gidx = gvals[..., :top_k], gidx[..., :top_k]
    gvals = gvals / gvals.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate_logits, probs, gvals, gidx


def _expert_slots(gidx, n_experts: int, cap: int):
    """Capacity slots of the (choice, token) entries of gidx [b, t, k], in
    (choice, token) order, every first choice before any second choice:
    (choice [k * b * t] the expert, pos the entry's place in its expert's
    queue (an int32 cumsum), keep = pos < cap, and the one-hot
    [E, k * b * t] int32 of choice)."""
    n, kk = gidx.shape[0] * gidx.shape[1], gidx.shape[2]
    choice = gidx.reshape(n, kk).t().reshape(-1)
    # A comparison, not F.one_hot, whose range check reads the indices
    # back to the host on the card.
    experts = torch.arange(n_experts, device=choice.device)
    onehot = (experts[:, None] == choice).to(torch.int32)  # [E, k * b * t]
    # The scan runs along the contiguous dimension: a scan down the
    # columns of [k * b * t, E] is E serial threads on the card.
    pos = ((onehot.cumsum(1, dtype=torch.int32) - onehot) * onehot).sum(0)
    return choice, pos, pos < cap, onehot


def _moe_mlp(x, lp, cfg, mesh=None):
    """Capacity-based top-k MoE, the JAX package's ``_moe_mlp`` (and, with
    a mesh, its manual form ``_moe_mlp_manual``). Returns ``(out, aux)``.

    Capacity ``max(1, int(cf * b * t * k / E))`` slots per expert over
    this rank's tokens; slots fill in (choice, token) order, every first
    choice before any second choice (an int32 cumsum), and a (token,
    choice) past its expert's capacity is dropped (the residual carries
    the token). The JAX package dispatches and combines with one-hot
    einsums of [b, t, E, C]; this computes the same sums by index: each
    slot holds one token's normed input in the compute dtype (a copy into
    the slot), and each output row is sum_k dt(gate_k) * dt(expert_out)
    over the token's kept choices, summed in fp32 and cast once.

    aux: the Switch balance loss E * sum_e f_e * P_e (f the fraction of
    (token, choice) slots routed to e, P the mean router probability), the
    router z-loss mean(logsumexp(logits)^2), the drop rate and the entropy
    of f. With a mesh the statistics are averaged over the data axes (dp,
    ep, sp) before they are combined (a differentiable pmean), and the
    slabs [E, C, d] go to the ranks holding their experts and back with one
    all_to_all over ep each way. Over tp every rank routes the same tokens
    the same way (the router, the slots and the statistics are replicated)
    and runs its F/tp columns of w_gate/w_up and rows of w_down: the normed
    input enters the experts through ``copy_to_tp``, the combine weights
    through another (each rank's combine gives their cotangent from its own
    columns only), and the combined output leaves through
    ``reduce_from_tp``, the JAX package's ``lax.psum(out, "tp")``."""
    dt = cfg.compute_dtype
    b, t, d = x.shape
    e, kk = cfg.n_experts, cfg.expert_top_k
    n = b * t
    cap = max(1, int(cfg.capacity_factor * b * t * kk / e))
    # Each stage is a region: its backward runs under bwd:moe.<stage>
    # (profiling.annotate_region) while a profiler records.
    with profiling.annotate_region("moe.route") as r:
        hn = rms_norm(r.enter(x), lp["ln2"])
        gate_logits, probs, gvals, gidx = _route_tokens(hn, lp["router"], kk)
        choice, pos, keep, onehot = _expert_slots(gidx, e, cap)
        stats = torch.cat([
            onehot.sum(1).float() / choice.numel(),             # f [E]
            probs.reshape(n, e).mean(0),                        # P [E]
            torch.logsumexp(gate_logits, dim=-1).square().mean()[None],
            1.0 - keep.float().mean()[None],
        ])
        if mesh is not None:
            stats = pmean(stats, mesh, DATA_AXES)
        frac, mean_probs = stats[:e], stats[e:2 * e]
        aux = {
            "moe_balance": e * (frac * mean_probs).sum(),
            "moe_zloss": stats[2 * e],
            "moe_drop_rate": stats[2 * e + 1],
            "moe_entropy": -(frac * torch.log(frac + 1e-9)).sum(),
        }
        # The drop rate and the entropy are read, never differentiated.
        hn, gvals, aux["moe_balance"], aux["moe_zloss"] = r.leave(
            hn, gvals, aux["moe_balance"], aux["moe_zloss"])
    with profiling.annotate_region("moe.dispatch") as r:
        # Dropped entries land in a spare last row, cut off after.
        slot = torch.where(keep, choice * cap + pos, e * cap)
        h_in = r.enter(hn).to(dt)
        if mesh is not None:
            h_in = copy_to_tp(h_in, mesh)
        src = h_in.reshape(1, n, d).expand(kk, n, d).reshape(kk * n, d)
        xin = src.new_zeros(e * cap + 1, d).index_copy(0, slot, src)
        xin = xin[:-1].view(e, cap, d)
        if mesh is not None:
            # [E, C, d] -> [ep, E_l, C, d] -> exchange -> [E_l, ep * C, d]:
            # slab j of what arrives is peer j's tokens for my experts.
            ep, e_local = axis_size(mesh, "ep"), lp["w_gate"].shape[0]
            xin = exchange_ep(xin.reshape(ep, e_local, cap, d), mesh)
            xin = xin.transpose(0, 1).reshape(e_local, ep * cap, d)
        xin = r.leave(xin)
    with profiling.annotate_region("moe.experts") as r:
        xin = r.enter(xin)
        g = torch.bmm(xin, _cast(lp["w_gate"], dt))
        u = torch.bmm(xin, _cast(lp["w_up"], dt))
        act = torch.nn.functional.silu(g.float()).to(dt) * u
        out_e = r.leave(torch.bmm(act, _cast(lp["w_down"], dt)))
    with profiling.annotate_region("moe.combine") as r:
        out_e, gvals = r.enter(out_e, gvals)
        if mesh is not None:
            out_e = out_e.view(e_local, ep, cap, d).transpose(0, 1)
            out_e = exchange_ep(out_e, mesh)
        rows = torch.cat([out_e.reshape(e * cap, d), out_e.new_zeros(1, d)])
        picked = rows.index_select(0, slot).view(kk, n, d)
        if mesh is not None:
            gvals = copy_to_tp(gvals, mesh)
        gate = gvals.reshape(n, kk).t().to(dt)                 # [k, n]
        out = (picked.float() * gate.float()[..., None]).sum(0)
        out = r.leave(out.to(dt).view(b, t, d))
    return (out if mesh is None else reduce_from_tp(out, mesh)), aux


def _decoder_layer(x, lp, cfg, cos, sin, mesh=None):
    """Returns ``(x, aux)``: aux is the layer's MoE router dict, None for a
    dense layer."""
    x = x + _attention(x, lp, cfg, cos, sin, mesh)
    if cfg.n_experts:
        out, aux = _moe_mlp(x, lp, cfg, mesh)
        return x + out, aux
    return x + _dense_mlp(x, lp, cfg, mesh), None


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" remat policy: keep matrix-product outputs, recompute the
    rest (the JAX package's dots_with_no_batch_dims_saveable; attention's
    batched products live inside the flash kernels)."""
    if op in _MATMULS:
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


# The range the remat recompute runs under: it re-enters the forward inside
# some backward node, and so inside whatever bwd: range is open there.
RECOMPUTE_RANGE = "remat.recompute"


@contextlib.contextmanager
def _recompute_range(context):
    with record_function(RECOMPUTE_RANGE), context:
        yield


def _remat_context(cfg: TransformerConfig):
    """``context_fn`` for torch.utils.checkpoint: "full" saves nothing and
    recomputes the whole layer; "dots" saves the matmul outputs. The
    recompute runs under ``RECOMPUTE_RANGE``."""
    if cfg.remat_policy == "full":
        contexts = checkpoint.noop_context_fn
    elif cfg.remat_policy == "dots":
        contexts = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _save_dots)
    else:
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r}; expected full|dots"
        )

    def context_fn():
        forward_context, recompute_context = contexts()
        return forward_context, _recompute_range(recompute_context)

    return context_fn


def _layer_slices(layers: dict) -> list[dict]:
    """Per-layer views of the stacked weights (their leading dimension).
    ``unbind`` hands autograd one stack of the per-layer gradients instead
    of a full-size zero tensor per layer."""
    names = list(layers)
    columns = [layers[name].unbind(0) for name in names]
    return [dict(zip(names, row)) for row in zip(*columns)]


def check_mesh(mesh, cfg: TransformerConfig) -> None:
    """Refuse a tp that does not divide the heads, K/V heads, d_ff or vocab
    (the JAX GSPMD trunk would replicate such a dimension; the manual split
    cannot), and an ep that does not divide the config's experts. Every
    axis runs both model families. That sp divides the sequence is checked
    where the sequence is known (``lm_loss``, ``forward``)."""
    spec = mesh_spec(mesh)
    if spec.tp > 1:
        for name, dim in (("n_heads", cfg.n_heads), ("kv_heads",
                                                     cfg.kv_heads),
                          ("d_ff", cfg.d_ff),
                          ("vocab_size", cfg.vocab_size)):
            if dim % spec.tp:
                raise ValueError(f"tp {spec.tp} must divide {name} {dim}")
    if cfg.n_experts and cfg.n_experts % spec.ep:
        raise ValueError(f"ep {spec.ep} must divide n_experts "
                         f"{cfg.n_experts}")


def _embed(embed, tokens, cfg, mesh=None):
    """The embedding rows of ``tokens`` in the compute dtype. With a mesh,
    ``embed`` holds this rank's block of V/tp vocab rows: tokens outside
    it look up zeros, and the sum over tp gives every rank every row.

    ``F.embedding``, not indexing: the tokens outside the block all look
    up the block's edge rows, and indexing's backward adds a row's
    duplicates one after another (8.4 ms of a 58 ms step at tp 4 on an
    H100), where the embedding's backward sums them by segments."""
    dt = cfg.compute_dtype
    if mesh is None:
        return F.embedding(tokens, embed).to(dt)
    v = embed.shape[0]
    local = tokens - axis_coordinate(mesh, "tp") * v
    mine = ((local >= 0) & (local < v))[..., None]
    rows = torch.where(mine, F.embedding(local.clamp(0, v - 1), embed), 0.0)
    return reduce_from_tp(rows.to(dt), mesh)


def _check_pieces(params: dict, tokens: torch.Tensor,
                  cfg: TransformerConfig, mesh) -> None:
    """The pieces ``forward(mesh=)`` and ``forward_pipeline`` take: the
    sequence (sp x this rank's block) within max_seq, the leaves gathered
    over dp, and this rank's n_heads/tp heads."""
    seq = axis_size(mesh, "sp") * tokens.shape[1]
    if seq > cfg.max_seq:
        raise ValueError(
            f"a sequence of {seq} positions (sp x {tokens.shape[1]}) "
            f"exceeds max_seq {cfg.max_seq}")
    d_in = params["layers"]["wq"].shape[1]
    if d_in != cfg.d_model:
        raise ValueError(
            f"forward(mesh=) takes the gathered parameters: wq has "
            f"{d_in} of d_model {cfg.d_model} rows"
        )
    tp = axis_size(mesh, "tp")
    heads = params["layers"]["wq"].shape[2]
    if heads * tp != cfg.n_heads:
        raise ValueError(
            f"forward(mesh=) takes n_heads/tp = {cfg.n_heads // tp} "
            f"heads per rank, the params hold {heads}")


def _run_layers(layers: dict, x, layer_fn, cfg: TransformerConfig):
    """``x`` through the stacked ``layers`` (their leading dimension),
    each under ``cfg.remat`` through ``torch.utils.checkpoint``: (x, the
    layers' MoE aux dicts)."""
    context_fn = _remat_context(cfg) if cfg.remat else None
    aux_layers = []
    for lp in _layer_slices(layers):
        if cfg.remat:
            x, aux = checkpoint.checkpoint(layer_fn, x, lp,
                                           use_reentrant=False,
                                           context_fn=context_fn)
        else:
            x, aux = layer_fn(x, lp)
        if aux is not None:
            aux_layers.append(aux)
    return x, aux_layers


def _logits(x, params: dict, cfg: TransformerConfig, mesh=None):
    """The final norm and the unembedding: this rank's V/tp vocab columns
    with a mesh."""
    x = rms_norm(x, params["final_norm"]).to(cfg.compute_dtype)
    if mesh is not None:
        x = copy_to_tp(x, mesh)
    return x @ _cast(params["unembed"], cfg.compute_dtype)


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None, *, return_aux: bool = False):
    """tokens [B, T] int -> logits [B, T, V] in the compute dtype, on the
    device of ``params`` (which are never moved; tokens are). Differentiable
    in the params: B1/B4 forward and B2/B3 backward on the card.

    ``cfg.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, ``cfg.remat_policy`` "full" or "dots");
    the recomputed routing picks the same experts (it is deterministic).
    ``return_aux=True`` additionally returns the MoE router aux dict
    (balance, z-loss, drop rate, entropy, each averaged over the layers),
    empty for a dense config.

    With a ``mesh``, ``params`` are the parameters gathered over dp and
    pp (every pp rank runs the whole trunk on the same rows: the JAX
    package's GSPMD trunk with the layer stack stored over pp) but for the
    expert FFN weights, of which this rank holds its E/ep experts, and the
    tp-split leaves, of which it holds its tp block (``make_train_step``
    gathers them so); ``tokens`` are this rank's slice of the batch, the
    same on every tp and pp rank, and over sp its block of the sequence
    (rank i of sp holds positions [i * T, (i + 1) * T)); the logits are
    this rank's V/tp vocab columns of those positions."""
    if mesh is not None:
        check_mesh(mesh, cfg)
        _check_pieces(params, tokens, cfg, mesh)
        held = params["layers"]["wq"].shape[0]
        if held != cfg.n_layers:
            raise ValueError(
                f"forward(mesh=) takes the layer stack gathered over pp: "
                f"the params hold {held} of {cfg.n_layers} layers")
    if cfg.n_experts:
        ep = 1 if mesh is None else axis_size(mesh, "ep")
        held = params["layers"]["w_gate"].shape[1]
        if held * ep != cfg.n_experts:
            raise ValueError(
                f"forward takes E/ep = {cfg.n_experts // ep} experts per "
                f"rank, the params hold {held}")
    device = params["embed"].device
    cos, sin = cached_rope_frequencies(cfg.head_dim, cfg.max_seq,
                                       theta=cfg.rope_theta, device=device)
    x = _embed(params["embed"], tokens.to(device).long(), cfg, mesh)
    layer_fn = functools.partial(_decoder_layer, cfg=cfg, cos=cos, sin=sin,
                                 mesh=mesh)
    x, aux_layers = _run_layers(params["layers"], x, layer_fn, cfg)
    logits = _logits(x, params, cfg, mesh)
    if not return_aux:
        return logits
    aux = {k: torch.stack([a[k] for a in aux_layers]).mean()
           for k in (aux_layers[0] if aux_layers else ())}
    return logits, aux


def check_pipeline(cfg: TransformerConfig, pp: int, tp: int, schedule: str,
                   virtual_stages: int, ep: int = 1) -> None:
    """The pipelined trunk's refusals, the JAX package's
    (``forward_pipeline``): experts ep does not divide, virtual stages
    without the interleaved schedule, a layer count pp x virtual does not
    divide, and K/V heads tp does not divide."""
    if cfg.n_experts and cfg.n_experts % ep:
        raise ValueError(
            f"n_experts {cfg.n_experts} not divisible by ep {ep}: "
            f"resident-expert slabs must be equal")
    if schedule != "interleaved" and virtual_stages != 1:
        raise ValueError("virtual_stages > 1 requires schedule='interleaved'")
    if cfg.n_layers % (pp * virtual_stages):
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"pp*virtual {pp * virtual_stages}")
    if cfg.kv_heads % tp:
        raise ValueError(
            f"pipeline trunk needs n_kv_heads ({cfg.kv_heads}) divisible by "
            f"tp ({tp}); use the GSPMD trunk or fewer tp shards")


def forward_pipeline(params: dict, tokens: torch.Tensor,
                     cfg: TransformerConfig, mesh, *, num_microbatches: int,
                     schedule: str = "gpipe", virtual_stages: int = 1,
                     return_aux: bool = False, stages: int | None = None):
    """The pipelined trunk (the JAX package's ``forward_pipeline``): the
    embedding runs before the pipeline and the final norm, the
    unembedding and the logits after it on every pp rank; the layer stack
    runs as pp stages of ``parallel.pipeline_apply`` under ``schedule``
    ("gpipe" or "interleaved" with ``virtual_stages`` round-robin chunks a
    rank), each layer with tp's sums and sp's ring inside, under
    ``cfg.remat`` as in ``forward``. Returns what ``forward`` returns. An
    MoE stage routes its microbatch (the capacity counted from its rows)
    and returns its layers' four router values summed beside its output;
    the schedule sums them over the valid ticks and the stages, and the
    aux dict is that sum over ``n_layers x num_microbatches``, the mean
    ``forward`` reports.

    ``params``: as ``forward(mesh=)`` takes them, but for the layer leaves,
    which hold this rank's L/pp layers, contiguous as the state keeps them
    (``"layers"`` -> pp); the interleaved schedule exchanges them for its
    round-robin chunks each call (``collectives.exchange_chunks``).

    With ``mesh=None`` the pipeline of ``stages`` ranks runs in this
    process (``pipeline_apply_in_process``) over the whole parameters."""
    if mesh is None:
        if stages is None:
            raise ValueError("forward_pipeline(mesh=None) runs the pipeline "
                             "in this process: pass stages=")
        pp, tp, ep = stages, 1, 1
    else:
        pp, tp, ep = (axis_size(mesh, a) for a in ("pp", "tp", "ep"))
    v = virtual_stages
    check_pipeline(cfg, pp, tp, schedule, v, ep)
    layers = params["layers"]
    held = layers["wq"].shape[0]
    if mesh is not None:
        check_mesh(mesh, cfg)
        _check_pieces(params, tokens, cfg, mesh)
        if held * pp != cfg.n_layers:
            raise ValueError(
                f"forward_pipeline takes this rank's L/pp = "
                f"{cfg.n_layers // pp} layers, the params hold {held}")
    elif held != cfg.n_layers:
        raise ValueError(f"forward_pipeline(mesh=None) takes all "
                         f"{cfg.n_layers} layers, the params hold {held}")
    device = params["embed"].device
    cos, sin = cached_rope_frequencies(cfg.head_dim, cfg.max_seq,
                                       theta=cfg.rope_theta, device=device)
    x = _embed(params["embed"], tokens.to(device).long(), cfg, mesh)
    layer_fn = functools.partial(_decoder_layer, cfg=cfg, cos=cos, sin=sin,
                                 mesh=mesh)

    def stage_fn(stage_layers, xm):
        y, aux_layers = _run_layers(stage_layers, xm, layer_fn, cfg)
        if not cfg.n_experts:
            return y
        return y, {k: torch.stack([a[k] for a in aux_layers]).sum()
                   for k in aux_layers[0]}

    kw = dict(num_microbatches=num_microbatches, schedule=schedule,
              virtual=v, stage_aux=bool(cfg.n_experts))
    if mesh is None:
        lv = cfg.n_layers // (pp * v)
        if schedule == "interleaved":
            # [L, ...] -> [pp, v, L/(v*pp), ...]: [d, c] is global virtual
            # stage c * pp + d.
            stacked = {k: p.reshape(v, pp, lv, *p.shape[1:]).transpose(0, 1)
                       for k, p in layers.items()}
        else:
            stacked = {k: p.reshape(pp, lv, *p.shape[1:])
                       for k, p in layers.items()}
        x = pipeline_apply_in_process(stage_fn, stacked, x, pp, **kw)
    else:
        if schedule == "interleaved":
            layers = {k: exchange_chunks(p, mesh, v)
                      for k, p in layers.items()}
        x = pipeline_apply(stage_fn, layers, x, mesh=mesh, **kw)
    aux = {}
    if cfg.n_experts:
        x, aux_sum = x
        aux = {k: a / (cfg.n_layers * num_microbatches)
               for k, a in aux_sum.items()}
    logits = _logits(x, params, cfg, mesh)
    return (logits, aux) if return_aux else logits
