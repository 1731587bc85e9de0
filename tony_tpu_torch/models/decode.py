"""KV-cache decoding and generation for the flagship transformer.

* ``advance`` handles both prefill (S = prompt length) and single-token steps
  (S = 1) over a stacked [L, B, Tmax, Hkv, Dh] cache pair. Under GQA the cache
  holds only the Hkv shared heads. The caches are updated IN PLACE (the JAX
  package donates them); ``advance`` returns the same tensors with the new
  length.
* A prefill on an empty cache attends over the prompt with the flash kernel
  (``ops.flash_attention``); every other step attends against the cache with
  a grouped product (q regrouped [B, S, Hkv, G, Dh], so the cache is never
  head-repeated), fp32 scores and softmax. It reads only the cache rows
  [0, length + S): later rows are masked for every query, so they would add
  exact zeros.
* ``decode_weights`` re-packs the fp32 training masters once: cast to the
  compute dtype, qkv fused on the head axis and gate|up on the feature
  axis, so each step runs one matmul where training runs three and two.
  ``DecodeSession`` holds the fused pack across ``generate`` calls.

Sampling: greedy at ``temperature=0``, else temperature sampling with
optional top-k / top-p from an explicit ``torch.Generator``. ``jax.random``
and ``torch.Generator`` draw different numbers, so temperature sampling
keeps the contract, not the JAX package's bits; greedy decoding matches it
token for token.

MoE trunks evaluate their experts as ``cfg.moe_decode_mode`` says: "dense"
(and "auto") runs every expert on the new tokens and weights the unselected
by exactly 0; "routed" gathers each token's top-k experts' weights and runs
only those, on single-token steps (a prefill takes the dense mixture).
Neither drops a token: capacity is a training trade, not a serving one.
Both route with training's ``_route_tokens`` from an fp32 router.

Sharded sessions (``DecodeSession(mesh=)``) serve one model from the
ranks of a mesh, the port's counterpart of the JAX package's
``decode_param_specs`` and ``_cache_spec``, with explicit collectives. Each
rank keeps its tp block of every part of the fused layout
(``shard_decode_weights``: its q, k and v heads of ``qkv``, its gate and up
columns of ``gate_up``, its head rows of ``wo``, ff rows of ``w_down`` and
vocab columns of ``unembed``; the norms, ``embed`` and an MoE router
whole), of an MoE trunk only its E/ep experts, and a cache [L, B/dp, Tmax,
Hkv/tp, Dh] of its batch rows over dp and its K/V heads. Each layer sums
the ``wo`` and ``w_down`` partial products over tp, and an MoE layer's
output, the resident experts' share of each token's mixture, over ep too;
the last position's logits are gathered over tp (vocab) and dp (batch
rows), so every rank samples the whole batch from the same numbers and
``generate`` returns the whole batch on every rank. The ep and tp ranks of
a dp row hold the same rows. The session is replicated over pp and sp (no
spec of the JAX package's ``decode_param_specs`` names them): the pp and
sp ranks of a dp row, ep and tp block compute the same tokens.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.transformer import (
    TransformerConfig,
    _route_tokens,
    check_mesh,
)
from tony_tpu_torch.ops import (
    apply_rope,
    cached_rope_frequencies,
    flash_attention,
    rms_norm,
)
from tony_tpu_torch.ops import attention
from tony_tpu_torch.parallel import autotune
from tony_tpu_torch.parallel import plan as plan_lib
from tony_tpu_torch.parallel.collectives import all_gather_tp, axis_group
from tony_tpu_torch.parallel.mesh import axis_coordinate, axis_size

NEG_INF = -1e30


def decode_weights(params: dict, cfg: TransformerConfig) -> dict:
    """Re-pack training params for decode: cast to the compute dtype and
    fuse wq|wk|wv on the head axis ([L, d, H + 2*Hkv, Dh]) and
    w_gate|w_up on the feature axis ([L, d, 2F]; MoE: [L, E, d, 2F] per
    expert). Norm weights are cast to the compute dtype too; an MoE
    router stays fp32 (it is tiny, and a rounded router could flip near
    ties between gate logits that training, routing from fp32 masters,
    resolves the other way)."""
    dt = cfg.compute_dtype
    lp = params["layers"]
    layers = {
        "ln1": lp["ln1"].to(dt),
        "ln2": lp["ln2"].to(dt),
        "qkv": torch.cat([lp["wq"].to(dt), lp["wk"].to(dt),
                          lp["wv"].to(dt)], dim=2),
        "wo": lp["wo"].to(dt),
        "gate_up": torch.cat([lp["w_gate"].to(dt), lp["w_up"].to(dt)],
                             dim=-1),
        "w_down": lp["w_down"].to(dt),
    }
    if cfg.n_experts:
        layers["router"] = lp["router"].float()
    return {
        "embed": params["embed"].to(dt),
        "final_norm": params["final_norm"].to(dt),
        "unembed": params["unembed"].to(dt),
        "layers": layers,
    }


def shard_decode_weights(params: dict, cfg: TransformerConfig,
                         mesh) -> dict:
    """This rank's pieces of the whole fused decode layout on a mesh, per
    part: its tp block of the query heads, of the K heads and of the V
    heads of ``qkv`` (a block of the packed axis would give one rank all
    of q and another all of v), of the gate columns and of the up columns
    of ``gate_up``, of the head rows of ``wo``, the ff rows of ``w_down``
    and the vocab columns of ``unembed``; of an MoE trunk's ``gate_up``
    [L, E, d, 2F] and ``w_down`` [L, E, F, d] only its E/ep experts (the
    JAX package's expert branch of ``decode_param_specs``); norms,
    ``embed`` and an MoE router whole. Contiguous copies."""
    tp, i = axis_size(mesh, "tp"), axis_coordinate(mesh, "tp")
    h, hkv, f = cfg.n_heads, cfg.kv_heads, cfg.d_ff

    def block(n: int, start: int = 0) -> slice:
        step = n // tp
        return slice(start + i * step, start + (i + 1) * step)

    lp = params["layers"]
    qkv, gu, down = lp["qkv"], lp["gate_up"], lp["w_down"]
    if qkv.shape[-2] != h + 2 * hkv:
        raise ValueError(f"shard_decode_weights takes the whole fused "
                         f"layout: {h + 2 * hkv} packed heads, got "
                         f"{qkv.shape[-2]}")
    if cfg.n_experts:
        experts = _resident_experts(cfg, mesh)
        gu, down = gu[:, experts], down[:, experts]
    layers = {
        **lp,
        "qkv": torch.cat([qkv[:, :, block(h)], qkv[:, :, block(hkv, h)],
                          qkv[:, :, block(hkv, h + hkv)]], dim=2),
        "wo": lp["wo"][:, block(h)].contiguous(),
        "gate_up": torch.cat([gu[..., block(f)], gu[..., block(f, f)]],
                             dim=-1),
        "w_down": down[..., block(f), :].contiguous(),
    }
    return {**params, "layers": layers,
            "unembed": params["unembed"][:, block(cfg.vocab_size)]
            .contiguous()}


def _resident_experts(cfg: TransformerConfig, mesh) -> slice:
    """The global indices of this rank's E/ep experts."""
    n = cfg.n_experts // axis_size(mesh, "ep")
    first = axis_coordinate(mesh, "ep") * n
    return slice(first, first + n)


def check_decode_mesh(mesh, cfg: TransformerConfig) -> None:
    """Refuse what a sharded session cannot serve: anything but a
    ``DeviceMesh`` (``parallel.build_mesh``) and the meshes training
    refuses (``check_mesh``: a tp that does not divide the heads, K/V
    heads, d_ff or vocab, an ep that does not divide the experts). A
    session replicates over pp and sp, as the JAX package's
    ``decode_param_specs`` has no entry for either."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"DecodeSession(mesh=) takes a DeviceMesh from "
                        f"parallel.build_mesh, got {type(mesh).__name__}")
    check_mesh(mesh, cfg)


def place(params: dict, device: torch.device) -> dict:
    """The params tree with every tensor on ``device`` (no copy for
    tensors already there)."""
    return {
        key: (place(val, device) if isinstance(val, dict)
              else val.to(device))
        for key, val in params.items()
    }


def fused_on(params: dict, cfg: TransformerConfig,
             device: torch.device) -> dict:
    """``params`` in the fused decode layout on ``device``: raw training
    params are moved, then fused; fused ones are only moved."""
    params = place(params, device)
    if "qkv" not in params["layers"]:
        params = decode_weights(params, cfg)
    return params


def layer_params(params: dict, layer: int) -> dict:
    """One layer's slice of the stacked fused weights (views)."""
    return {name: w[layer] for name, w in params["layers"].items()}


def _dp_rows(batch: int, mesh) -> slice:
    """This rank's rows of a batch split over dp (all of them where dp
    does not divide the batch, which then is replicated, as in
    ``_cache_spec``)."""
    dp = 1 if mesh is None else axis_size(mesh, "dp")
    if batch % dp:
        return slice(0, batch)
    step = batch // dp
    i = axis_coordinate(mesh, "dp") if dp > 1 else 0
    return slice(i * step, (i + 1) * step)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda", mesh=None) -> dict:
    """Zeroed cache pair [L, B, max_len, Hkv, Dh] in the compute dtype;
    with a mesh, this rank's piece [L, B/dp, max_len, Hkv/tp, Dh]."""
    device = resolve_device(device)
    rows = _dp_rows(batch, mesh)
    tp = 1 if mesh is None else axis_size(mesh, "tp")
    shape = (cfg.n_layers, rows.stop - rows.start, max_len,
             cfg.kv_heads // tp, cfg.head_dim)
    dt = cfg.compute_dtype
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "length": 0,
    }


def _project(x, lp, cfg):
    """Pre-norm fused qkv projection: (q [B,S,H,Dh], k [B,S,Hkv,Dh],
    v [B,S,Hkv,Dh]) with the head counts ``lp`` holds (H/tp and Hkv/tp on
    a mesh); k and v are views of one product."""
    dt = cfg.compute_dtype
    b, s, d = x.shape
    tp = (cfg.n_heads + 2 * cfg.kv_heads) // lp["qkv"].shape[-2]
    n_h, h_kv = cfg.n_heads // tp, cfg.kv_heads // tp
    h = rms_norm(x, lp["ln1"]).to(dt)
    qkv = (h @ lp["qkv"].reshape(d, -1)).view(b, s, n_h + 2 * h_kv,
                                              cfg.head_dim)
    return qkv[:, :, :n_h], qkv[:, :, n_h:n_h + h_kv], qkv[:, :, n_h + h_kv:]


def _summed(partial, group):
    """Partial sums (a row-parallel product's over tp, the resident
    experts' share of an MoE mixture over ep) summed over ``group`` in
    place (the tensor is this call's own); as they are without a group
    (one rank)."""
    if group is not None:
        dist.all_reduce(partial, op=dist.ReduceOp.SUM, group=group)
    return partial


def _out_proj(x, o, lp, cfg, tp_group=None):
    dt = cfg.compute_dtype
    b, s, d = x.shape
    return x + _summed(o.to(dt).reshape(b, s, -1) @ lp["wo"].reshape(-1, d),
                       tp_group)


def _moe_decode_mode(cfg: TransformerConfig) -> str:
    """"routed" or "dense": "auto" resolves to the dense mixture."""
    mode = cfg.moe_decode_mode
    if mode not in ("auto", "routed", "dense"):
        raise ValueError(f"unknown moe_decode_mode {mode!r}")
    return "routed" if mode == "routed" else "dense"


def _moe_mlp_decode(x, lp, cfg, first: int = 0):
    """The dense mixture: every expert runs on the new tokens and the
    outputs are combined with the normalized top-k router weights (the
    unselected experts get exactly 0). Training's dispatch and combine
    without a capacity. x [B, S, d] -> [B, S, d]. On a mesh ``lp`` holds
    the experts [first, first + E/ep), and the result is their share of
    the mixture (over this rank's ff columns)."""
    dt = cfg.compute_dtype
    b, s, d = x.shape
    e = cfg.n_experts
    hn = rms_norm(x, lp["ln2"])
    _, _, gvals, gidx = _route_tokens(hn, lp["router"], cfg.expert_top_k)
    weights = torch.zeros((b, s, e), dtype=torch.float32, device=x.device)
    weights = weights.scatter_add(-1, gidx, gvals)              # [B, S, E]
    weights = weights[..., first:first + lp["gate_up"].shape[0]]
    e = weights.shape[-1]
    gu = torch.matmul(hn.to(dt).reshape(1, b * s, d), lp["gate_up"])
    f = gu.shape[-1] // 2                                      # [E, BS, 2F]
    act = torch.nn.functional.silu(gu[..., :f].float()).to(dt) * gu[..., f:]
    per_expert = torch.bmm(act, lp["w_down"])                  # [E, BS, d]
    out = torch.einsum("end,ne->nd", per_expert,
                       weights.reshape(b * s, e).to(dt))
    return out.view(b, s, d)


def _moe_mlp_decode_routed(x, lp, cfg, first: int = 0):
    """Top-k only: gather each token's k selected experts' weights and run
    just those (B * k expert products a step). The same router and gate
    weights as the dense mixture, no capacity; the terms the dense
    mixture adds for unselected experts are exact zeros, so both give the
    same tokens. x [B, S, d] -> [B, S, d]. On a mesh ``lp`` holds the
    experts [first, first + E/ep): a choice of another rank's expert
    gathers a resident one and weighs it by exactly 0, and the result is
    the resident experts' share (over this rank's ff columns)."""
    dt = cfg.compute_dtype
    hn = rms_norm(x, lp["ln2"])
    _, _, gvals, gidx = _route_tokens(hn, lp["router"], cfg.expert_top_k)
    n_local = lp["gate_up"].shape[0]
    if n_local != cfg.n_experts:
        local = gidx - first
        mine = (local >= 0) & (local < n_local)
        gidx = local.clamp(0, n_local - 1)
        gvals = torch.where(mine, gvals, 0.0)
    w_gu = lp["gate_up"][gidx]                           # [B, S, k, d, 2F]
    w_dn = lp["w_down"][gidx]                            # [B, S, k, F, d]
    gu = torch.einsum("bsd,bskdf->bskf", hn.to(dt), w_gu)
    f = gu.shape[-1] // 2
    act = torch.nn.functional.silu(gu[..., :f].float()).to(dt) * gu[..., f:]
    per_slot = torch.einsum("bskf,bskfd->bskd", act, w_dn)
    return torch.einsum("bskd,bsk->bsd", per_slot, gvals.to(dt))


def _mlp(x, lp, cfg, *, routed: bool = False, tp_group=None,
         experts: tuple = (0, None)):
    """Residual SwiGLU over the fused gate|up projection: silu in fp32,
    cast to the compute dtype, times up; with ``tp_group``, over this
    rank's ff columns, summed over tp. An MoE layer (a router in ``lp``)
    takes the dense mixture, or with ``routed`` the top-k gather, over
    the resident experts of ``experts`` (the first one's global index,
    the ep group to sum their share over or None)."""
    if "router" in lp:
        moe = _moe_mlp_decode_routed if routed else _moe_mlp_decode
        first, ep_group = experts
        return x + _summed(_summed(moe(x, lp, cfg, first), ep_group),
                           tp_group)
    dt = cfg.compute_dtype
    hn = rms_norm(x, lp["ln2"]).to(dt)
    gu = hn @ lp["gate_up"]
    f = gu.shape[-1] // 2
    act = torch.nn.functional.silu(gu[..., :f].float()).to(dt) * gu[..., f:]
    return x + _summed(act @ lp["w_down"], tp_group)


def _attend_cache(q, k_cache, v_cache, mask, cfg):
    """Grouped attention against cache rows: q [B, S, H, Dh], k/v_cache
    [B, T, Hkv, Dh], mask [B, S, T] (or broadcastable) True where the key is
    visible. Scores and softmax in fp32, probabilities cast to the compute
    dtype for the value product, output in the compute dtype."""
    dt = cfg.compute_dtype
    b, s, n_h, dh = q.shape
    h_kv = k_cache.shape[2]
    g = n_h // h_kv
    qg = q.reshape(b, s, h_kv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_cache.float())
    scores = scores * (cfg.head_dim ** -0.5)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(dt), v_cache.to(dt))
    return o.to(dt).reshape(b, s, n_h, dh)


def _layer_decode(x, lp, k_all, v_all, layer, length, cfg, cos, sin,
                  prefill=False, tp_group=None, experts=(0, None)):
    """One decoder layer over S new tokens at positions [length, length+S).
    x: [B, S, d]; the new K/V rows are written into the stacked caches
    ``k_all``/``v_all`` [L, B, Tmax, Hkv, Dh] in place. ``prefill=True``
    promises an empty cache: attention then runs the flash kernel over the
    S new tokens only. With ``tp_group`` the layer runs on this rank's
    heads and ff columns and sums its partial products over tp; an MoE
    layer runs the resident experts of ``experts`` (see ``_mlp``). Returns
    the new x."""
    dt = cfg.compute_dtype
    s = x.shape[1]
    q, k_new, v_new = _project(x, lp, cfg)
    positions = torch.arange(length, length + s, device=x.device)
    q = apply_rope(q, cos, sin, positions=positions)
    k_new = apply_rope(k_new, cos, sin, positions=positions)
    k_all[layer, :, length:length + s] = k_new.to(k_all.dtype)
    v_all[layer, :, length:length + s] = v_new.to(v_all.dtype)
    if prefill and s > 1:
        o = flash_attention(q, k_new.to(dt), v_new.to(dt), causal=True)
    else:
        t = length + s
        mask = positions[:, None] >= torch.arange(t, device=x.device)[None]
        o = _attend_cache(q, k_all[layer, :, :t], v_all[layer, :, :t],
                          mask[None], cfg)
    x = _out_proj(x, o, lp, cfg, tp_group)
    # The routed gather applies to single-token steps only: its gathered
    # weight copy grows with S (a long prefill would hold S * k experts).
    routed = ("router" in lp and _moe_decode_mode(cfg) == "routed"
              and s == 1)
    return _mlp(x, lp, cfg, routed=routed, tp_group=tp_group,
                experts=experts)


def advance(params: dict, cache: dict, tokens: torch.Tensor,
            cfg: TransformerConfig, *, prefill: bool = False, mesh=None):
    """Feed ``tokens`` [B, S] at the cache's current length; returns
    (last-position logits [B, V] fp32, cache). The cache tensors are
    updated in place; the returned dict carries the new length.

    ``prefill=True`` selects the flash-attention path for the prompt and
    requires an empty cache (it attends over the new tokens only).

    With a ``mesh``, ``params`` are this rank's pieces
    (``shard_decode_weights``), ``cache`` its piece (``init_cache(...,
    mesh=)``) and ``tokens`` its batch rows; the logits of those rows come
    back whole, gathered over the tp ranks' vocab columns. An MoE layer
    sums its resident experts' share over ep."""
    capacity = cache["k"].shape[2]
    s = tokens.shape[1]
    length = int(cache["length"])
    if s > capacity:
        raise ValueError(
            f"{s} tokens cannot fit a {capacity}-position cache"
        )
    if length + s > capacity:
        raise ValueError(
            f"cache at length {length} cannot take {s} more tokens "
            f"(capacity {capacity})"
        )
    if prefill and length != 0:
        raise ValueError(
            f"prefill=True requires an empty cache, got length {length} — "
            f"the flash prefill branch would ignore the cached context"
        )
    device = cache["k"].device
    if "qkv" not in params["layers"]:
        params = decode_weights(params, cfg)
    tp_group, experts = None, (0, None)
    if mesh is not None:
        tp_group, tp = axis_group(mesh, "tp")
        if cfg.n_experts:
            ep_group, ep = axis_group(mesh, "ep")
            experts = (_resident_experts(cfg, mesh).start,
                       ep_group if ep > 1 else None)
        want = (cfg.n_heads + 2 * cfg.kv_heads) // tp
        if params["layers"]["qkv"].shape[-2] != want:
            raise ValueError(
                f"advance(mesh=) takes this rank's pieces "
                f"(shard_decode_weights): {want} packed heads, the params "
                f"hold {params['layers']['qkv'].shape[-2]}")
        if tp == 1:  # one rank's sums and gathers are its own tensors
            tp_group = None
    dt = cfg.compute_dtype
    cos, sin = cached_rope_frequencies(cfg.head_dim, cfg.max_seq,
                                       theta=cfg.rope_theta, device=device)
    x = params["embed"][tokens.to(device).long()].to(dt)
    for layer in range(cfg.n_layers):
        x = _layer_decode(x, layer_params(params, layer), cache["k"],
                          cache["v"], layer, length, cfg, cos, sin,
                          prefill=prefill, tp_group=tp_group,
                          experts=experts)
    # Only the last position is sampled: slice before the unembed.
    x = rms_norm(x[:, -1:], params["final_norm"]).to(dt)
    logits = (x @ params["unembed"])[:, 0].float()
    if tp_group is not None:
        logits = all_gather_tp(logits, 1, "tp", mesh=mesh)
    return logits, {"k": cache["k"], "v": cache["v"], "length": length + s}


def _categorical(logits: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits), by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _sample(logits, temperature, top_k, top_p, generator):
    """Greedy at temperature 0; else temperature sampling with optional
    top-k truncation and/or top-p (nucleus) filtering of the scaled
    logits before the draw."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits / temperature
    if 0 < top_k < scaled.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, NEG_INF, scaled)
    if top_p < 1.0:
        # Keep the smallest prefix of the sorted distribution whose
        # cumulative probability reaches top_p (the first token always
        # survives).
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        threshold = torch.where(keep, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        scaled = torch.where(scaled < threshold, NEG_INF, scaled)
    return _categorical(scaled, generator)


class GenerateResult(NamedTuple):
    """``generate(..., eos_id=)`` result: ``tokens`` [B, max_new_tokens]
    with every position from a row's first EOS onward forced to
    ``eos_id``, and ``lengths`` [B], the generated tokens up to and
    including the EOS (``max_new_tokens`` when a row never stops)."""

    tokens: torch.Tensor
    lengths: torch.Tensor


def generate(
    params: dict,
    prompt,
    cfg: TransformerConfig,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_token: int | None = None,
    eos_id: int | None = None,
    pad_token: int = 0,
    generator: torch.Generator | None = None,
    device="cuda",
    mesh=None,
):
    """Prefill the prompt [B, T0] (flash attention), then decode
    ``max_new_tokens`` greedily or by temperature sampling. Returns the
    generated tokens [B, max_new_tokens] int32 on ``device``.

    ``eos_id``: finished rows stop sampling (their positions are forced to
    ``eos_id``) and the loop exits once every row is done; returns
    ``GenerateResult(tokens, lengths)``. ``eos_token`` (legacy): positions
    after a row's first EOS come back as ``pad_token`` after the full
    horizon ran. The two are mutually exclusive.

    With a ``mesh`` (what ``DecodeSession(mesh=)`` passes), every rank
    calls with the whole prompt and ``params`` its pieces
    (``shard_decode_weights``); it decodes its rows over dp, and every rank
    samples the whole batch from the gathered logits and returns it. A
    temperature draw takes the generator state of the mesh's rank 0 on
    every rank (one broadcast), so the ranks draw the same numbers."""
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=device).long()
    b, t0 = prompt.shape
    if eos_token is not None and eos_id is not None:
        raise ValueError(
            "eos_token (post-hoc pad masking) and eos_id (done-mask early "
            "exit) are different contracts — pass one"
        )
    if t0 + max_new_tokens > cfg.max_seq:
        raise ValueError(
            f"prompt ({t0}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"cfg.max_seq ({cfg.max_seq}) — RoPE positions would clamp and "
            f"silently repeat"
        )
    if temperature != 0.0 and generator is None:
        raise ValueError("temperature sampling needs an explicit "
                         "torch.Generator")
    if temperature == 0.0 and (top_k > 0 or top_p < 1.0):
        raise ValueError(
            "top_k/top_p truncate a SAMPLING distribution; greedy decoding "
            "(temperature=0) takes the argmax — set a temperature"
        )
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    params = fused_on(params, cfg, device)
    rows = _dp_rows(b, mesh)
    split_rows = rows.stop - rows.start < b

    def sample(logits):
        return _sample(logits, temperature, top_k, top_p, generator)

    def step(cache, tokens, prefill=False):
        """The whole batch's last-position logits after ``tokens`` [B, S]
        (this rank feeds its rows)."""
        logits, cache = advance(params, cache, tokens[rows], cfg,
                                prefill=prefill, mesh=mesh)
        if split_rows:
            logits = all_gather_tp(logits, 0, "dp", mesh=mesh)
        return logits, cache

    with torch.no_grad():
        if max_new_tokens == 0:
            toks = torch.zeros((b, 0), dtype=torch.int32, device=device)
            if eos_id is not None:
                return GenerateResult(
                    toks, torch.zeros(b, dtype=torch.int32, device=device))
            return toks
        if mesh is not None and generator is not None:
            _share_generator(generator, mesh)
        cache = init_cache(cfg, b, t0 + max_new_tokens, device, mesh)
        logits, cache = step(cache, prompt, prefill=True)
        tok = sample(logits)
        if eos_id is not None:
            return _generate_loop_eos(step, cache, tok, max_new_tokens,
                                      sample, eos_id)
        out = [tok]
        # The last sampled token is never fed back: no trailing forward.
        for _ in range(max_new_tokens - 1):
            logits, cache = step(cache, tok[:, None])
            tok = sample(logits)
            out.append(tok)
        toks = torch.stack(out, dim=1).to(torch.int32)
    if eos_token is not None:
        is_eos = (toks == eos_token).to(torch.int32)
        after = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
        toks = torch.where(after, torch.full_like(toks, pad_token), toks)
    return toks


def _share_generator(generator: torch.Generator, mesh) -> None:
    """Set ``generator`` to the state the mesh's rank 0 holds in its
    own (one broadcast over the default group, which the mesh spans)."""
    state = generator.get_state().to(mesh.device_type)
    dist.broadcast(state, src=0)
    generator.set_state(state.cpu())


def _generate_loop_eos(step, cache, tok, max_new_tokens, sample, eos_id):
    """EOS-aware decode: a per-row done mask; the loop exits when every
    row has emitted ``eos_id`` or the horizon runs out. Every step draws
    the same [B, V] noise as the plain loop, so a running row samples what
    the plain loop would have at that step."""
    b = tok.shape[0]
    device = tok.device
    out = torch.full((b, max_new_tokens), eos_id, dtype=torch.int32,
                     device=device)
    out[:, 0] = tok.to(torch.int32)
    lengths = torch.ones(b, dtype=torch.int32, device=device)
    done = tok == eos_id
    i = 1
    while i < max_new_tokens and not bool(done.all()):
        logits, cache = step(cache, tok[:, None])
        nxt = torch.where(done, torch.full_like(tok, eos_id), sample(logits))
        out[:, i] = nxt.to(torch.int32)
        lengths = torch.where(done, lengths, torch.full_like(lengths, i + 1))
        done = done | (nxt == eos_id)
        tok = nxt
        i += 1
    return GenerateResult(out, lengths)


class DecodeSession:
    """Persistent serving session: fuse and place the weights ONCE, then
    ``generate`` repeatedly without re-fusing.

        session = DecodeSession(params, cfg)            # device="cuda"
        out = session.generate(prompt, max_new_tokens=128)

    ``refresh(params)`` re-fuses updated weights.

    **Sharded serving**: pass ``mesh=`` (a ``parallel.build_mesh`` result,
    e.g. over ``MeshSpec(tp=4)``, or ``MeshSpec(ep=2, tp=2)`` for an MoE
    trunk; every rank of it builds the session from
    the same whole weights and calls ``generate`` with the same prompt).
    Each rank keeps its pieces (``shard_decode_weights``) and a cache of
    its batch rows over dp and its K/V heads over tp (an MoE trunk's
    experts over ep), and ``generate`` returns the whole batch on every
    rank. The mesh's device type must be
    the session's.

    A tune record for (cfg, mesh) (``autotune.lookup("decode_generate")``)
    pins the flash tile knob for the prefill. Each distinct ``generate``
    signature's first call runs under ``plan.timed_compile``: timed into
    ``tony_compile_ms`` and counted as a compile-cache hit or miss."""

    def __init__(self, params: dict, cfg: TransformerConfig, device="cuda",
                 mesh=None) -> None:
        self.device = resolve_device(device)
        if mesh is not None:
            check_decode_mesh(mesh, cfg)
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh cannot serve "
                                 f"on {self.device}")
        self.cfg = cfg
        self.mesh = mesh
        self.params: dict = {}
        # The generate signatures whose first call has been timed.
        self._compiled: set[tuple] = set()
        tuned = autotune.lookup("decode_generate", config=cfg, mesh=mesh)
        if tuned is not None and (tuned.block_q or tuned.block_k):
            attention.set_tuned_blocks(tuned.block_q, tuned.block_k)
        self.refresh(params)

    def refresh(self, params: dict) -> None:
        """Re-fuse from (possibly updated) training params; fused layouts
        are taken as they are. Either way the weights move to the
        session's device, and on a mesh each rank keeps its pieces."""
        fused = fused_on(params, self.cfg, self.device)
        if self.mesh is not None:
            fused = shard_decode_weights(fused, self.cfg, self.mesh)
        self.params = fused

    def generate(self, prompt, max_new_tokens: int, **kwargs):
        """Same surface as module-level ``generate`` minus params, cfg,
        device and mesh."""
        # Every kwarg joins the signature: a missed distinction would leave
        # a first call uncounted (a false hit), never a wrong result.
        shape = getattr(prompt, "shape", None)
        sig = (
            tuple(shape) if shape is not None else repr(prompt),
            str(getattr(prompt, "dtype", type(prompt).__name__)),
            max_new_tokens,
            tuple(sorted((k, repr(v)) for k, v in kwargs.items())),
        )
        if sig not in self._compiled:
            key = plan_lib.plan_cache_key(
                "decode_generate", config=self.cfg, mesh=self.mesh,
                extra={"sig": repr(sig)},
            )
            with plan_lib.timed_compile(key):
                out = generate(self.params, prompt, self.cfg, max_new_tokens,
                               device=self.device, mesh=self.mesh, **kwargs)
            # Marked only on success: a failed first call must not exempt
            # the next one from the count.
            self._compiled.add(sig)
            return out
        return generate(self.params, prompt, self.cfg, max_new_tokens,
                        device=self.device, mesh=self.mesh, **kwargs)
