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

MoE trunks and sharded sessions (``mesh=``) wait for later slices of the
port and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.transformer import TransformerConfig
from tony_tpu_torch.ops import (
    apply_rope,
    cached_rope_frequencies,
    flash_attention,
    rms_norm,
)

NEG_INF = -1e30


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE decode waits for a later slice of the port"
        )


def decode_weights(params: dict, cfg: TransformerConfig) -> dict:
    """Re-pack training params for decode: cast to the compute dtype and
    fuse wq|wk|wv on the head axis ([L, d, H + 2*Hkv, Dh]) and
    w_gate|w_up on the feature axis ([L, d, 2F]). Norm weights are cast
    to the compute dtype too."""
    _dense_only(cfg)
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
    return {
        "embed": params["embed"].to(dt),
        "final_norm": params["final_norm"].to(dt),
        "unembed": params["unembed"].to(dt),
        "layers": layers,
    }


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


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zeroed cache pair [L, B, max_len, Hkv, Dh] in the compute dtype."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    dt = cfg.compute_dtype
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "length": 0,
    }


def _project(x, lp, cfg):
    """Pre-norm fused qkv projection: (q [B,S,H,Dh], k [B,S,Hkv,Dh],
    v [B,S,Hkv,Dh]); k and v are views of one product."""
    dt = cfg.compute_dtype
    b, s, d = x.shape
    n_h, h_kv = cfg.n_heads, cfg.kv_heads
    h = rms_norm(x, lp["ln1"]).to(dt)
    qkv = (h @ lp["qkv"].reshape(d, -1)).view(b, s, n_h + 2 * h_kv,
                                              cfg.head_dim)
    return qkv[:, :, :n_h], qkv[:, :, n_h:n_h + h_kv], qkv[:, :, n_h + h_kv:]


def _out_proj(x, o, lp, cfg):
    dt = cfg.compute_dtype
    b, s, d = x.shape
    return x + o.to(dt).reshape(b, s, -1) @ lp["wo"].reshape(-1, d)


def _mlp(x, lp, cfg):
    """Residual SwiGLU over the fused gate|up projection: silu in fp32,
    cast to the compute dtype, times up."""
    _dense_only(cfg)
    dt = cfg.compute_dtype
    hn = rms_norm(x, lp["ln2"]).to(dt)
    gu = hn @ lp["gate_up"]
    f = gu.shape[-1] // 2
    act = torch.nn.functional.silu(gu[..., :f].float()).to(dt) * gu[..., f:]
    return x + act @ lp["w_down"]


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
                  prefill=False):
    """One decoder layer over S new tokens at positions [length, length+S).
    x: [B, S, d]; the new K/V rows are written into the stacked caches
    ``k_all``/``v_all`` [L, B, Tmax, Hkv, Dh] in place. ``prefill=True``
    promises an empty cache: attention then runs the flash kernel over the
    S new tokens only. Returns the new x."""
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
    x = _out_proj(x, o, lp, cfg)
    return _mlp(x, lp, cfg)


def advance(params: dict, cache: dict, tokens: torch.Tensor,
            cfg: TransformerConfig, *, prefill: bool = False):
    """Feed ``tokens`` [B, S] at the cache's current length; returns
    (last-position logits [B, V] fp32, cache). The cache tensors are
    updated in place; the returned dict carries the new length.

    ``prefill=True`` selects the flash-attention path for the prompt and
    requires an empty cache (it attends over the new tokens only)."""
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
    dt = cfg.compute_dtype
    cos, sin = cached_rope_frequencies(cfg.head_dim, cfg.max_seq,
                                       theta=cfg.rope_theta, device=device)
    x = params["embed"][tokens.to(device).long()].to(dt)
    for layer in range(cfg.n_layers):
        x = _layer_decode(x, layer_params(params, layer), cache["k"],
                          cache["v"], layer, length, cfg, cos, sin,
                          prefill=prefill)
    # Only the last position is sampled: slice before the unembed.
    x = rms_norm(x[:, -1:], params["final_norm"]).to(dt)
    logits = (x @ params["unembed"])[:, 0].float()
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
):
    """Prefill the prompt [B, T0] (flash attention), then decode
    ``max_new_tokens`` greedily or by temperature sampling. Returns the
    generated tokens [B, max_new_tokens] int32 on ``device``.

    ``eos_id``: finished rows stop sampling (their positions are forced to
    ``eos_id``) and the loop exits once every row is done; returns
    ``GenerateResult(tokens, lengths)``. ``eos_token`` (legacy): positions
    after a row's first EOS come back as ``pad_token`` after the full
    horizon ran. The two are mutually exclusive."""
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

    def sample(logits):
        return _sample(logits, temperature, top_k, top_p, generator)

    with torch.no_grad():
        if max_new_tokens == 0:
            toks = torch.zeros((b, 0), dtype=torch.int32, device=device)
            if eos_id is not None:
                return GenerateResult(
                    toks, torch.zeros(b, dtype=torch.int32, device=device))
            return toks
        cache = init_cache(cfg, b, t0 + max_new_tokens, device)
        logits, cache = advance(params, cache, prompt, cfg, prefill=True)
        tok = sample(logits)
        if eos_id is not None:
            return _generate_loop_eos(params, cache, tok, cfg,
                                      max_new_tokens, sample, eos_id)
        out = [tok]
        # The last sampled token is never fed back: no trailing forward.
        for _ in range(max_new_tokens - 1):
            logits, cache = advance(params, cache, tok[:, None], cfg)
            tok = sample(logits)
            out.append(tok)
        toks = torch.stack(out, dim=1).to(torch.int32)
    if eos_token is not None:
        is_eos = (toks == eos_token).to(torch.int32)
        after = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
        toks = torch.where(after, torch.full_like(toks, pad_token), toks)
    return toks


def _generate_loop_eos(params, cache, tok, cfg, max_new_tokens, sample,
                       eos_id):
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
        logits, cache = advance(params, cache, tok[:, None], cfg)
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

    ``refresh(params)`` re-fuses updated weights. Sharded sessions
    (``mesh=``) wait for a later slice of the port."""

    def __init__(self, params: dict, cfg: TransformerConfig, device="cuda",
                 mesh=None) -> None:
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "sharded DecodeSession(mesh=) waits for a later slice of "
                "the port"
            )
        self.cfg = cfg
        self.params: dict = {}
        self.refresh(params)

    def refresh(self, params: dict) -> None:
        """Re-fuse from (possibly updated) training params; fused layouts
        are taken as they are. Either way the weights move to the
        session's device."""
        self.params = fused_on(params, self.cfg, self.device)

    def generate(self, prompt, max_new_tokens: int, **kwargs):
        """Same surface as module-level ``generate`` minus params, cfg and
        device."""
        return generate(self.params, prompt, self.cfg, max_new_tokens,
                        device=self.device, **kwargs)
