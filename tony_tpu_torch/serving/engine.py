"""Device half of the continuous-batching serving engine.

* ``decode_window`` — ``steps`` decode iterations for ALL slots. The slot
  batch is a fixed [S] lane array; each slot owns a row of the stacked KV
  cache [L, S, Tmax, Hkv, Dh], its own position and its own sampling
  temperature, so requests of different lengths share every decode step.
  Each slot's new K/V row is written at its own offset; attention masks per
  row with ``key_index <= pos[slot]``.
* ``prefill_chunks`` — one bounded chunk of each of P pending prompts into
  their slots' cache rows, in one call.

Both run over the fused ``decode_weights`` layout and update the two cache
tensors IN PLACE (the JAX package donates them); they return the same
tensors for symmetry with it. Attention reads only the cache rows below the
largest visible position of the call: every row past it is masked for every
query, so leaving it out changes no result.

Overwrite-before-read invariant: slot reuse never zeroes a cache row. A
freed slot's stale K/V rows are only unmasked after the new request's own
prefill/decode has written those positions (prefill covers [0, P); each
decode step writes index ``pos`` before attention reads it).

The int8 KV cache (``kv_quant="int8"``) waits for a later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.decode import (
    _attend_cache,
    _categorical,
    _mlp,
    _out_proj,
    _project,
    layer_params,
)
from tony_tpu_torch.models.transformer import TransformerConfig
from tony_tpu_torch.ops import apply_rope, cached_rope_frequencies, rms_norm


def init_slot_cache(cfg: TransformerConfig, slots: int, max_len: int,
                    kv_quant: str = "none", device="cuda"):
    """Zeroed stacked KV cache pair [L, S, Tmax, Hkv, Dh], one row per
    slot, sized once for the engine's lifetime: 2 * L * S * Tmax * Hkv *
    Dh * dtype bytes."""
    if kv_quant == "int8":
        raise NotImplementedError(
            "the int8 KV cache waits for a later slice of the port"
        )
    if kv_quant not in ("none", "", None):
        raise ValueError(f"unknown kv_quant mode {kv_quant!r}")
    device = resolve_device(device)
    shape = (cfg.n_layers, slots, max_len, cfg.kv_heads, cfg.head_dim)
    dt = cfg.compute_dtype
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))


def cache_inject_rows(cache: torch.Tensor, slot: int, rows) -> torch.Tensor:
    """Write float rows [L, P, Hkv, Dh] into one slot's prefix, in place
    (the inject half of prefill/decode disaggregation)."""
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.array(rows))
    cache[:, slot, :rows.shape[1]] = rows.to(device=cache.device,
                                             dtype=cache.dtype)
    return cache


def cache_export_rows(cache: torch.Tensor, slot: int,
                      length: int) -> torch.Tensor:
    """One slot's KV prefix as float32 rows [L, length, Hkv, Dh] — the
    exchange format is always float."""
    return cache[:, slot, :length].float()


def _draw_seed(base_seed: int, draw: int) -> int:
    """Positional sampling schedule: the seed of draw ``draw`` depends
    only on (base_seed, draw), so a run is reproducible from both."""
    return (int(base_seed) * 1_000_003 + int(draw)) % (2 ** 63)


def _sample_slots(logits: torch.Tensor, temp: np.ndarray, base_seed: int,
                  draw: int) -> torch.Tensor:
    """Per-slot sampling: greedy where ``temp == 0``, else temperature
    sampling. ``temp`` lives on the host, so an all-greedy slot batch
    (the common serving default) never pays for the random draw."""
    greedy = torch.argmax(logits, dim=-1)
    if not (temp > 0.0).any():
        return greedy
    t = torch.as_tensor(temp, dtype=torch.float32, device=logits.device)
    gen = torch.Generator(device=logits.device)
    gen.manual_seed(_draw_seed(base_seed, draw))
    drawn = _categorical(logits / t.clamp_min(1e-6)[:, None], gen)
    return torch.where(t > 0.0, drawn, greedy)


@torch.no_grad()
def decode_window(params, k_all, v_all, pos, wpos, tokens, temp, base_seed,
                  draw0, cfg: TransformerConfig, steps: int = 1):
    """``steps`` decode iterations for every slot: feed ``tokens`` [S] at
    each slot's own ``pos``, write the new K/V row at ``wpos``, attend the
    slot's cache prefix, sample the next token per slot, advance, repeat.
    ``pos``/``wpos``/``tokens``/``temp`` are host arrays [S]; the caches
    are updated in place.

    Inactive slots still compute (the lane array is fixed) and still
    WRITE — the scheduler parks their ``wpos`` at ``Tmax - 1``, the one
    index the overwrite-before-read invariant protects unconditionally
    (writing at a stale ``pos`` would clobber rows a concurrent prefill
    into that slot already filled). Past a stream's retirement point
    mid-window its writes clamp at ``Tmax - 1`` too. Draw i of the window
    samples with the seed of (base_seed, draw0 + i).

    Returns (k_all, v_all, window_tokens [S, steps] int64 on the device).
    """
    dt = cfg.compute_dtype
    device = k_all.device
    t_max = k_all.shape[2]
    n_slots = k_all.shape[1]
    cos, sin = cached_rope_frequencies(cfg.head_dim, cfg.max_seq,
                                       theta=cfg.rope_theta, device=device)
    lanes = torch.arange(n_slots, device=device)
    pos_t = torch.as_tensor(np.asarray(pos), device=device).long()
    wpos_t = torch.as_tensor(np.asarray(wpos), device=device).long()
    tok = torch.as_tensor(np.asarray(tokens), device=device).long()
    max_pos = int(np.max(pos))
    out = []
    for i in range(steps):
        x = params["embed"][tok][:, None, :].to(dt)            # [S, 1, d]
        # Inactive lanes' pos can run past the table mid-window: clamp the
        # RoPE gather (their output is discarded).
        rp = pos_t.clamp(max=cfg.max_seq - 1)[:, None]
        t_vis = min(t_max, max_pos + i + 1)
        mask = (torch.arange(t_vis, device=device)[None, :]
                <= pos_t[:, None])                             # [S, T]
        for layer in range(cfg.n_layers):
            lp = layer_params(params, layer)
            q, k_new, v_new = _project(x, lp, cfg)
            q = apply_rope(q, cos, sin, positions=rp)
            k_new = apply_rope(k_new, cos, sin, positions=rp)
            k_all[layer, lanes, wpos_t] = k_new[:, 0].to(k_all.dtype)
            v_all[layer, lanes, wpos_t] = v_new[:, 0].to(v_all.dtype)
            o = _attend_cache(q, k_all[layer, :, :t_vis],
                              v_all[layer, :, :t_vis], mask[:, None, :], cfg)
            x = _mlp(_out_proj(x, o, lp, cfg), lp, cfg)
        x = rms_norm(x, params["final_norm"]).to(dt)
        logits = (x @ params["unembed"])[:, 0].float()
        tok = _sample_slots(logits, temp, base_seed, draw0 + i)
        out.append(tok)
        pos_t = pos_t + 1
        wpos_t = (wpos_t + 1).clamp(max=t_max - 1)
    return k_all, v_all, torch.stack(out, dim=1)


@torch.no_grad()
def prefill_chunks(params, k_all, v_all, tokens, slots, starts, n_valids,
                   temps, base_seed, draw, cfg: TransformerConfig):
    """Prefill one chunk for EACH of P pending slots: ``tokens`` [P, C]
    row i is written into slot ``slots[i]`` at positions
    [starts[i], starts[i] + C). All arguments but the params and caches
    are host arrays.

    The host guarantees distinct slots per batch and ``start + C <=
    Tmax``; it pads short batches by duplicating row 0, so the writes go
    in order, row by row (a duplicate rewrites identical K/V). Padded
    tails past ``n_valids[i]`` write garbage the overwrite-before-read
    invariant keeps unreadable.

    Returns (k_all, v_all, first_tokens [P], logits [P, V] fp32): row i
    samples from position ``n_valids[i] - 1``, which is meaningful only on
    a request's final chunk."""
    dt = cfg.compute_dtype
    device = k_all.device
    tokens = np.asarray(tokens)
    starts = np.asarray(starts)
    p, c = tokens.shape
    t_max = k_all.shape[2]
    if int(starts.max()) + c > t_max:
        raise ValueError(f"chunk at {int(starts.max())} + {c} overruns the "
                         f"{t_max}-position cache")
    cos, sin = cached_rope_frequencies(cfg.head_dim, cfg.max_seq,
                                       theta=cfg.rope_theta, device=device)
    positions = (torch.as_tensor(starts, device=device).long()[:, None]
                 + torch.arange(c, device=device)[None, :])    # [P, C]
    rope_pos = positions.clamp(max=cfg.max_seq - 1)
    t_vis = int(starts.max()) + c
    mask = (positions[:, :, None]
            >= torch.arange(t_vis, device=device)[None, None, :])  # [P,C,T]
    slot_idx = torch.as_tensor(np.asarray(slots), device=device).long()
    x = params["embed"][torch.as_tensor(tokens, device=device).long()].to(dt)
    for layer in range(cfg.n_layers):
        lp = layer_params(params, layer)
        q, k_new, v_new = _project(x, lp, cfg)
        q = apply_rope(q, cos, sin, positions=rope_pos)
        k_new = apply_rope(k_new, cos, sin, positions=rope_pos)
        for i in range(p):
            s, st = int(slots[i]), int(starts[i])
            k_all[layer, s, st:st + c] = k_new[i].to(k_all.dtype)
            v_all[layer, s, st:st + c] = v_new[i].to(v_all.dtype)
        o = _attend_cache(q, k_all[layer, slot_idx, :t_vis],
                          v_all[layer, slot_idx, :t_vis], mask, cfg)
        x = _mlp(_out_proj(x, o, lp, cfg), lp, cfg)
    last_idx = torch.as_tensor(np.maximum(np.asarray(n_valids) - 1, 0),
                               device=device).long()
    last = x[torch.arange(p, device=device), last_idx][:, None]  # [P, 1, d]
    last = rms_norm(last, params["final_norm"]).to(dt)
    logits = (last @ params["unembed"])[:, 0].float()
    toks = _sample_slots(logits, np.asarray(temps), base_seed, draw)
    return k_all, v_all, toks, logits
