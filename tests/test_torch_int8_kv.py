"""The port's int8 KV cache (``kv_quant="int8"``) against the JAX package's.

``serving/engine.py``'s quantizer, its two device calls with ``QuantizedKV``
caches and the inject/export exchange, and ``ServingEngine(kv_quant=)`` end
to end, each held against ``tony_tpu.serving`` on the same weights
(converted by ``tony_tpu_torch.interop``) and the same numpy inputs, fp32 on
the CPU. Tolerances: the quantizer bit-equal on the same fp32 rows; the
int8 data written by the device calls equal and their scales within 1e-6
relative (the scales are absmax / 127 of K/V rows that XLA's and torch's
fp32 matmuls round a few ulp apart, more than 1e-7 relative); tokens
equal."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models import init_params as jax_init_params
from tony_tpu.models.decode import decode_weights as jax_decode_weights
from tony_tpu.serving import ServingEngine as JaxEngine
from tony_tpu.serving import engine as j_engine
from tony_tpu_torch.interop import params_from_numpy
from tony_tpu_torch.models import TransformerConfig
from tony_tpu_torch.models.decode import fused_on
from tony_tpu_torch.serving import ServingEngine
from tony_tpu_torch.serving import engine as t_engine

torch.set_num_threads(1)

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=64, max_seq=96, dtype="float32", remat=False)
# tests/test_autotune.py's CFG, the config of JAX's TestInt8KV.
AUTOTUNE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                head_dim=16, d_ff=64, max_seq=96, dtype="float32",
                remat=False)
MOE = dict(TINY, n_experts=4, expert_top_k=2)
SCALE_RTOL = 1e-6


def _models(kw: dict, seed: int = 0):
    jcfg = JaxConfig(**kw)
    cfg = TransformerConfig(**kw)
    jparams = jax_init_params(jax.random.key(seed), jcfg)
    params = params_from_numpy(jax.device_get(jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def tiny():
    return _models(TINY)


def _np(q) -> tuple[np.ndarray, np.ndarray]:
    """(data, scale) of either package's QuantizedKV as numpy."""
    return np.asarray(q.data), np.asarray(q.scale)


def _assert_same_cache(got, want, tag: str) -> None:
    gd, gs = _np(got)
    wd, ws = _np(want)
    np.testing.assert_array_equal(gd, wd, err_msg=f"{tag} data")
    np.testing.assert_allclose(gs, ws, rtol=SCALE_RTOL, atol=0,
                               err_msg=f"{tag} scale")


# -- the quantizer -----------------------------------------------------------


def test_quantize_and_materialize_match_jax():
    """Per-row absmax over Dh in fp32, scale max(absmax, 1e-8) / 127,
    round half to even, clip to +-127: data and scales bit-equal to JAX's
    on rows of every magnitude, a zero row (the 1e-8 floor) and rows whose
    every value lies on a .5 boundary of its grid (JAX's division and
    torch's agree there: 0 elements differ)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 24, 2, 16))
         * rng.uniform(1e-3, 1e2, (8, 24, 2, 1))).astype(np.float32)
    step = np.abs(x).max(-1, keepdims=True) / np.float32(127)
    ties = ((np.round(x / step) + 0.5).clip(-126.5, 126.5)
            * step).astype(np.float32)
    ties[..., 0] = 127 * step[..., 0]
    x[0, 0, 0] = 0.0
    for rows in (x, ties):
        got = t_engine._quantize(torch.from_numpy(rows))
        want = j_engine._quantize(jnp.asarray(rows))
        gd, gs = _np(got)
        wd, ws = _np(want)
        assert got.data.dtype == torch.int8 and got.scale.shape == (
            *rows.shape[:-1], 1)
        np.testing.assert_array_equal(gs, ws)
        assert int((gd != wd).sum()) == 0
        for t_dt, j_dt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
            back = t_engine._materialize(got, t_dt).float().numpy()
            ref = np.asarray(j_engine._materialize(want, j_dt),
                             np.float32)
            np.testing.assert_array_equal(back, ref)
    zero = t_engine._quantize(torch.from_numpy(x[0, 0, :1]))
    assert zero.scale.item() == np.float32(1e-8) / np.float32(127)
    assert not bool(zero.data.any())


def test_quantize_roundtrip_error_bounded():
    """JAX's TestInt8KV bound: the round trip is off by at most amax / 127
    (+ 1e-6)."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, 2, 16)).astype(np.float32))
    back = t_engine._materialize(t_engine._quantize(x), torch.float32)
    assert float((back - x).abs().max()) <= float(x.abs().max()) / 127 + 1e-6


# -- the device calls --------------------------------------------------------


def test_prefill_chunks_and_decode_window_match_jax(tiny):
    """Two prefill calls (two slots, then one slot's second chunk, a
    padded duplicate row and a short n_valid) and a decode window of 3
    steps with a parked inactive lane, all on int8 caches: the sampled
    tokens equal JAX's, the int8 data equal, the scales within
    SCALE_RTOL."""
    jcfg, jparams, cfg, params = tiny
    jfused = jax_decode_weights(jparams, jcfg)
    fused = fused_on(params, cfg, torch.device("cpu"))
    key = jax.random.key(0)
    jk, jv = j_engine.init_slot_cache(jcfg, 3, 48, kv_quant="int8")
    tk, tv = t_engine.init_slot_cache(cfg, 3, 48, kv_quant="int8",
                                      device="cpu")
    rng = np.random.default_rng(4)
    calls = [
        (rng.integers(0, 64, (2, 8)), [0, 2], [0, 0], [8, 5]),
        (rng.integers(0, 64, (2, 8)), [0, 0], [8, 8], [8, 8]),
    ]
    temps = np.zeros(2, np.float32)
    for i, (toks, slots, starts, n_valids) in enumerate(calls):
        args = [np.asarray(a, np.int32) for a in (toks, slots, starts,
                                                  n_valids)]
        jk, jv, jt, jl = j_engine.prefill_chunks(
            jfused, jk, jv, *args, temps, key, np.int32(i), cfg=jcfg)
        tk, tv, tt, tl = t_engine.prefill_chunks(
            fused, tk, tv, *args, temps, 0, i, cfg=cfg)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        _assert_same_cache(tk, jk, f"prefill {i} k")
        _assert_same_cache(tv, jv, f"prefill {i} v")
    pos = np.array([16, 0, 5], np.int32)
    wpos = np.array([16, 47, 5], np.int32)      # slot 1 inactive, parked
    tokens = np.array([7, 0, 3], np.int32)
    temp = np.zeros(3, np.float32)
    jk, jv, jw = j_engine.decode_window(jfused, jk, jv, pos, wpos, tokens,
                                        temp, key, np.int32(0), cfg=jcfg,
                                        steps=3)
    tk, tv, tw = t_engine.decode_window(fused, tk, tv, pos, wpos, tokens,
                                        temp, 0, 0, cfg=cfg, steps=3)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    _assert_same_cache(tk, jk, "decode k")
    _assert_same_cache(tv, jv, "decode v")
    # The window wrote rows 16..18 of slot 0 and parked slot 1 at 47.
    assert bool((tk.data[:, 0, 16:19] != 0).any())
    assert bool((tk.data[:, 1, 1:47] == 0).all())


def test_inject_and_export_across_modes_match_jax(tiny):
    """The exchange format is float: rows exported from a bf16 cache are
    injected into an int8 cache, whose export is injected into an fp32
    cache, in both packages; every cache and export equals JAX's."""
    jcfg, _, cfg, _ = tiny
    rows = np.random.default_rng(5).standard_normal(
        (cfg.n_layers, 7, cfg.kv_heads, cfg.head_dim)).astype(np.float32)
    jbf = JaxConfig(**{**TINY, "dtype": "bfloat16"})
    tbf = TransformerConfig(**{**TINY, "dtype": "bfloat16"})
    jk, _ = j_engine.init_slot_cache(jbf, 3, 16)
    tk, _ = t_engine.init_slot_cache(tbf, 3, 16, device="cpu")
    jk = j_engine.cache_inject_rows(jk, 1, jnp.asarray(rows))
    t_engine.cache_inject_rows(tk, 1, rows)
    bf_rows = t_engine.cache_export_rows(tk, 1, 7)
    assert bf_rows.dtype == torch.float32
    np.testing.assert_array_equal(
        bf_rows.numpy(),
        np.asarray(j_engine.cache_export_rows(jk, 1, 7), np.float32))

    jq, _ = j_engine.init_slot_cache(jcfg, 3, 16, kv_quant="int8")
    tq, _ = t_engine.init_slot_cache(cfg, 3, 16, kv_quant="int8",
                                     device="cpu")
    jq = j_engine.cache_inject_rows(jq, 2, jnp.asarray(bf_rows.numpy()))
    t_engine.cache_inject_rows(tq, 2, bf_rows.numpy())
    _assert_same_cache(tq, jq, "bf16 -> int8")
    assert bool((tq.data[:, :2] == 0).all())
    q_rows = t_engine.cache_export_rows(tq, 2, 7)
    np.testing.assert_array_equal(
        q_rows.numpy(), np.asarray(j_engine.cache_export_rows(jq, 2, 7)))

    jf, _ = j_engine.init_slot_cache(jcfg, 3, 16)
    tf, _ = t_engine.init_slot_cache(cfg, 3, 16, device="cpu")
    jf = j_engine.cache_inject_rows(jf, 0, jnp.asarray(q_rows.numpy()))
    t_engine.cache_inject_rows(tf, 0, q_rows)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


# -- the engine --------------------------------------------------------------


def _drive(eng, prompts, budget: int) -> list[list[int]]:
    """Submit every prompt, then step the engine until all retire."""
    reqs = [eng.submit(p, budget) for p in prompts]
    for _ in range(2000):
        if all(r.done() for r in reqs):
            break
        eng.step()
    out = [r.result(timeout=5)["tokens"] for r in reqs]
    eng.close()
    return out


PROMPTS = [np.array([3, 7, 11, 19, 5], np.int32),
           np.arange(1, 22, dtype=np.int32) % 60,
           np.array([9, 2, 44, 17, 30, 6, 1, 8, 8, 50, 12], np.int32)]


def test_int8_engine_matches_jax_int8_engine():
    """tests/test_autotune.py's TestInt8KV model and settings (slots 2,
    max_len 96, chunk 8, greedy, 24 new tokens), with three requests so a
    slot is reused: the port's int8 engine gives JAX's int8 engine's tokens
    exactly (stronger than JAX's own bound against the float cache)."""
    jcfg, jparams, cfg, params = _models(AUTOTUNE)
    kw = dict(slots=2, max_len=96, prefill_chunk=8, kv_quant="int8")
    want = _drive(JaxEngine(jparams, jcfg, **kw), PROMPTS, 24)
    got = _drive(ServingEngine(params, cfg, device="cpu", **kw), PROMPTS,
                 24)
    assert got == want


def test_int8_greedy_parity_bound_against_float_cache():
    """JAX's TestInt8KV.test_greedy_parity_bound on the port: int8 greedy
    decode agrees with the float cache on a prefix of at least 8 tokens
    and at least half of the 24."""
    _, _, cfg, params = _models(AUTOTUNE)
    kw = dict(device="cpu", slots=2, max_len=96, prefill_chunk=8)
    a = _drive(ServingEngine(params, cfg, kv_quant="none", **kw),
               PROMPTS[:1], 24)[0]
    b = _drive(ServingEngine(params, cfg, kv_quant="int8", **kw),
               PROMPTS[:1], 24)[0]
    assert len(a) == len(b) == 24
    prefix = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                  len(a))
    assert prefix >= 8, (a, b)
    assert sum(int(x == y) for x, y in zip(a, b)) >= len(a) // 2, (a, b)


def test_moe_trunk_served_with_int8_matches_jax():
    """An MoE trunk (4 experts, top-2; the dense mixture in both engines)
    served from an int8 cache: the port's tokens equal JAX's."""
    jcfg, jparams, cfg, params = _models(MOE, seed=3)
    kw = dict(slots=2, max_len=64, prefill_chunk=8, kv_quant="int8")
    want = _drive(JaxEngine(jparams, jcfg, **kw), PROMPTS[:2], 12)
    got = _drive(ServingEngine(params, cfg, device="cpu", **kw),
                 PROMPTS[:2], 12)
    assert got == want


def test_cache_layout_modes_and_stats(tiny, monkeypatch):
    """The int8 layout (int8 data, fp32 scales [..., 1]); the mode from
    TONY_TUNE_KV_QUANT when the caller passes none, a typo there degrading
    to "none"; an explicit mode winning; a bad explicit mode refused;
    stats() reporting the mode."""
    _, _, cfg, params = tiny
    kw = dict(device="cpu", slots=2, max_len=32)
    monkeypatch.delenv("TONY_TUNE_KV_QUANT", raising=False)
    eng = ServingEngine(params, cfg, **kw)
    assert eng.kv_quant == "none" and isinstance(eng._k, torch.Tensor)
    monkeypatch.setenv("TONY_TUNE_KV_QUANT", " INT8 ")
    eng = ServingEngine(params, cfg, **kw)
    assert isinstance(eng._k, t_engine.QuantizedKV)
    assert eng._k.data.dtype == torch.int8
    assert eng._k.scale.dtype == torch.float32
    assert eng._k.scale.shape == eng._k.data.shape[:-1] + (1,)
    assert eng._k.data.shape == (cfg.n_layers, 2, 32, cfg.kv_heads,
                                 cfg.head_dim)
    assert eng.stats()["kv_quant"] == "int8"
    assert ServingEngine(params, cfg, kv_quant="none",
                         **kw).stats()["kv_quant"] == "none"
    monkeypatch.setenv("TONY_TUNE_KV_QUANT", "int9")
    assert ServingEngine(params, cfg, **kw).kv_quant == "none"
    with pytest.raises(ValueError, match="kv_quant must be one of"):
        ServingEngine(params, cfg, kv_quant="fp4", **kw)


def test_prefill_chunks_per_iter_orders_calls_as_jax():
    """prefill_chunks_per_iter=1 against the auto budget (None: one chunk
    for every pending slot an iteration): the sequence of prefill calls
    (tokens, slots, starts, n_valids) equals JAX's engine's in both, and
    the tokens are the same either way."""
    jcfg, jparams, cfg, params = _models(AUTOTUNE)
    seqs, tokens = {}, {}
    for budget in (1, None):
        kw = dict(slots=3, max_len=64, prefill_chunk=4, prefill_batch=2,
                  prefill_chunks_per_iter=budget, kv_quant="int8")
        jeng = JaxEngine(jparams, jcfg, **kw)
        jcalls = []
        jprefill = jeng._prefill

        def jrec(*a, _f=jprefill, _calls=jcalls):
            _calls.append([np.asarray(x).tolist() for x in a[3:7]])
            return _f(*a)

        jeng._prefill = jrec
        want = _drive(jeng, PROMPTS, 6)
        tcalls = []
        prefill = t_engine.prefill_chunks

        def trec(*a, _calls=tcalls, **kw):
            _calls.append([np.asarray(x).tolist() for x in a[3:7]])
            return prefill(*a, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(t_engine, "prefill_chunks", trec)
            got = _drive(ServingEngine(params, cfg, device="cpu", **kw),
                         PROMPTS, 6)
        assert got == want
        assert tcalls == jcalls
        seqs[budget], tokens[budget] = tcalls, got
    assert tokens[1] == tokens[None]
    assert len(seqs[1]) > len(seqs[None])
    # Budget 1: one real entry a call (the rest of the batch duplicates it).
    assert all(len(set(zip(c[1], c[2]))) == 1 for c in seqs[1])
