"""The port's autotuner (``tony_tpu_torch.parallel.autotune``) and the flash
tile knob, held against the JAX package on the CPU.

* Records: the reference's format (version 1) both ways (a record either
  package writes, the other loads and lists), and every failure mode
  (absent, corrupt, torn, a foreign key or version, a non-dict winner, an
  unwritable dir) degrades to a miss.
* ``search``: the same fake ``measure`` in both packages gives the same
  trials, winner, default and best walls: the default first, the budget,
  failed and non-finite trials kept as data, an all-failed search not
  persisted, a warm hit with no trial.
* Consumption: ``lookup`` counts hits and misses; ``make_train_step`` and
  ``DecodeSession`` apply a record (the tile knob pinned, the remat policy
  swapped), unless tuning is off; ``note_step_time`` updates
  ``live_best_ms`` only for an improvement.
* The tile knob: ``flash_attention(block_q=, block_k=)`` on the CPU equals
  JAX's ``flash_attention`` with the same blocks (fp32, 1e-5), values and
  gradients; an explicit tile no instance has raises; a tuned pin fills
  only what a call leaves None, and only at a head_dim that has it.
* The stages on the CPU: ``tune_flash_blocks`` and ``tune_train_step``
  cold, then warm with no trial; the flash stage warms every point before
  it times one, and keeps the default unless a point beats it by more
  than the spread of their windows (``search``'s ``margin``).
* Deviations pinned: no ``apply_xla_flags``, no "1f1b" candidate.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops import flash_attention as jax_flash_attention
from tony_tpu.parallel import autotune as jax_autotune
from tony_tpu_torch import constants, observability
from tony_tpu_torch.models import (DecodeSession, TransformerConfig,
                                   init_params, make_train_step)
from tony_tpu_torch.ops import attention
from tony_tpu_torch.parallel import autotune

torch.set_num_threads(1)

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
            d_ff=64, max_seq=96, dtype="float32", remat=False)
# head_dim 64: a width the tile knob has instances at.
TILED = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=1, head_dim=64,
             d_ff=64, max_seq=96, dtype="float32", remat=True)


def _record(key: str, best=None, **extra) -> dict:
    rec = {"version": 1, "key": key, "label": "t",
           "best": best if best is not None else {"block_q": 128},
           "best_ms": 1.0, "default_ms": 2.0,
           "trials": [{"knobs": {}, "ms": 2.0},
                      {"knobs": {"block_q": 128}, "ms": 1.0}]}
    rec.update(extra)
    return rec


@pytest.fixture(autouse=True)
def _no_pin():
    yield
    attention.clear_tuned_blocks()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_records_cross_read(tmp_path, writer):
    d = str(tmp_path)
    key = "a" * 64
    rec = _record(key, best={"block_q": 128, "block_k": 192,
                             "xla_flags": ["--x"]})
    (jax_autotune if writer == "jax" else autotune).save_record(rec,
                                                                cache_dir=d)
    for mod in (autotune, jax_autotune):
        assert mod.load_record(key, cache_dir=d) == rec
        assert mod.list_records(cache_dir=d) == [rec]
    knobs = autotune.knobs_from_dict(rec["best"])
    want = jax_autotune.knobs_from_dict(rec["best"])
    assert dataclasses.asdict(knobs) == dataclasses.asdict(want)
    assert knobs.describe() == want.describe()


@pytest.mark.parametrize("damage", ["absent", "corrupt", "torn", "key",
                                    "version", "best"])
def test_damaged_records_are_misses(tmp_path, damage):
    d = str(tmp_path)
    key = "b" * 64
    path = tmp_path / autotune._TUNE_DIR / f"{key}.json"
    if damage != "absent":
        autotune.save_record(_record(key), cache_dir=d)
    text = {"corrupt": "{nope", "torn": json.dumps(_record(key))[:40],
            "key": json.dumps(_record("c" * 64)),
            "version": json.dumps(_record(key, version=2)),
            "best": json.dumps(_record(key, best=["x"]))}.get(damage)
    if text is not None:
        path.write_text(text)
    assert autotune.load_record(key, cache_dir=d) is None
    assert jax_autotune.load_record(key, cache_dir=d) is None


def test_unwritable_record_dir_degrades_silently(tmp_path):
    blocked = tmp_path / "file"
    blocked.write_text("")
    assert autotune.record_dir(str(blocked)) is None
    autotune.save_record(_record("d" * 64), cache_dir=str(blocked))
    assert autotune.load_record("d" * 64, cache_dir=str(blocked)) is None
    assert autotune.list_records(cache_dir=str(blocked)) == []


def _fake(walls):
    calls = []

    def measure(knobs):
        calls.append(knobs.describe())
        wall = walls[len(calls) - 1]
        if isinstance(wall, Exception):
            raise wall
        return wall

    return measure, calls


_VOLATILE = ("backend", "ts_ms", "search_ms")

SEARCHES = {
    "default_first_best_wins": ([{}, {"block_q": 128}, {"block_q": 192}],
                                [3.0, 1.0, 2.0], None),
    "budget": ([{"block_q": 128}, {"block_q": 192}, {"block_k": 128},
                {"block_k": 192}], [4.0, 3.0, 2.0, 1.0], 2),
    "failed_and_nonfinite": ([{}, {"block_q": 128}, {"block_q": 192},
                              {"remat_policy": "dots"}],
                             [5.0, RuntimeError("no instance"),
                              float("nan"), -1.0], None),
    "all_failed": ([{}], [RuntimeError("no backend")], None),
}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_search_matches_jax(tmp_path, name):
    points, walls, budget = SEARCHES[name]
    recs = {}
    for label, mod in (("port", autotune), ("jax", jax_autotune)):
        measure, calls = _fake(walls)
        d = str(tmp_path / label)
        rec = mod.search("t", [mod.Knobs(**p) for p in points], measure,
                         key="k" * 64, trial_budget=budget, cache_dir=d)
        recs[label] = ({k: v for k, v in rec.items() if k not in _VOLATILE},
                       calls, mod.load_record("k" * 64, cache_dir=d))
    (got, got_calls, got_saved), (want, want_calls, want_saved) = (
        recs["port"], recs["jax"])
    assert got == want and got_calls == want_calls
    assert (got_saved is None) == (want_saved is None)
    if name == "all_failed":
        assert got["best_ms"] is None and got_saved is None
    if name == "budget":
        assert len(got_calls) == 2
    if name == "failed_and_nonfinite":
        assert [("error" in t) for t in got["trials"]] == [False, True, True,
                                                           True]


def test_warm_search_runs_no_trial(tmp_path):
    d = str(tmp_path)
    reg = observability.default_registry()
    hits = reg.counter(autotune.TUNE_RECORD_HITS_COUNTER)
    measure, calls = _fake([2.0, 1.0])
    cands = [autotune.Knobs(), autotune.Knobs(block_q=128)]
    cold = autotune.search("t", cands, measure, key="w" * 64, cache_dir=d)
    h0 = hits.value
    warm = autotune.search("t", cands, measure, key="w" * 64, cache_dir=d)
    assert cold["trials_this_run"] == 2 and warm["trials_this_run"] == 0
    assert len(calls) == 2 and hits.value == h0 + 1
    assert warm["best"]["block_q"] == 128
    forced = autotune.search("t", cands, _fake([1.0, 3.0])[0], key="w" * 64,
                             cache_dir=d, force=True)
    assert forced["trials_this_run"] == 2 and forced["best"]["block_q"] is None


def test_lookup_counts_and_note_step_time(tmp_path):
    cfg = TransformerConfig(**TINY)
    d = str(tmp_path)
    reg = observability.default_registry()
    hits0 = reg.counter(autotune.TUNE_RECORD_HITS_COUNTER).value
    misses0 = reg.counter(autotune.TUNE_RECORD_MISSES_COUNTER).value
    assert autotune.lookup("absent", config=cfg, cache_dir=d) is None
    key = autotune.tune_key("present", config=cfg)
    autotune.save_record(_record(key), cache_dir=d)
    assert autotune.lookup("present", config=cfg,
                           cache_dir=d).block_q == 128
    assert reg.counter(autotune.TUNE_RECORD_HITS_COUNTER).value == hits0 + 1
    assert reg.counter(
        autotune.TUNE_RECORD_MISSES_COUNTER).value == misses0 + 1
    for step_ms, want in ((0.5, 0.5), (9.0, 0.5), (float("nan"), 0.5),
                          (0.25, 0.25)):
        autotune.note_step_time("present", config=cfg, step_ms=step_ms,
                                cache_dir=d)
        assert autotune.load_record(key, cache_dir=d)["live_best_ms"] == want
    autotune.note_step_time("absent", config=cfg, step_ms=1.0, cache_dir=d)
    assert autotune.load_record(autotune.tune_key("absent", config=cfg),
                                cache_dir=d) is None


@pytest.mark.parametrize("enabled", [True, False])
def test_make_train_step_and_decode_apply_a_record(tmp_path, monkeypatch,
                                                   enabled):
    monkeypatch.setenv(constants.TONY_TUNE_RECORD_DIR, str(tmp_path))
    if not enabled:
        monkeypatch.setenv(constants.TONY_TUNE_ENABLED, "false")
    cfg = TransformerConfig(**TILED)
    key = autotune.tune_key("lm_train_step", config=cfg)
    autotune.save_record(_record(key, best={
        "block_q": 192, "block_k": 192, "remat_policy": "dots"}))
    init_fn, step_fn = make_train_step(cfg, device="cpu")
    assert attention.tuned_blocks() == ((192, 192) if enabled
                                        else (None, None))
    assert step_fn.stepstats.cfg.remat_policy == ("dots" if enabled
                                                  else "full")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17))
    state = init_fn(0)
    for _ in range(5):
        state, metrics = step_fn(state, tokens)
        assert np.isfinite(float(metrics["loss"]))
    # The calibration notes its best wall under the config the step runs,
    # as JAX's does: the tuned one, so a record whose winner changed the
    # config gets no live_best_ms (ROADMAP Queue C); untuned, it does.
    assert step_fn.stepstats.steps_observed == 3
    assert ("live_best_ms" in autotune.load_record(key)) == (not enabled)
    attention.clear_tuned_blocks()
    autotune.save_record(_record(
        autotune.tune_key("decode_generate", config=cfg),
        best={"block_k": 192}))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    session = DecodeSession(params, cfg, device="cpu")
    assert attention.tuned_blocks() == ((None, 192) if enabled
                                        else (None, None))
    assert session.generate(np.zeros((1, 4), np.int32), 2).shape == (1, 2)


def test_decode_session_times_each_signature_once(tmp_path, monkeypatch):
    from tony_tpu_torch.parallel import plan as plan_lib

    cfg = TransformerConfig(**TINY)
    monkeypatch.setattr(plan_lib, "_ACTIVE_CACHE_DIR", str(tmp_path))
    reg = observability.default_registry()
    misses = reg.counter("tony_compile_cache_misses_total")
    hits = reg.counter("tony_compile_cache_hits_total")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    m0, h0 = misses.value, hits.value
    session = DecodeSession(params, cfg, device="cpu")
    prompt = np.zeros((1, 4), np.int32)
    session.generate(prompt, 2)
    session.generate(prompt, 2)
    assert (misses.value, hits.value) == (m0 + 1, h0)
    DecodeSession(params, cfg, device="cpu").generate(prompt, 2)
    assert (misses.value, hits.value) == (m0 + 1, h0 + 1)
    session.generate(prompt, 3)
    assert misses.value == m0 + 2


FLASH_CASES = [
    # (b, t_q, t_k, h, h_kv, d, causal, block_q, block_k)
    (1, 200, 200, 2, 1, 64, True, 192, 192),
    (2, 130, 130, 2, 2, 64, False, 192, None),
    (1, 96, 160, 4, 2, 64, True, None, 192),
    (1, 150, 150, 2, 1, 128, True, None, 128),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_blocks_match_jax(case):
    """fp32: the same tile knob through both packages' public flash
    attention gives the same values and gradients, within 1e-5."""
    b, t_q, t_k, h, h_kv, d, causal, bq, bk = case
    rng = np.random.default_rng(sum(case[:6]))
    q, do = (rng.standard_normal((b, t_q, h, d), np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, t_k, h_kv, d), np.float32)
            for _ in range(2))

    def jax_loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, block_q=bq,
                                  block_k=bk)
        return jnp.sum(out * do), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                                    block_k=bk)
    (out * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)
    # The knob changes nothing but the plain loop's key blocks.
    plain = attention.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), plain.detach().numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kwargs,d", [
    ({"block_q": 128}, 64), ({"block_k": 256}, 64), ({"block_q": 192}, 128),
    ({"block_q": 128}, 128), ({"block_k": 192}, 128)], ids=str)
def test_unbuilt_tiles_raise(kwargs, d):
    """An explicit value no built instance has at the call's head_dim
    raises, pinned or not (at head_dim 128 B1 has 128 rows and B2 192, so
    no block_q names both)."""
    y = torch.zeros(1, 8, 1, d)
    with pytest.raises(ValueError, match="built"):
        attention.flash_attention(y, y, y, **kwargs)
    attention.set_tuned_blocks(192, 192)
    with pytest.raises(ValueError, match="built"):
        attention.flash_attention(y, y, y, **kwargs)


def test_pins_fill_defaults_where_built():
    attention.set_tuned_blocks(100, None)
    assert attention.tuned_blocks() == (100, None)
    assert attention._default_blocks(64, None, None) == (None, None)
    attention.set_tuned_blocks(192, 192)
    assert attention._default_blocks(64, None, None) == (192, 192)
    assert attention._default_blocks(64, 192, None) == (192, 192)
    # A pin no instance at head_dim 128 has is ignored there: a d 128 call
    # runs as unpinned and does not raise.
    assert attention._default_blocks(128, None, None) == (None, None)
    assert attention._default_blocks(128, None, 128) == (None, 128)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 24, 2, 128),
                                                    np.float32))
               for _ in range(3))
    pinned = attention.flash_attention(q, k, v)
    attention.clear_tuned_blocks()
    assert attention.tuned_blocks() == (None, None)
    assert attention._default_blocks(64, None, None) == (None, None)
    torch.testing.assert_close(pinned, attention.flash_attention(q, k, v),
                               atol=0, rtol=0)


def test_flash_block_candidates_are_the_built_instances():
    assert autotune.flash_block_candidates(64) == [
        autotune.Knobs(), autotune.Knobs(block_q=192, block_k=192)]
    assert autotune.flash_block_candidates(128) == [
        autotune.Knobs(), autotune.Knobs(block_k=128)]
    assert autotune.flash_block_candidates(32) == [autotune.Knobs()]


def test_flash_wall_measure_warms_every_point_first(monkeypatch):
    import tony_tpu_torch.ops as ops

    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, block_q=None, block_k=None, **kw):
        calls.append((block_q, block_k))
        return real(q, k, v, block_q=block_q, block_k=block_k, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    points = autotune.flash_block_candidates(64)
    measure = autotune.flash_wall_measure(32, 2, 64, heads=2, iters=2,
                                          windows=3, device="cpu",
                                          warm=points)
    assert measure(points[0]) > 0
    # Every point once, then the measured point's own warm call and its
    # windows.
    assert calls == [(None, None), (192, 192)] + [(None, None)] * 7
    calls.clear()
    assert measure(points[1]) > 0
    assert calls == [(192, 192)] * 7
    assert set(measure.spread) == set(points)
    assert all(x >= 0 for x in measure.spread.values())


@pytest.mark.parametrize("walls,margin,winner", [
    ([2.0, 1.9], 0.2, {}),
    ([2.0, 1.5], 0.2, {"block_q": 192}),
    ([2.0, 1.9], None, {"block_q": 192}),
], ids=["noise_keeps_default", "clear_win", "no_margin_as_jax"])
def test_search_margin_keeps_the_default_against_noise(tmp_path, walls,
                                                       margin, winner):
    measure, _ = _fake(walls)
    rec = autotune.search(
        "t", [autotune.Knobs(), autotune.Knobs(block_q=192)], measure,
        key="m" * 64, cache_dir=str(tmp_path),
        margin=None if margin is None else (lambda knobs: margin))
    assert autotune.knobs_from_dict(rec["best"]).describe() == winner
    assert rec["best_ms"] == (walls[1] if winner else walls[0])
    assert rec["default_ms"] == walls[0]
    assert [t["ms"] for t in rec["trials"]] == walls


def test_tune_flash_blocks_cold_then_warm(tmp_path):
    kw = dict(heads=2, kv_heads=1, iters=1, windows=1,
              cache_dir=str(tmp_path), device="cpu")
    cold = autotune.tune_flash_blocks(64, 2, 64, **kw)
    assert cold["trials_this_run"] == 2 and cold["best_ms"] is not None
    assert [t["knobs"] for t in cold["trials"]] == [
        k.describe() for k in autotune.flash_block_candidates(64)]
    assert not any("error" in t for t in cold["trials"])
    warm = autotune.tune_flash_blocks(64, 2, 64, **kw)
    assert warm["trials_this_run"] == 0 and warm["best"] == cold["best"]
    # The JAX package's shape (8 heads of q, k and v) keys as its does.
    assert autotune.tune_key("flash_attention_wall", extra={
        "seq": 64, "bh": 2, "d": 64}) != cold["key"]


def test_tune_train_step_cold_then_warm(tmp_path):
    cfg = TransformerConfig(**TINY)
    kw = dict(global_batch=2, seq=16, trial_budget=2,
              cache_dir=str(tmp_path), device="cpu")
    cold = autotune.tune_train_step(cfg, None, **kw)
    assert cold["trials_this_run"] == 2 and cold["best_ms"] is not None
    assert cold["default_ms"] >= cold["best_ms"]
    warm = autotune.tune_train_step(cfg, None, **kw)
    assert warm["trials_this_run"] == 0 and warm["best"] == cold["best"]
    assert autotune.lookup("lm_train_step", config=cfg,
                           cache_dir=str(tmp_path)) is not None


def test_deviations_pinned():
    """The port has no XLA: no apply_xla_flags (the record's xla_flags are
    kept for the format). Its schedules are gpipe and interleaved: no
    "1f1b" train candidate, and a trial that asks for one fails."""
    assert hasattr(jax_autotune, "apply_xla_flags")
    assert not hasattr(autotune, "apply_xla_flags")
    cfg = TransformerConfig(**TINY)
    got = [k.describe() for k in autotune.train_knob_candidates(
        cfg, microbatch_options=(None, 2))]
    want = [k.describe() for k in jax_autotune.train_knob_candidates(
        cfg, microbatch_options=(None, 2))]
    assert got == [k for k in want if k.get("pipeline_schedule") != "1f1b"]
    assert any(k.get("pipeline_schedule") == "1f1b" for k in want)
    with pytest.raises(ValueError, match="1f1b"):
        autotune.measure_train_step(
            cfg, None, autotune.Knobs(pipeline_schedule="1f1b"),
            global_batch=2, seq=16, device="cpu")
    public = {n for n in dir(jax_autotune) if not n.startswith("_")
              and callable(getattr(jax_autotune, n))
              and getattr(getattr(jax_autotune, n), "__module__", "")
              == jax_autotune.__name__}
    assert public - set(dir(autotune)) == {"apply_xla_flags"}
    assert autotune.KV_QUANT_MODES == jax_autotune.KV_QUANT_MODES
