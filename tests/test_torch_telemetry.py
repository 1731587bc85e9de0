"""The port's serving, checkpoint and input metrics held against the JAX
package's on the CPU.

* The engine: the same seeded prompts, submitted staggered between engine
  iterations (``step()`` driven by the test, so both engines see the same
  schedule), go through JAX's ``ServingEngine`` and the port's, each with a
  registry of its own. The ``tony_serving_*`` counters, histogram counts
  and final gauges are equal, the ``serving_decode_window`` /
  ``serving_prefill_chunks`` spans each default tracer took are equal in
  name and number (decimated past 64 the same way), and the greedy tokens
  are equal.
* The checkpoint manager: the same saves through both managers give the
  same ``tony_ckpt_*`` names, labels, observation counts, byte counters and
  committed step.
* The reader and ``device_prefetch``: the same corpus read through both
  gives the same ``tony_io_*`` names, observation counts and byte counters.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tony_tpu.checkpoint import CheckpointManager as JaxManager
from tony_tpu.io import ShardedRecordReader as JaxReader
from tony_tpu.io import device_prefetch as jax_device_prefetch
from tony_tpu.io import reader as jax_reader
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models import init_params as jax_init_params
from tony_tpu.observability import metrics as jax_metrics
from tony_tpu.observability import trace as jax_trace
from tony_tpu.serving import ServingEngine as JaxEngine
from tony_tpu.serving import scheduler as jax_scheduler
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.checkpoint import manager as port_manager
from tony_tpu_torch.interop import params_from_numpy
from tony_tpu_torch.io import ShardedRecordReader, device_prefetch
from tony_tpu_torch.io import reader as port_reader
from tony_tpu_torch.models import TransformerConfig
from tony_tpu_torch.observability import metrics as port_metrics
from tony_tpu_torch.observability import trace as port_trace
from tony_tpu_torch.serving import ServingEngine
from tony_tpu_torch.serving import scheduler as port_scheduler

torch.set_num_threads(1)

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=64, max_seq=96, dtype="float32", remat=False)
# (prompt length, token budget): the last request decodes past the
# tracer's 64 dense spans.
REQUESTS = ((3, 6), (7, 8), (12, 9), (20, 4), (5, 12), (11, 3), (4, 80))
SPANS = ("serving_decode_window", "serving_prefill_chunks")


def _only(snapshot: dict, prefix: str) -> dict:
    """The snapshot's metrics under ``prefix``: counters and gauges by
    value, histograms by observation count."""
    out = {}
    for kind in ("counters", "gauges"):
        out.update({k: v for k, v in snapshot[kind].items()
                    if k.startswith(prefix)})
    out.update({k: ("count", h["count"])
                for k, h in snapshot["histograms"].items()
                if k.startswith(prefix)})
    return out


def _span_counts(tracer) -> dict:
    names = [e["name"] for e in tracer.to_chrome_events()]
    return {n: names.count(n) for n in SPANS}


def _expected_spans(calls: int, dense: int = 64, every: int = 256) -> int:
    return sum(n < dense or n % every == 0 for n in range(calls))


def _drive(engine, prompts) -> list:
    """Submit three requests, run two iterations, and so on; then iterate
    to the end and drain."""
    reqs = []
    for i, (p, n) in enumerate(zip(prompts, (b for _, b in REQUESTS))):
        reqs.append(engine.submit(p, n))
        if i % 3 == 2:
            engine.step()
            engine.step()
    while not all(r.done() for r in reqs):
        engine.step()
    assert engine.drain(timeout=5)
    return [r.result(timeout=5) for r in reqs]


def test_engine_telemetry_matches_jax():
    jcfg, cfg = JaxConfig(**TINY), TransformerConfig(**TINY)
    jparams = jax_init_params(jax.random.key(0), jcfg)
    params = params_from_numpy(jax.device_get(jparams), cfg, "cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n, _ in REQUESTS]
    runs = {}
    for name, make, tracer in (
            ("jax", lambda reg: JaxEngine(jparams, jcfg, slots=3,
                                          prefill_chunk=5, registry=reg),
             jax_trace.default_tracer()),
            ("port", lambda reg: ServingEngine(params, cfg, device="cpu",
                                               slots=3, prefill_chunk=5,
                                               registry=reg),
             port_trace.default_tracer())):
        reg = (jax_metrics if name == "jax" else port_metrics) \
            .MetricsRegistry()
        engine = make(reg)
        before = _span_counts(tracer)
        results = _drive(engine, prompts)
        after = _span_counts(tracer)
        runs[name] = {
            "tokens": [r["tokens"] for r in results],
            "metrics": _only(reg.snapshot(), "tony_serving_"),
            "spans": {n: after[n] - before[n] for n in SPANS},
            "calls": (engine._decode_calls, engine._pf_draws),
            "stats": engine.stats(),
            "generated": engine.tokens_generated,
        }
    port, jx = runs["port"], runs["jax"]
    assert port["tokens"] == jx["tokens"]
    assert port["calls"] == jx["calls"]
    assert port["metrics"] == jx["metrics"]
    assert port["spans"] == jx["spans"]
    decode_calls, prefill_calls = port["calls"]
    assert decode_calls > 64  # the decimation is exercised
    assert port["spans"] == {
        "serving_decode_window": _expected_spans(decode_calls),
        "serving_prefill_chunks": _expected_spans(prefill_calls)}
    n_tokens = sum(len(t) for t in port["tokens"])
    assert port["metrics"] == {
        "tony_serving_requests_total": len(REQUESTS),
        "tony_serving_retired_total": len(REQUESTS),
        "tony_serving_generated_tokens_total": n_tokens,
        "tony_serving_queue_depth": 0.0,
        "tony_serving_active_slots": 0.0,
        "tony_serving_tokens_per_sec": 0.0,
        "tony_serving_ttft_ms": ("count", len(REQUESTS)),
        "tony_serving_inter_token_ms": ("count", decode_calls),
    }
    # stats() reads the engine's own tallies, never the registry.
    assert port["stats"]["requests"] == port["stats"]["retired"] == \
        len(REQUESTS)
    assert port["generated"] == n_tokens == jx["generated"]


def test_engines_on_one_registry_keep_their_own_tallies():
    cfg = TransformerConfig(**TINY)
    params = params_from_numpy(jax.device_get(jax_init_params(
        jax.random.key(0), JaxConfig(**TINY))), cfg, "cpu")
    reg = port_metrics.MetricsRegistry()
    engines = [ServingEngine(params, cfg, device="cpu", slots=2,
                             registry=reg) for _ in range(2)]
    for i, eng in enumerate(engines):
        reqs = [eng.submit([1, 2, 3], 2 + i) for _ in range(i + 1)]
        while not all(r.done() for r in reqs):
            eng.step()
        assert eng.stats()["requests"] == i + 1
    counters = reg.snapshot()["counters"]
    assert counters["tony_serving_requests_total"] == 3
    assert counters["tony_serving_generated_tokens_total"] == 2 + 2 * 3
    assert [e.tokens_generated for e in engines] == [2, 6]
    assert port_scheduler._MS_BUCKETS == jax_scheduler._MS_BUCKETS


@pytest.fixture()
def registries(monkeypatch):
    """Fresh default registries in both packages, and io handles bound to
    them."""
    regs = {"jax": jax_metrics.MetricsRegistry(),
            "port": port_metrics.MetricsRegistry()}
    monkeypatch.setattr(jax_metrics, "_default_registry", regs["jax"])
    monkeypatch.setattr(port_metrics, "_default_registry", regs["port"])
    monkeypatch.setattr(jax_reader._IoMetrics, "_instance", None)
    return regs


def _tree(step: int) -> dict:
    rng = np.random.default_rng(3)
    return {"a": rng.standard_normal((16, 8)).astype(np.float32),
            "b": np.full((32,), step, np.float32),
            "n": {"k": np.arange(5, dtype=np.int32)},
            "step": np.asarray(step, np.int32)}


def test_checkpoint_metrics_match_jax(registries, tmp_path):
    for name, cls in (("jax", JaxManager), ("port", CheckpointManager)):
        mgr = cls(tmp_path / name, max_to_keep=2)
        mgr.save(1, _tree(1))          # full
        mgr.save(2, _tree(2))          # differential: "a", "n" unchanged
        mgr.wait()
        mgr.save(3, _tree(3), blocking=True)
    snaps = {n: _only(r.snapshot(), "tony_ckpt_")
             for n, r in registries.items()}
    assert snaps["port"] == snaps["jax"]
    on_disk = {n: sum(p.stat().st_size for p in (tmp_path / n).rglob(
        "process_0.npz")) for n in registries}
    assert on_disk["port"] == on_disk["jax"]
    port = snaps["port"]
    assert port["tony_ckpt_snapshot_ms"] == ("count", 3)
    assert port["tony_ckpt_persist_ms"] == ("count", 3)
    assert port["tony_ckpt_committed_step"] == 3.0
    assert port["tony_ckpt_queue_depth"] == 0.0
    assert set(port) == {
        "tony_ckpt_snapshot_ms", "tony_ckpt_persist_ms",
        "tony_ckpt_queue_depth", "tony_ckpt_committed_step",
        'tony_ckpt_bytes_total{kind="full"}',
        'tony_ckpt_bytes_total{kind="diff"}'}
    assert port_manager._SNAPSHOT_BUCKETS == (1.0, 5.0, 10.0, 50.0, 100.0,
                                              500.0, 1000.0, 5000.0,
                                              10000.0)


def test_checkpoint_metrics_tolerate_a_foreign_registry(monkeypatch,
                                                        tmp_path):
    reg = port_metrics.MetricsRegistry()
    reg.counter("tony_ckpt_snapshot_ms_total")  # unrelated, fine
    reg.gauge("tony_ckpt_persist_ms")  # squats a histogram's name
    monkeypatch.setattr(port_metrics, "_default_registry", reg)
    CheckpointManager(tmp_path).save(1, _tree(1), blocking=True)
    assert CheckpointManager(tmp_path).latest_step() == 1
    assert reg.snapshot()["histograms"]["tony_ckpt_snapshot_ms"]["count"] == 1


def _corpus(tmp_path, n: int = 61, rl: int = 9) -> list[str]:
    rng = np.random.default_rng(0)
    path = tmp_path / "c.tokens"
    rng.integers(0, 60000, (n, rl)).astype(np.uint16).tofile(path)
    return [str(path)]


def test_reader_and_prefetch_metrics_match_jax(registries, tmp_path):
    paths = _corpus(tmp_path)
    kw = dict(fmt="tokens", dtype=np.uint16, record_len=9, batch_size=4,
              chunk_records=3, read_workers=1)
    got = {}
    for name, cls, prefetch in (
            ("jax", JaxReader, lambda b: jax_device_prefetch(b, depth=2)),
            ("port", ShardedRecordReader,
             lambda b: device_prefetch(b, "cpu", depth=2))):
        with cls(paths, **kw) as reader:
            batches = list(reader)
        with prefetch(iter(batches)) as it:
            moved = [np.asarray(b) for b in it]
        got[name] = [b.tolist() for b in moved]
    assert got["port"] == got["jax"]
    snaps = {n: _only(r.snapshot(), "tony_io_")
             for n, r in registries.items()}
    for snap in snaps.values():
        snap.pop("tony_io_prefetch_queue_depth")  # a racy qsize() reading
    assert snaps["port"] == snaps["jax"]
    n_batches = len(got["port"])
    assert snaps["port"]["tony_io_bytes_read_total"] == 61 * 9 * 2
    assert snaps["port"]["tony_io_h2d_bytes_total"] == 61 * 9 * 2
    assert snaps["port"]["tony_io_h2d_ms"] == ("count", n_batches)
    assert snaps["port"]["tony_io_queue_wait_ms"] == ("count", n_batches)
    assert snaps["port"]["tony_io_h2d_inflight_depth"] == 0.0
    assert set(snaps["port"]) | {"tony_io_prefetch_queue_depth"} == {
        getattr(port_reader, n) for n in dir(port_reader)
        if n.startswith("IO_") and n.endswith(("_COUNTER", "_HISTOGRAM",
                                               "_GAUGE"))}


def test_io_handles_follow_a_replaced_default_registry(monkeypatch,
                                                       tmp_path):
    first = port_metrics.MetricsRegistry()
    monkeypatch.setattr(port_metrics, "_default_registry", first)
    paths = _corpus(tmp_path, n=8)
    kw = dict(fmt="tokens", dtype=np.uint16, record_len=9, batch_size=4)
    with ShardedRecordReader(paths, **kw) as r:
        list(r)
    second = port_metrics.MetricsRegistry()
    monkeypatch.setattr(port_metrics, "_default_registry", second)
    with ShardedRecordReader(paths, **kw) as r:
        list(r)
    for reg in (first, second):
        assert reg.snapshot()["counters"]["tony_io_bytes_read_total"] == \
            8 * 9 * 2


def test_inflight_depth_survives_racing_threads():
    """The producer and the consumer move the in-flight count from two
    threads: no update is lost."""
    import sys
    import threading

    reg = port_metrics.MetricsRegistry()
    depth = port_reader._Inflight(reg.gauge("tony_io_h2d_inflight_depth"))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def churn(sign):
        for _ in range(2000):
            depth.add(sign)

    try:
        threads = [threading.Thread(target=churn, args=(s,))
                   for s in (1, -1) * 6]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert depth._n == 0
    assert reg.snapshot()["gauges"]["tony_io_h2d_inflight_depth"] == 0.0
