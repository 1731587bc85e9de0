"""The port's measurement plane held against the JAX package on the CPU.

* The step anatomy: each scenario of the JAX package's ``TestStepStats``
  (tests/test_observability.py) driven through both packages' ``StepStats``
  with the same fake clock gives equal gauges.
* ``model_flops_per_step`` equals JAX's less the embedding gather, which
  JAX counts as a second ``vocab x d_model`` matmul (ROADMAP Queue C), and
  ``estimate_phases`` equals JAX's, over a set of meshes and plans. So do
  the ``tony_model_flops_per_step`` and ``tony_mfu`` gauges.
* The port's registry snapshot, published to its file, loads in the
  orchestrator's aggregator and renders on ``/metrics``.
* The peak table, the live calibration (the measurement table's entries
  and ``tony_plan_residual`` equal to JAX's ``StepStats`` fed the same
  walls, the tune record's ``live_best_ms``), the global-batch
  sizing of ``make_train_step``'s anatomy on two gloo ranks, and
  ``make_train_step(plan=)`` against the mesh-and-kwargs form.
* The port's train CLI under ``MiniTonyCluster`` puts the anatomy and a
  non-zero ``tony_mfu`` on the coordinator's live ``/metrics``.
"""

from __future__ import annotations

import datetime
import json
import re
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tony_tpu import constants as jax_constants
from tony_tpu.conf import keys
from tony_tpu.coordinator.app_master import TonyCoordinator
from tony_tpu.coordinator.backend import LocalProcessBackend
from tony_tpu.coordinator.session import SessionStatus
from tony_tpu.mini import MiniTonyCluster
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.observability import metrics as jax_metrics
from tony_tpu.observability import stepstats as jax_stepstats
from tony_tpu.observability.aggregator import MetricsAggregator
from tony_tpu.parallel import plan as jax_plan
from tony_tpu_torch.models import TransformerConfig, make_train_step
from tony_tpu_torch.observability import metrics as port_metrics
from tony_tpu_torch.observability import stepstats as port_stepstats
from tony_tpu_torch.parallel import MeshSpec, build_mesh
from tony_tpu_torch.parallel import plan as port_plan
from torch_ranks import GROUP_TIMEOUT_S, TINY, launch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


class _TinyCfg:
    """Transformer-shaped config for the analytic flops model (the JAX
    package's test's)."""
    d_model = 64
    n_layers = 2
    vocab_size = 512
    n_heads = 4
    head_dim = 16
    n_kv_heads = 2
    d_ff = 256
    dtype = "float32"


def _embedding_flops(cfg, batch: int, seq: int) -> float:
    """What JAX's ``model_flops_per_step`` counts and the port's does not:
    the embedding gather as a matmul, 6 x vocab x d_model a token."""
    return 6.0 * cfg.vocab_size * cfg.d_model * batch * seq


def _as_the_port_counts(snap: dict, jstats, cfg) -> float:
    """JAX's snapshot with the model flops and MFU the port publishes for
    the same steps (its flops less the embedding's); returns the MFU's
    factor."""
    if not jstats._flops:
        return 1.0
    flops = jstats._flops - _embedding_flops(cfg, jstats.global_batch,
                                             jstats.seq)
    gauges = snap["gauges"]
    if "tony_model_flops_per_step" in gauges:
        gauges["tony_model_flops_per_step"] = flops
    if "tony_mfu" in gauges:
        gauges["tony_mfu"] = round(jstats.mfu * flops / jstats._flops, 5)
    return flops / jstats._flops


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


# Each scenario drives a StepStats of one package (``mod``) with a fake
# clock, as the JAX package's TestStepStats case of the same name does.

def _phases_sum_to_wall(stats, clock):
    stats.step_begin((4, 33))       # dispatch 1: one-off costs
    clock.advance(5.0)
    stats.step_begin((4, 33))       # dropped, never published
    stats.step_end(0.002)
    clock.advance(0.1)              # one 100 ms step
    stats.step_begin((4, 33))


def _wrap_batches(stats, clock):
    def slow_batches():
        while True:
            clock.advance(0.03)     # 30 ms blocked in next()
            yield (4, 33)

    it = stats.wrap_batches(slow_batches())
    stats.step_begin(next(it))
    stats.step_end(0.0)
    shape = next(it)
    clock.advance(0.07)
    stats.step_begin(shape)
    shape = next(it)
    clock.advance(0.07)
    stats.step_begin(shape)


def _disabled(stats, clock):
    batches = iter([(4, 33)])
    assert stats.wrap_batches(batches) is batches
    stats.step_begin((4, 33))
    clock.advance(0.1)
    stats.step_begin((4, 33))


def _classifier(stats, clock):
    stats.step_begin((8, 28, 28, 1))
    clock.advance(0.2)              # first call: dropped
    stats.step_begin((8, 28, 28, 1))
    clock.advance(0.2)              # 200 ms call = 2 steps
    stats.step_begin((8, 28, 28, 1))


def _deferred_sizing(stats, clock):
    stats.step_begin((4, 33))       # hook: this rank's [4, 33]
    stats.set_workload(8, 32)       # make_train_step: the global batch is 8
    clock.advance(0.1)
    stats.step_begin((4, 33))
    clock.advance(0.1)
    stats.step_begin((4, 33))


def _collectives(stats, clock):
    stats.step_begin((8, 33))
    clock.advance(1.0)
    stats.step_begin((8, 33))
    stats.step_end(0.004)
    for _ in range(3):
        clock.advance(0.25)
        stats.step_begin((8, 33))


SCENARIOS = {
    "phases_sum_to_wall": (_phases_sum_to_wall, {}),
    "wrap_batches": (_wrap_batches, {}),
    "disabled": (_disabled, {"enabled": False}),
    "classifier": (_classifier, {"cfg": None, "tokens_workload": False,
                                 "steps_per_call": 2}),
    "deferred_sizing": (_deferred_sizing, {"size_from_shapes": False}),
    # A plan over dp x tp: the residual splits into compute and
    # collective, and the per-axis byte counters advance.
    "collectives": (_collectives, {"plan": "dp2.tp2"}),
}


def _run(package: str, name: str) -> tuple[dict, object]:
    scenario, kw = SCENARIOS[name]
    kw = dict(kw)
    stats_mod, metrics_mod, plan_mod = (
        (jax_stepstats, jax_metrics, jax_plan) if package == "jax" else
        (port_stepstats, port_metrics, port_plan))
    if kw.get("plan") == "dp2.tp2":
        kw["plan"] = plan_mod.Plan(plan_mod.MeshSpec(dp=2, tp=2))
    kw.setdefault("cfg", _TinyCfg())
    reg = metrics_mod.MetricsRegistry()
    clock = _Clock()
    stats = stats_mod.StepStats(registry=reg, clock=clock, peak_flops=1e12,
                                calibrate=False,
                                **{"enabled": True, **kw})
    scenario(stats, clock)
    snap = reg.snapshot()
    return {k: snap[k] for k in ("gauges", "counters", "histograms")}, stats


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_stepstats_scenario_gives_jax_s_gauges(name):
    """Exactly equal gauges, counters and histograms, and the same
    observed step count; the model flops are JAX's less the embedding's,
    and the MFU is taken from them."""
    want, jstats = _run("jax", name)
    got, tstats = _run("torch", name)
    factor = _as_the_port_counts(want, jstats, _TinyCfg())
    assert got == want
    assert tstats.steps_observed == jstats.steps_observed
    if jstats.mfu is None:
        assert tstats.mfu is None
    else:
        assert tstats.mfu == pytest.approx(jstats.mfu * factor, rel=1e-12)
    if name == "phases_sum_to_wall":
        phases = [got["gauges"][f'tony_step_phase_ms{{phase="{p}"}}']
                  for p in port_stepstats.PHASES]
        assert sum(phases) == pytest.approx(100.0, rel=1e-6)
        assert got["gauges"]["tony_mfu"] > 0
    if name == "classifier":
        assert "tony_mfu" not in got["gauges"]
        assert got["gauges"]['tony_step_phase_ms{phase="compute"}'] == \
            pytest.approx(100.0)
    if name == "collectives":
        assert got["gauges"]['tony_step_phase_ms{phase="collective"}'] > 0
        assert set(got["counters"]) >= {
            'tony_collective_bytes_total{axis="dp"}',
            'tony_collective_bytes_total{axis="tp"}'}


_CONFIGS = {
    "dense": dict(vocab_size=512, d_model=64, n_layers=4, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=256, max_seq=128,
                  dtype="bfloat16"),
    "moe": dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=4, head_dim=16, d_ff=128, max_seq=64,
                n_experts=4, expert_top_k=2, dtype="float32"),
}


@pytest.mark.parametrize("axes,microbatches", [
    ({}, None), ({"dp": 8}, None), ({"tp": 4}, None),
    ({"dp": 2, "sp": 2, "tp": 2}, None), ({"ep": 2, "dp": 2}, None),
    ({"pp": 2}, 4), ({"pp": 4, "dp": 2}, 8), ({"pp": 2}, None)])
@pytest.mark.parametrize("cfg_name", sorted(_CONFIGS))
def test_cost_model_matches_jax(axes, microbatches, cfg_name):
    """``model_flops_per_step`` equals JAX's less the embedding gather's
    6 x vocab x d_model a token; ``estimate_phases`` (compute, collective,
    bytes per axis) equals JAX's, and so do the plan's key and
    description; ``plan_from_mesh`` reads the mesh's axis sizes."""
    jcfg, tcfg = (JaxConfig(**_CONFIGS[cfg_name]),
                  TransformerConfig(**_CONFIGS[cfg_name]))
    for batch, seq in ((8, 128), (3, 17)):
        assert port_stepstats.model_flops_per_step(tcfg, batch, seq) == \
            jax_stepstats.model_flops_per_step(jcfg, batch, seq) \
            - _embedding_flops(tcfg, batch, seq)
        for sched, virt in (("gpipe", 1), ("interleaved", 2)):
            jp = jax_plan.Plan(jax_plan.MeshSpec(**axes),
                               microbatches=microbatches,
                               pipeline_schedule=sched,
                               pipeline_virtual=virt)
            tp = port_plan.Plan(MeshSpec(**axes), microbatches=microbatches,
                                pipeline_schedule=sched,
                                pipeline_virtual=virt)
            assert tp.key() == jp.key() and tp.describe() == jp.describe()
            assert tp.train_step_kwargs() == jp.train_step_kwargs()
            assert port_plan.estimate_phases(
                tp, tcfg, global_batch=batch, seq=seq) == \
                jax_plan.estimate_phases(jp, jcfg, global_batch=batch,
                                         seq=seq)
    assert port_stepstats.model_flops_per_step(object(), 8, 128) is None

    class _Mesh:  # what plan_from_mesh reads of a DeviceMesh
        def size(self, i):
            return MeshSpec(**axes).shape[i]

    assert port_plan.plan_from_mesh(_Mesh(), microbatches=microbatches) == \
        port_plan.Plan(MeshSpec(**axes), microbatches=microbatches)


def test_snapshot_file_loads_in_the_orchestrator(tmp_path, monkeypatch):
    """The port's default registry publishes to $TONY_METRICS_FILE; the
    executor's reader loads the file, the aggregator ingests it, serves the
    step anatomy on /api/stepstats and renders it on /metrics. The same
    calls on the JAX package's registry give the same snapshot but for
    its timestamp and the model flops and MFU, which are JAX's less the
    embedding's."""
    path = tmp_path / "metrics.json"
    monkeypatch.setenv(jax_constants.TONY_METRICS_FILE, str(path))
    monkeypatch.setattr(port_metrics, "_default_registry", None)
    reg = port_metrics.default_registry()
    clock = _Clock()
    jreg = jax_metrics.MetricsRegistry()
    for registry, mod in ((reg, port_stepstats), (jreg, jax_stepstats)):
        stats = mod.StepStats(registry=registry, clock=clock,
                              cfg=_TinyCfg(), peak_flops=1e12,
                              calibrate=False, enabled=True)
        _phases_sum_to_wall(stats, clock)
        jstats = stats
        registry.report(step=3, loss=2.5)
        registry.counter("train_step_dispatches_total").inc(3)
        registry.histogram("train_step_dispatch_seconds").observe(0.002)
    reg.flush()
    snap = jax_metrics.load_snapshot_file(path)
    want = json.loads(json.dumps(jreg.snapshot()))
    _as_the_port_counts(want, jstats, _TinyCfg())
    assert {k: v for k, v in snap.items() if k != "ts_ms"} == \
        {k: v for k, v in want.items() if k != "ts_ms"}
    agg = MetricsAggregator()
    agg.ingest("worker:0", snap)
    view = agg.stepstats_json()["tasks"]["worker:0"]
    assert set(view["phases"]) == set(jax_stepstats.PHASES)
    assert view["mfu"] > 0
    text = jax_metrics.render_prometheus(snap, labels={"task": "worker:0"})
    assert 'tony_step_phase_ms{phase="host",task="worker:0"}' in text
    assert re.search(r"^tony_mfu\{task=\"worker:0\"\} [0-9.e-]+$", text,
                     re.M)
    monkeypatch.setattr(port_metrics, "_default_registry", None)


def test_peak_table(monkeypatch):
    """cpu is 1e11 (nominal); the H100 SXM and PCIe parts their dense
    bf16 peaks; any other name 0, and then no tony_mfu."""
    assert port_stepstats.peak_flops_per_chip(torch.device("cpu")) == 1e11
    assert port_stepstats.peak_flops_per_chip("cpu") == 1e11
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA H100 PCIe", 756e12),
                       ("NVIDIA A100-SXM4-80GB", 0.0)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, name=name: name)
        assert port_stepstats.peak_flops_per_chip(
            torch.device("cuda", 0)) == peak
    reg = port_metrics.MetricsRegistry()
    clock = _Clock()
    stats = port_stepstats.StepStats(registry=reg, clock=clock,
                                     cfg=_TinyCfg(), enabled=True,
                                     device=torch.device("cuda", 0))
    _phases_sum_to_wall(stats, clock)
    gauges = reg.snapshot()["gauges"]
    assert 'tony_step_phase_ms{phase="compute"}' in gauges
    assert "tony_model_flops_per_step" in gauges
    assert "tony_mfu" not in gauges and stats.mfu is None
    # Without a device or a peak there is no MFU either.
    reg = port_metrics.MetricsRegistry()
    stats = port_stepstats.StepStats(registry=reg, clock=clock,
                                     cfg=_TinyCfg(), enabled=True)
    _phases_sum_to_wall(stats, clock)
    assert "tony_mfu" not in reg.snapshot()["gauges"]


# Fake step walls (seconds) fed to both packages' calibration: falling,
# steady, and noisy with late improvements; each with its window.
_CAL_WALLS = {
    "falling": ([0.1, 0.09, 0.095, 0.05, 0.06, 0.049, 0.048], 2),
    "steady": ([0.05] * 8, 32),
    "late_best": ([0.08, 0.07, 0.09, 0.07, 0.03, 0.031, 0.029, 0.02], 3),
}


def _calibrate(package: str, cache_dir, monkeypatch, walls, window, plan,
               cfg_name="dense"):
    """One package's StepStats(calibrate=True) fed ``walls`` through a fake
    clock, each dispatch's step_begin followed by its step_end as
    make_train_step's hook drives them, its plan measurement table and tune
    records under ``cache_dir``; returns (the table, the tony_plan_residual
    gauges, the stats)."""
    stats_mod, metrics_mod, plan_mod, cfg_cls = (
        (jax_stepstats, jax_metrics, jax_plan, JaxConfig) if package == "jax"
        else (port_stepstats, port_metrics, port_plan, TransformerConfig))
    if package == "jax":
        monkeypatch.setattr(jax_plan, "active_cache_dir",
                            lambda: str(cache_dir))
    else:
        monkeypatch.setattr(port_plan, "_ACTIVE_CACHE_DIR", str(cache_dir))
    reg = metrics_mod.MetricsRegistry()
    clock = _Clock()
    stats = stats_mod.StepStats(
        cfg=cfg_cls(**_CONFIGS[cfg_name]),
        plan=plan_mod.Plan(plan_mod.MeshSpec(**plan)), registry=reg,
        clock=clock, peak_flops=1e12, calibrate=True, enabled=True,
        window=window)
    stats.step_begin((4, 17))
    stats.step_end(0.0)
    clock.advance(1.0)
    for wall in walls:
        stats.step_begin((4, 17))
        stats.step_end(0.0)
        clock.advance(wall)
    stats.step_begin((4, 17))
    stats.step_end(0.0)
    gauges = {k: v for k, v in reg.snapshot()["gauges"].items()
              if k.startswith(port_stepstats.PLAN_RESIDUAL_GAUGE)}
    return plan_mod.load_measurements(cache_dir=str(cache_dir)), gauges, stats


@pytest.mark.parametrize("plan", [{}, {"dp": 2, "tp": 2}],
                         ids=["one_device", "dp2_tp2"])
@pytest.mark.parametrize("walls", sorted(_CAL_WALLS))
def test_calibration_writes_the_table_and_residual_as_jax_does(
        tmp_path, monkeypatch, walls, plan):
    """StepStats(calibrate=True) fed the same walls in both packages, over
    a table both were seeded with (another plan's measurement): the same
    measurement-table entries and the same tony_plan_residual{plan=}."""
    seeded_cfg = JaxConfig(**_CONFIGS["dense"])
    out = {}
    for package in ("jax", "port"):
        d = tmp_path / package
        d.mkdir()
        n = jax_plan.Plan(jax_plan.MeshSpec(**plan)).num_devices
        other = jax_plan.candidate_plans(seeded_cfg, n, global_batch=4,
                                         seq=16)[-1]
        if other.key() != jax_plan.Plan(jax_plan.MeshSpec(**plan)).key():
            jax_plan.record_step_time(other, seeded_cfg, 40.0,
                                      global_batch=4, seq=16,
                                      cache_dir=str(d))
        out[package] = _calibrate(package, d, monkeypatch,
                                  *_CAL_WALLS[walls], plan)
    (table, gauges, stats), (jtable, jgauges, jstats) = (out["port"],
                                                         out["jax"])
    assert table == jtable and table
    assert gauges == jgauges and len(gauges) == 1
    assert stats._recorded_ms == pytest.approx(jstats._recorded_ms)
    key = port_plan.Plan(port_plan.MeshSpec(**plan)).key()
    (bucket, row), = [(b, r) for b, r in table.items() if key in r]
    assert row[key] == round(stats._recorded_ms, 3)
    assert bucket == port_plan._model_bucket(
        TransformerConfig(**_CONFIGS["dense"]), stats._num_devices, 4, 16)


def test_calibration_feeds_the_tune_record_live_best(tmp_path, monkeypatch):
    """With a tune record for (cfg, no mesh), calibration folds the best
    wall into its live_best_ms, as JAX's does into its own record."""
    from tony_tpu.parallel import autotune as jax_autotune
    from tony_tpu_torch.parallel import autotune as port_autotune

    got = {}
    for package, mod, cfg_cls in (("jax", jax_autotune, JaxConfig),
                                  ("port", port_autotune, TransformerConfig)):
        d = tmp_path / package
        key = mod.tune_key("lm_train_step",
                           config=cfg_cls(**_CONFIGS["dense"]))
        mod.save_record({"version": 1, "key": key, "label": "lm_train_step",
                         "best": {}, "best_ms": 99.0, "trials": []},
                        cache_dir=str(d))
        _calibrate(package, d, monkeypatch, *_CAL_WALLS["falling"], {})
        got[package] = mod.load_record(key, cache_dir=str(d))["live_best_ms"]
    assert got["port"] == got["jax"] == 48.0


def test_calibration_off_or_unwritable_writes_nothing(tmp_path, monkeypatch):
    """calibrate=False, or no config, leaves no table and no residual; an
    unwritable cache dir costs the step nothing (telemetry)."""
    blocked = tmp_path / "file"
    blocked.write_text("")
    for kw, d in (({"calibrate": False}, tmp_path),
                  ({"cfg": None}, tmp_path), ({}, blocked)):
        monkeypatch.setattr(port_plan, "_ACTIVE_CACHE_DIR", str(d))
        reg = port_metrics.MetricsRegistry()
        clock = _Clock()
        stats = port_stepstats.StepStats(**{
            "cfg": TransformerConfig(**_CONFIGS["dense"]),
            "plan": port_plan.Plan(MeshSpec()), "registry": reg,
            "clock": clock, "peak_flops": 1e12, "calibrate": True,
            "enabled": True, **kw})
        for _ in range(7):
            stats.step_begin((4, 17))
            stats.step_end(0.0)
            clock.advance(0.05)
        assert stats.steps_observed == 5
        assert not [k for k in reg.snapshot()["gauges"]
                    if k.startswith(port_stepstats.PLAN_RESIDUAL_GAUGE)]
        assert port_plan.load_measurements(cache_dir=str(tmp_path)) == {}


def test_calibration_writes_at_step_end_not_step_begin(tmp_path, monkeypatch):
    """The record that an observation makes due is written by the step_end
    of the dispatch that observed it, after the step's work is queued:
    step_begin alone leaves the table empty, its step_end fills it."""
    monkeypatch.setattr(port_plan, "_ACTIVE_CACHE_DIR", str(tmp_path))
    reg = port_metrics.MetricsRegistry()
    clock = _Clock()
    stats = port_stepstats.StepStats(
        cfg=TransformerConfig(**_CONFIGS["dense"]),
        plan=port_plan.Plan(MeshSpec()), registry=reg, clock=clock,
        peak_flops=1e12, calibrate=True, enabled=True)
    for _ in range(4):
        stats.step_begin((4, 17))
        stats.step_end(0.0)
        clock.advance(0.05)
    stats.step_begin((4, 17))      # the third observation: a record is due
    assert stats.steps_observed == 3
    assert port_plan.load_measurements(cache_dir=str(tmp_path)) == {}
    assert stats._recorded_ms is None
    stats.step_end(0.0)
    assert stats._recorded_ms == pytest.approx(50.0)
    table = port_plan.load_measurements(cache_dir=str(tmp_path))
    assert [r for row in table.values() for r in row.values()] == [50.0]


def test_make_train_step_without_a_mesh_calibrates_one_device(
        tmp_path, monkeypatch):
    """The step without a mesh records under the one-device plan
    (dp1.pp1.ep1.sp1.tp1) and publishes its residual."""
    monkeypatch.setattr(port_plan, "_ACTIVE_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(port_metrics, "_default_registry",
                        port_metrics.MetricsRegistry())
    cfg = TransformerConfig(**TINY)
    init_fn, step_fn = make_train_step(cfg, device="cpu")
    state = init_fn(0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17))
    for _ in range(6):
        state, metrics = step_fn(state, tokens)
        float(metrics["loss"])
    key = "dp1.pp1.ep1.sp1.tp1"
    table = port_plan.load_measurements(cache_dir=str(tmp_path))
    assert [key] == [k for row in table.values() for k in row]
    gauges = port_metrics.default_registry().snapshot()["gauges"]
    assert gauges[f'tony_plan_residual{{plan="{key}"}}'] == 1.0


def test_train_step_anatomy_is_sized_by_the_global_batch(tmp_path):
    """Two gloo ranks over dp 2, each fed [2, 17]: the anatomy sizes the
    flops model with the global batch 4 x 16, its plan is dp2, and each
    rank publishes the five phases, the model flops of the global batch
    and an MFU against the CPU's nominal peak (1e11 flops/s, 2 devices),
    and the dispatch counter."""
    results = launch("lm_stepstats", tmp_path)
    flops = jax_stepstats.model_flops_per_step(JaxConfig(**TINY), 4, 16) \
        - _embedding_flops(TransformerConfig(**TINY), 4, 16)
    for r in results:
        assert (r["global_batch"], r["seq"]) == (4, 16)
        assert r["plan"] == "dp2.pp1.ep1.sp1.tp1"
        assert r["steps_observed"] == 2
        g = r["gauges"]
        assert {f'tony_step_phase_ms{{phase="{p}"}}'
                for p in port_stepstats.PHASES} <= set(g)
        assert g["tony_model_flops_per_step"] == flops
        wall = g["step_time_ms"]
        assert sum(g[f'tony_step_phase_ms{{phase="{p}"}}']
                   for p in port_stepstats.PHASES) == pytest.approx(
                       wall, abs=5e-3)
        # The gauge keeps 5 decimals, the wall 3.
        assert g["tony_mfu"] == pytest.approx(
            flops / (wall / 1e3 * 2 * 1e11), rel=1e-3, abs=1e-5)
        assert g['tony_step_phase_ms{phase="collective"}'] > 0
        assert r["counters"]["train_step_dispatches_total"] == 4
        assert r["counters"]['tony_collective_bytes_total{axis="dp"}'] > 0


def test_plan_gives_the_mesh_and_kwargs_form(tmp_path, monkeypatch):
    """On a one-rank gloo group: make_train_step(cfg, plan=Plan(pp=1,
    microbatches 2)) builds its mesh from the plan and takes its pipeline
    kwargs, and trains bit-equal to make_train_step(cfg, mesh,
    pipeline_microbatches=2); explicit kwargs win over the plan's; a plan
    of two slices is refused. The plan's mesh gets the tests' 60 s group
    timeout."""
    build = port_plan.Plan.build_mesh
    monkeypatch.setattr(
        port_plan.Plan, "build_mesh",
        lambda self, device="cuda", **kw: build(
            self, device, timeout_s=GROUP_TIMEOUT_S, **kw))
    cfg = TransformerConfig(**TINY)
    tokens = [np.random.default_rng(i).integers(0, 64, (2, 17))
              for i in range(2)]
    store = dist.HashStore()
    dist.init_process_group(
        "gloo", store=store, rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        plan = port_plan.Plan(MeshSpec(), microbatches=2)
        runs = []
        for form in ("plan", "mesh"):
            if form == "plan":
                init_fn, step_fn = make_train_step(cfg, device="cpu",
                                                   plan=plan)
            else:
                mesh = build_mesh(MeshSpec(), "cpu",
                                  timeout_s=GROUP_TIMEOUT_S)
                init_fn, step_fn = make_train_step(
                    cfg, mesh, device="cpu", pipeline_microbatches=2)
            state = init_fn(0)
            losses = []
            for t in tokens:
                state, m = step_fn(state, t)
                losses.append(float(m["loss"]))
            runs.append((losses, [p.detach().clone() for p in
                                  state.opt_state.param_groups[0]["params"]]))
        assert runs[0][0] == runs[1][0]
        for a, b in zip(runs[0][1], runs[1][1]):
            assert torch.equal(a, b)
        assert step_fn.stepstats.plan.key() == "dp1.pp1.ep1.sp1.tp1.mb2"
        # Explicit kwargs win: 3 microbatches (which do not divide the
        # 2 rows) replace the plan's 2, and the step refuses them.
        _, step_fn = make_train_step(cfg, device="cpu", plan=plan,
                                     pipeline_microbatches=3)
        with pytest.raises(ValueError, match="3"):
            step_fn(init_fn(0), tokens[0])
        with pytest.raises(ValueError, match="slices"):
            make_train_step(cfg, device="cpu",
                            plan=port_plan.Plan(MeshSpec(dp=2),
                                                num_slices=2))
    finally:
        dist.destroy_process_group()


def test_train_cli_puts_anatomy_on_live_metrics(tmp_path, monkeypatch):
    """The port's train CLI (one --framework pytorch worker, --device cpu)
    under the mini-cluster, as the JAX package's
    test_mini_cluster_stepstats_training_e2e runs examples/lm_train.py:
    tony_step_phase_ms{phase=} and a non-zero tony_mfu on the
    coordinator's live /metrics, the persisted snapshot's phases summing
    to its step_time_ms within 5 %, and its calibration's entry in the
    plan-measurements table of the job's compile cache (tony.compile.
    cache-dir), under the one-device plan. The job runs one intra-op
    thread, as
    the rank groups do: beside other test workers the default count
    oversubscribes the cores by an order of magnitude."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cache_dir = tmp_path / "compile-cache"
    cluster = MiniTonyCluster(tmp_path)
    conf = cluster.base_conf()
    conf.set(keys.K_EXECUTES, str(REPO / "tony_tpu_torch" / "train.py"))
    conf.set(keys.K_FRAMEWORK, "pytorch")
    conf.set(keys.K_PYTHON_BINARY, sys.executable)
    conf.set(keys.instances_key("worker"), 1)
    conf.set(keys.instances_key("ps"), 0)
    conf.set(keys.K_TASK_HEARTBEAT_INTERVAL_MS, 150)
    conf.set(keys.K_COMPILE_CACHE_DIR, str(cache_dir))
    conf.set(keys.K_TASK_PARAMS,
             f"--device cpu --steps 200 --d-model 32 --n-layers 2 "
             f"--n-heads 2 --n-kv-heads 1 --vocab 128 --batch 4 --seq 64 "
             f"--checkpoint-every 100000 --ckpt-dir {tmp_path / 'ck'}")
    app_id = "application_mini_torch_anatomy1"
    app_dir = cluster.staging_dir / app_id
    app_dir.mkdir(parents=True)
    conf.write_final(app_dir / jax_constants.TONY_FINAL_CONF)
    coordinator = TonyCoordinator(
        conf, app_dir, app_id=app_id,
        backend=LocalProcessBackend(app_dir / "logs"))
    result = []
    thread = threading.Thread(
        target=lambda: result.append(coordinator.run()), daemon=True)
    cluster._live.append(coordinator)
    thread.start()
    live_mfu, live_phases = None, False
    try:
        deadline = time.monotonic() + 120
        addr_file = app_dir / "coordinator.http"
        while not addr_file.is_file() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert addr_file.is_file(), "coordinator.http never advertised"
        addr = addr_file.read_text().strip()
        while time.monotonic() < deadline and thread.is_alive():
            try:
                text = urllib.request.urlopen(
                    f"http://{addr}/metrics", timeout=5).read().decode()
            except OSError:
                time.sleep(0.05)
                continue
            live_phases = live_phases or "tony_step_phase_ms" in text
            m = re.search(r"tony_mfu\{[^}]*\} ([0-9.eE+-]+)", text)
            if m:
                live_mfu = float(m.group(1))
                if live_mfu > 0 and live_phases:
                    break
            time.sleep(0.05)
    finally:
        thread.join(timeout=150)
        cluster.shutdown()
    assert not thread.is_alive()
    assert result and result[0] is SessionStatus.SUCCEEDED, (
        coordinator.session.diagnostics if coordinator.session else "no run")
    assert live_phases, "tony_step_phase_ms never appeared on live /metrics"
    assert live_mfu is not None and live_mfu > 0, live_mfu
    final = json.loads((app_dir / "final-status.json").read_text())
    entry = jax_stepstats.task_stepstats(final["metrics"]["tasks"]["worker:0"])
    assert entry is not None and set(entry["phases"]) == set(
        jax_stepstats.PHASES)
    gauges = final["metrics"]["tasks"]["worker:0"]["gauges"]
    assert sum(entry["phases"].values()) == pytest.approx(
        gauges["step_time_ms"], rel=0.05)
    assert gauges["tony_mfu"] > 0
    table = jax_plan.load_measurements(cache_dir=str(cache_dir))
    assert [k for row in table.values() for k in row] == [
        "dp1.pp1.ep1.sp1.tp1"]
