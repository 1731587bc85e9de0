"""The port's plan layer (``tony_tpu_torch.parallel.plan``) held against the
JAX package's on the CPU.

* The planner: ``candidate_plans``, ``estimate_cost``, ``plan_for`` and
  ``shrink_plans`` give the same plans in the same order, and costs equal
  to 1e-12 relative, over a grid of configs, device counts, batches,
  sequences, slice counts and pinned axes.
* The measurement table: a table either package writes the other reads,
  and ``plan_for`` and ``calibration_residuals`` agree on it; best-of
  updates, corrupt tables and empty buckets degrade as the reference's do.
* Cache keys: ``plan_cache_key`` changes with each of its inputs (label,
  config, mesh, plan, extras, backend: the torch and CUDA versions, the
  device and the kernel sources), as JAX's does with its own.
* The compile cache: ``CompileCache`` degrade-to-miss, ``timed_compile``
  and ``instrument_jit`` counting misses and hits into the registry,
  ``configure_compile_cache`` pointing the kernels' build directory.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.parallel import mesh as jax_mesh
from tony_tpu.parallel import plan as jax_plan
from tony_tpu_torch import kernels, observability
from tony_tpu_torch.models import TransformerConfig
from tony_tpu_torch.parallel import MeshSpec
from tony_tpu_torch.parallel import plan as plan_lib

CONFIGS = {
    "dense": dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4,
                  head_dim=8, d_ff=64, max_seq=64, dtype="float32",
                  n_kv_heads=2),
    "moe": dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4,
                head_dim=8, d_ff=64, max_seq=64, dtype="float32",
                n_experts=4),
    "flagship": dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
                     head_dim=64, d_ff=4096, max_seq=2048, n_kv_heads=4,
                     dtype="bfloat16"),
}

# (config, devices, global batch, seq, slices, require)
GRID = [
    ("dense", 1, None, None, 1, None),
    ("dense", 8, 16, 16, 1, None),
    ("dense", 8, None, 16, 1, None),
    ("dense", 8, 16, 16, 2, None),
    ("dense", 4, 8, 64, 1, {"pp": 2}),
    ("dense", 8, None, None, 1, {"pp": 2, "tp": 2, "microbatches": 2}),
    ("dense", 6, 12, 12, 1, None),
    ("moe", 8, None, 16, 1, None),
    ("moe", 4, 8, 16, 1, {"ep": 2}),
    ("flagship", 4, 32, 2048, 1, None),
    ("flagship", 16, 64, 2048, 2, None),
    ("flagship", 2, 8, 2048, 1, {"microbatches": 0}),
]


def _cfgs(name):
    return TransformerConfig(**CONFIGS[name]), JaxConfig(**CONFIGS[name])


def _jax_plan(plan):
    s = plan.mesh_spec
    return jax_plan.Plan(
        jax_mesh.MeshSpec(dp=s.dp, pp=s.pp, ep=s.ep, sp=s.sp, tp=s.tp),
        num_slices=plan.num_slices, microbatches=plan.microbatches,
        pipeline_schedule=plan.pipeline_schedule,
        pipeline_virtual=plan.pipeline_virtual)


@pytest.mark.parametrize("case", GRID, ids=lambda c: "-".join(map(str, c)))
def test_planner_matches_jax(case):
    name, n, batch, seq, slices, require = case
    cfg, jcfg = _cfgs(name)
    kw = dict(num_slices=slices, global_batch=batch, seq=seq,
              require=require)
    got = plan_lib.candidate_plans(cfg, n, **kw)
    want = jax_plan.candidate_plans(jcfg, n, **kw)
    assert [p.key() for p in got] == [p.key() for p in want]
    for p, q in zip(got, want):
        assert p.describe() == q.describe()
        c_got = plan_lib.estimate_cost(p, cfg, global_batch=batch, seq=seq)
        c_want = jax_plan.estimate_cost(q, jcfg, global_batch=batch, seq=seq)
        assert c_got == pytest.approx(c_want, rel=1e-12)
    if want:
        assert plan_lib.plan_for(cfg, n, **kw).key() == \
            jax_plan.plan_for(jcfg, n, **kw).key()
    else:
        with pytest.raises(ValueError, match="no legal plan"):
            plan_lib.plan_for(cfg, n, **kw)


@pytest.mark.parametrize("n,slices,require", [
    (7, 1, {"dp": 7}), (8, 2, None), (4, 1, {"tp": 2}), (1, 1, None)])
def test_shrink_plans_match_jax(n, slices, require):
    got = plan_lib.shrink_plans(n, num_slices=slices, require=require)
    want = jax_plan.shrink_plans(n, num_slices=slices, require=require)
    assert [p.key() for p in got] == [p.key() for p in want]


def test_candidates_are_legal():
    cfg, _ = _cfgs("dense")
    plans = plan_lib.candidate_plans(cfg, 8, global_batch=16, seq=16)
    assert plans
    for p in plans:
        s = p.mesh_spec
        assert p.num_devices == 8
        assert cfg.n_heads % s.tp == 0 and cfg.n_kv_heads % s.tp == 0
        assert s.ep == 1 and cfg.n_layers % s.pp == 0
        assert (p.microbatches is not None) == (s.pp > 1)
    assert plan_lib.candidate_plans(cfg, 8, seq=16, require={"ep": 2}) == []


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_measurement_tables_cross_read(tmp_path, writer):
    """A table one package writes, the other reads: the same entries, the
    same measured pick, the same residuals; best-of updates."""
    cfg, jcfg = _cfgs("dense")
    d = str(tmp_path)
    plans = plan_lib.candidate_plans(cfg, 8, global_batch=16, seq=16)
    times = [500.0, 1.0, 3.0 * plan_lib.estimate_cost(
        plans[2], cfg, global_batch=16, seq=16)]
    for p, ms in zip(plans[:3], times):
        if writer == "jax":
            jax_plan.record_step_time(_jax_plan(p), jcfg, ms,
                                      global_batch=16, seq=16, cache_dir=d)
        else:
            plan_lib.record_step_time(p, cfg, ms, global_batch=16, seq=16,
                                      cache_dir=d)
    plan_lib.record_step_time(plans[1], cfg, 900.0, global_batch=16,
                              seq=16, cache_dir=d)
    table = plan_lib.load_measurements(cache_dir=d)
    assert table == jax_plan.load_measurements(cache_dir=d)
    bucket = plan_lib._model_bucket(cfg, 8, 16, 16)
    assert bucket == jax_plan._model_bucket(jcfg, 8, 16, 16)
    assert table[bucket][plans[1].key()] == 1.0
    assert plan_lib._model_bucket(cfg, 8, 64, 16) != bucket
    kw = dict(global_batch=16, seq=16, cache_dir=d)
    assert plan_lib.plan_for(cfg, 8, **kw).key() == plans[1].key() == \
        jax_plan.plan_for(jcfg, 8, **kw).key()
    got = plan_lib.calibration_residuals(cfg, 8, **kw)
    want = jax_plan.calibration_residuals(jcfg, 8, **kw)
    assert set(got) == set(want) == {p.key() for p in plans[:3]}
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-12)
    assert plan_lib.calibration_residuals(cfg, 8, global_batch=99, seq=16,
                                          cache_dir=d) == {}


def test_corrupt_or_absent_tables_degrade_to_analytic(tmp_path):
    cfg, _ = _cfgs("dense")
    d = str(tmp_path)
    analytic = plan_lib.plan_for(cfg, 8, seq=16, cache_dir=d)
    (tmp_path / plan_lib._MEASUREMENTS_FILE).write_text("{nope")
    assert plan_lib.load_measurements(cache_dir=d) == {}
    assert plan_lib.plan_for(cfg, 8, seq=16, cache_dir=d) == analytic
    plan_lib.record_step_time(analytic, cfg, float("nan"), seq=16,
                              cache_dir=d)
    plan_lib.record_step_time(analytic, cfg, -1.0, seq=16, cache_dir=d)
    assert plan_lib.load_measurements(cache_dir=d) == {}


def test_estimate_phases_decompose_as_jax_does():
    cfg, jcfg = _cfgs("dense")
    for spec in (MeshSpec(dp=8), MeshSpec(dp=2, tp=2, sp=2),
                 MeshSpec(dp=4, tp=2), MeshSpec(pp=2)):
        p = plan_lib.Plan(spec)
        got = plan_lib.estimate_phases(p, cfg, global_batch=16, seq=16)
        want = jax_plan.estimate_phases(_jax_plan(p), jcfg, global_batch=16,
                                        seq=16)
        assert got == want
        assert plan_lib.estimate_cost(p, cfg, global_batch=16, seq=16) == \
            pytest.approx(got["compute"] + got["collective"], rel=1e-12)


class _Mesh:
    """What plan_cache_key and backend_fingerprint read of a mesh
    ``build_mesh`` made: its device type and the sizes of its five
    axes."""

    def __init__(self, device_type="cpu", **axes):
        self.shape = MeshSpec(**axes).shape
        self.device_type = device_type

    def size(self, dim: int) -> int:
        return self.shape[dim]


BACKEND = {"torch": "2.x", "cuda": "12.x", "kernels": "abc",
           "platform": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
           "num_devices": 1}


def test_plan_cache_key_changes_with_each_input():
    cfg, _ = _cfgs("dense")
    base = dict(config=cfg, mesh=_Mesh(dp=2, tp=2),
                plan=plan_lib.Plan(MeshSpec(dp=2, tp=2)), extra={"a": 1},
                backend=BACKEND)
    key = plan_lib.plan_cache_key("step", **base)
    assert key == plan_lib.plan_cache_key("step", **base)
    changed = {
        "label": ("init", {}),
        "config": ("step", {"config": TransformerConfig(
            **dict(CONFIGS["dense"], n_layers=2))}),
        "mesh shape": ("step", {"mesh": _Mesh(dp=4)}),
        "mesh axis": ("step", {"mesh": _Mesh(dp=2, sp=2)}),
        "plan": ("step", {"plan": plan_lib.Plan(MeshSpec(dp=2, tp=2),
                                                donate_state=False)}),
        "extra": ("step", {"extra": {"a": 2}}),
    }
    for field in ("torch", "cuda", "kernels", "device_kind", "num_devices"):
        changed[field] = ("step", {"backend": dict(BACKEND, **{field: "x"})})
    keys = {key}
    for what, (label, override) in changed.items():
        other = plan_lib.plan_cache_key(label, **{**base, **override})
        assert other not in keys, what
        keys.add(other)


def test_backend_fingerprint_follows_the_kernel_sources(monkeypatch,
                                                        tmp_path):
    import torch

    fp = plan_lib.backend_fingerprint()
    assert fp["torch"] == torch.__version__
    assert fp["cuda"] == torch.version.cuda
    assert (fp["platform"], fp["device_kind"], fp["num_devices"]) == (
        "cpu", "cpu", 1)
    mesh_fp = plan_lib.backend_fingerprint(_Mesh(dp=2, tp=2))
    assert mesh_fp["num_devices"] == 4
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a kernel\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    first = plan_lib.backend_fingerprint()["kernels"]
    (csrc / "h.cuh").write_text("#pragma once\n")
    assert plan_lib.backend_fingerprint()["kernels"] != first
    key = plan_lib.plan_cache_key("k")
    (csrc / "a.cu").write_text("// edited\n")
    assert plan_lib.plan_cache_key("k") != key



def test_compile_cache_degrades_to_miss(tmp_path):
    cache = plan_lib.CompileCache(str(tmp_path))
    assert cache.enabled and not cache.seen("x" * 64)
    cache.commit("x" * 64, {"label": "step"})
    assert cache.seen("x" * 64)
    index = tmp_path / plan_lib._KEY_INDEX_DIR
    (index / ("y" * 64 + ".json")).write_text("{torn")
    assert not cache.seen("y" * 64)
    (index / ("z" * 64 + ".json")).write_text(json.dumps({"key": "other"}))
    assert not cache.seen("z" * 64)
    blocked = tmp_path / "file"
    blocked.write_text("")
    cache = plan_lib.CompileCache(str(blocked))
    cache.commit("w" * 64)  # unwritable: no crash, stays a miss
    assert not cache.seen("w" * 64)
    off = plan_lib.CompileCache(None)
    off.commit("v" * 64)
    assert not off.enabled and not off.seen("v" * 64)
    # The JAX package's index reads the port's markers, and back.
    assert jax_plan.CompileCache(str(tmp_path)).seen("x" * 64)
    jax_plan.CompileCache(str(tmp_path)).commit("u" * 64)
    assert plan_lib.CompileCache(str(tmp_path)).seen("u" * 64)


def test_instrument_jit_counts_miss_then_hit(tmp_path):
    reg = observability.default_registry()
    cache = plan_lib.CompileCache(str(tmp_path))
    hits = reg.counter("tony_compile_cache_hits_total")
    misses = reg.counter("tony_compile_cache_misses_total")
    ms = reg.histogram("tony_compile_ms", buckets=plan_lib._COMPILE_BUCKETS)
    h0, m0, n0 = hits.value, misses.value, ms.snapshot()["count"]
    key = f"base-key-{tmp_path.name}"
    fn = plan_lib.instrument_jit(lambda x: x + 1, key, cache=cache)
    assert fn(1) == 2 and fn(2) == 3
    assert (hits.value, misses.value) == (h0, m0 + 1)
    assert ms.snapshot()["count"] == n0 + 1
    # A second wrapper (a retried process) over the same cache, key and
    # argument signature is a hit; another argument shape is a miss.
    assert plan_lib.instrument_jit(lambda x: x + 1, key, cache=cache)(1) == 2
    assert (hits.value, misses.value) == (h0 + 1, m0 + 1)
    plan_lib.instrument_jit(lambda x: x, key, cache=cache)(np.zeros((2, 3)))
    assert (hits.value, misses.value) == (h0 + 1, m0 + 2)
    assert plan_lib._args_signature((np.zeros((2, 3)), None, 4),
                                    {"s": np.int32(9)}) == [
        "float64(2, 3)", "4", "int32()"]


def test_configure_compile_cache_points_the_kernel_builds(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    monkeypatch.setattr(plan_lib, "_ACTIVE_CACHE_DIR", None)
    target = tmp_path / "cc"
    monkeypatch.setenv("TONY_COMPILE_CACHE_DIR", str(target))
    assert plan_lib.configure_compile_cache() == str(target)
    assert kernels.BUILD_DIR == target and target.is_dir()
    assert plan_lib.active_cache_dir() == str(target)
    assert kernels.library_path("rms_norm.cu").parent == target
    plan_lib.record_step_time(plan_lib.Plan(MeshSpec()),
                              _cfgs("dense")[0], 12.5)
    assert (target / plan_lib._MEASUREMENTS_FILE).is_file()
    monkeypatch.setenv("TONY_COMPILE_CACHE_ENABLED", "false")
    assert plan_lib.configure_compile_cache() is None
    assert plan_lib.active_cache_dir() is None
    monkeypatch.delenv("TONY_COMPILE_CACHE_ENABLED")
    monkeypatch.delenv("TONY_COMPILE_CACHE_DIR")
    default = plan_lib.default_cache_dir()
    assert default.endswith("tony_tpu_torch/_build")
    assert plan_lib.configure_compile_cache() == default
    blocked = tmp_path / "file"
    blocked.write_text("")
    assert plan_lib.configure_compile_cache(str(blocked / "x")) is None


def test_plan_from_mesh_and_names():
    mesh = SimpleNamespace(size=lambda i: (4, 1, 1, 1, 2)[i])
    p = plan_lib.plan_from_mesh(mesh)
    assert (p.mesh_spec.dp, p.mesh_spec.tp, p.num_devices) == (4, 2, 8)
    public = {n for n in dir(jax_plan) if not n.startswith("_")
              and callable(getattr(jax_plan, n))
              and getattr(getattr(jax_plan, n), "__module__", "")
              == jax_plan.__name__}
    assert public <= set(dir(plan_lib)), public - set(dir(plan_lib))
