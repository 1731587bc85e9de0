"""The port's jit sanitizer (``tony_tpu_torch.analysis.jit_sanitizer``)
held against the JAX package's on the CPU.

* ``JitTracker``: the same call sequences give the same classifications,
  retrace counts, budgets and violation lists in both packages, and the
  report and dump envelopes match (JAX's flight reader loads the port's
  dump).
* ``note_dispatch``: the retrace counter moves only on a retrace, strict
  mode raises past the budget, report mode never does.
* ``step_region`` and ``explicit_fence``: with CUDA's sync debug mode
  stubbed (the CPU build has none), the region arms "error" and restores
  the mode it found, a synchronizing operation inside raises and is
  recorded and counted, the fence lowers the mode for its body only; off,
  or without CUDA, both are no-ops.
* ``instrument_jit``: the cold call counts as a compile-cache miss, a
  repeated signature as nothing, a new one as a retrace only.

Deliberate violations go to private trackers: the process-global one is
left to the suite.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tony_tpu.analysis import jit_sanitizer as jax_sanitizer
from tony_tpu.observability import flight
from tony_tpu_torch import observability
from tony_tpu_torch.analysis import jit_sanitizer
from tony_tpu_torch.parallel import plan as plan_lib

# Call sequences (key, signature) fed to both packages' trackers.
SEQUENCES = {
    "cold_hit_retrace": [("k", "a"), ("k", "a"), ("k", "b"), ("k", "b")],
    "independent_keys": [("a", "s1"), ("b", "s1"), ("a", "s1"),
                         ("b", "s2")],
    "over_budget": [("k", f"s{i}") for i in range(5)],
    "interleaved": [("x", "s0"), ("y", "s0"), ("x", "s1"), ("y", "s0"),
                    ("x", "s0"), ("x", "s2"), ("y", "s3")],
}

_VOLATILE = ("stack", "ts_ms", "thread", "detail")


def _stable(violations):
    return [{k: v for k, v in viol.items() if k not in _VOLATILE}
            for viol in violations]


@pytest.mark.parametrize("budget", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_tracker_classifies_as_jax_does(name, budget):
    port = jit_sanitizer.JitTracker(budget=budget)
    ref = jax_sanitizer.JitTracker(budget=budget)
    for key, sig in SEQUENCES[name]:
        assert port.note_call(key, sig) == ref.note_call(key, sig)
    assert port.retraces() == ref.retraces()
    for key in {k for k, _ in SEQUENCES[name]}:
        assert port.retraces(key) == ref.retraces(key)
    assert port.mark() == ref.mark()
    assert _stable(port.violations()) == _stable(ref.violations())
    got, want = port.report(), ref.report()
    got["events"], want["events"] = (_stable(got["events"]),
                                     _stable(want["events"]))
    assert got == want
    assert all(v["stack"] for v in port.violations())


def test_mark_and_violations_since():
    tr = jit_sanitizer.JitTracker(budget=4)
    tr.note_call("k", "s0")
    tr.note_call("k", "s1")
    mark = tr.mark()
    assert tr.violations_since(mark) == []
    tr.note_call("k", "s2")
    since = tr.violations_since(mark)
    assert len(since) == 1 and since[0]["signature"] == "s2"
    tr.reset()
    assert tr.mark() == 0 and tr.retraces() == 0 and tr.violations() == []


def test_names_and_env_match_the_reference():
    for name in ("ENV_FLAG", "ENV_RETRACE_BUDGET", "ENV_REPORT_DIR",
                 "RETRACE", "GUARDED_TRANSFER", "RETRACES_COUNTER",
                 "GUARDED_TRANSFERS_COUNTER"):
        assert getattr(jit_sanitizer, name) == getattr(jax_sanitizer, name)
    public = {n for n in dir(jax_sanitizer) if not n.startswith("_")
              and callable(getattr(jax_sanitizer, n))
              and getattr(getattr(jax_sanitizer, n), "__module__", "")
              == jax_sanitizer.__name__}
    assert public <= set(dir(jit_sanitizer)), public - set(dir(jit_sanitizer))


@pytest.mark.parametrize("mode,raises", [("strict", True), ("1", False),
                                         ("report", False)])
def test_budget_raises_only_in_strict_mode(monkeypatch, mode, raises):
    monkeypatch.setenv(jit_sanitizer.ENV_FLAG, mode)
    counter = observability.default_registry().counter(
        jit_sanitizer.RETRACES_COUNTER)
    tr = jit_sanitizer.JitTracker(budget=1)
    base = counter.value
    assert jit_sanitizer.note_dispatch("nd-key", "s0", tracker_=tr) == "cold"
    assert jit_sanitizer.note_dispatch("nd-key", "s0", tracker_=tr) == "hit"
    assert counter.value == base
    assert jit_sanitizer.note_dispatch("nd-key", "s1",
                                       tracker_=tr) == "retrace"
    assert counter.value == base + 1
    if raises:
        with pytest.raises(jit_sanitizer.RetraceBudgetExceeded,
                           match="nd-key"):
            jit_sanitizer.note_dispatch("nd-key", "s2", tracker_=tr)
    else:
        jit_sanitizer.note_dispatch("nd-key", "s2", tracker_=tr)
    assert tr.retraces("nd-key") == 2


@pytest.fixture
def sync_mode(monkeypatch):
    """CUDA's sync debug mode, stubbed: the CPU build of torch has none.
    Returns the list of modes set, the current one last."""
    modes = [0]
    monkeypatch.setattr(jit_sanitizer, "_get_sync_mode", lambda: modes[-1])
    monkeypatch.setattr(jit_sanitizer, "_set_sync_mode", modes.append)
    monkeypatch.setenv(jit_sanitizer.ENV_FLAG, "1")
    return modes


def test_step_region_raises_records_and_restores(sync_mode):
    """A synchronizing operation inside the region raises PyTorch's error,
    which is recorded with a stack and counted; the mode is restored."""
    counter = observability.default_registry().counter(
        jit_sanitizer.GUARDED_TRANSFERS_COUNTER)
    base = counter.value
    tr = jit_sanitizer.JitTracker()
    with pytest.raises(RuntimeError, match="synchronizing"):
        with jit_sanitizer.step_region("guarded-key", tracker_=tr):
            assert sync_mode[-1] == 2
            raise RuntimeError("called a synchronizing CUDA operation")
    assert sync_mode[-1] == 0
    transfers = tr.violations(jit_sanitizer.GUARDED_TRANSFER)
    assert len(transfers) == 1 and transfers[0]["key"] == "guarded-key"
    assert transfers[0]["stack"] and tr.transfers() == 1
    assert counter.value == base + 1
    # Another error passes through unrecorded.
    with pytest.raises(ValueError):
        with jit_sanitizer.step_region("other", tracker_=tr):
            raise ValueError("shape mismatch")
    assert tr.transfers() == 1 and sync_mode[-1] == 0


def test_explicit_fence_lowers_the_mode_for_its_body(sync_mode):
    tr = jit_sanitizer.JitTracker()
    with jit_sanitizer.step_region("fence-key", tracker_=tr):
        with jit_sanitizer.step_region("inner", tracker_=tr):
            assert sync_mode[-1] == 2
        assert sync_mode[-1] == 2  # the inner region restored "error"
        with jit_sanitizer.explicit_fence():
            assert sync_mode[-1] == 0
        assert sync_mode[-1] == 2
    assert sync_mode[-1] == 0
    with jit_sanitizer.explicit_fence():  # outside a region: nothing set
        assert sync_mode[-1] == 0
    assert tr.violations() == []


def test_step_region_restores_a_mode_it_found(sync_mode):
    sync_mode.append(1)  # "warn", set by the caller
    with jit_sanitizer.step_region("warn-key"):
        assert sync_mode[-1] == 2
    assert sync_mode[-1] == 1


def test_off_or_without_cuda_the_region_is_a_noop(sync_mode, monkeypatch):
    monkeypatch.setenv(jit_sanitizer.ENV_FLAG, "0")
    with jit_sanitizer.step_region("off-key"), jit_sanitizer.explicit_fence():
        pass
    assert sync_mode == [0]
    monkeypatch.undo()
    monkeypatch.setenv(jit_sanitizer.ENV_FLAG, "strict")
    assert not torch.cuda.is_available()
    assert jit_sanitizer._get_sync_mode() is None
    with jit_sanitizer.step_region("no-cuda"):
        assert torch.ones(2).sum().item() == 2.0


def test_dump_loads_in_the_flight_reader(tmp_path):
    import os

    tr = jit_sanitizer.JitTracker(budget=1)
    tr.note_call("dump-key", "s0")
    tr.note_call("dump-key", "s1")
    tr.note_transfer("called a synchronizing CUDA operation", key="dump-key")
    path = tr.dump(tmp_path, reason="unit-test")
    assert path.endswith(f"blackbox-jit-sanitizer-{os.getpid()}.json")
    docs = flight.load_blackboxes(tmp_path)
    assert len(docs) == 1
    doc = next(iter(docs.values()))
    assert doc["proc"] == "jit-sanitizer" and doc["reason"] == "unit-test"
    assert doc["retraces"] == {"dump-key": 1} and doc["transfers"] == 1
    assert sorted(e["kind"] for e in doc["events"]) == [
        jit_sanitizer.GUARDED_TRANSFER, jit_sanitizer.RETRACE]
    assert doc["reports"] == [] and doc["rpcs"] == []


def test_instrument_jit_never_double_counts(tmp_path, monkeypatch):
    """The cold call lands in tony_compile_cache_misses_total, a repeated
    signature in nothing, a new signature in tony_retraces_total only;
    numpy scalars count by dtype and shape, not value."""
    monkeypatch.setenv(jit_sanitizer.ENV_FLAG, "1")
    reg = observability.default_registry()
    misses = reg.counter("tony_compile_cache_misses_total")
    hits = reg.counter("tony_compile_cache_hits_total")
    retraces = reg.counter(jit_sanitizer.RETRACES_COUNTER)
    key = f"acct-test-key-{tmp_path.name}"
    fn = plan_lib.instrument_jit(lambda x, draw: x * 2, key,
                                 cache=plan_lib.CompileCache(str(tmp_path)))
    m0, h0, r0 = misses.value, hits.value, retraces.value
    fn(torch.zeros(4), np.int32(1))
    assert (misses.value, retraces.value) == (m0 + 1, r0)
    fn(torch.ones(4), np.int32(7))
    assert (misses.value, hits.value, retraces.value) == (m0 + 1, h0, r0)
    fn(torch.zeros(8), np.int32(7))
    assert (misses.value, retraces.value) == (m0 + 1, r0 + 1)
    assert jit_sanitizer.tracker().retraces(key) == 1
    assert fn.plan_cache_key == key and fn.__wrapped__(3, 0) == 6
