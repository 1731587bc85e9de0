"""The train step's attribution on the CPU: the profiler ranges that follow
the step into its backward pass, and the step anatomy's device clock.

* Under ``torch.profiler``, every backward node of an op the forward ran
  in a ``moe.*`` stage or a ``weight_cast`` runs inside ``bwd:<that>`` on
  its own thread, and no other node does; the remat recompute's ops carry
  ``moe.*`` inside ``remat.recompute``; ``train.backward`` holds every
  backward node and ``train.optimizer`` the clip and AdamW.
* Profiler on and off give bit-equal losses, gradients and weights, and
  with it off the step's graph holds no marker node.
* ``StepStats`` with a fake device clock: the ``host`` phase is the
  device's gap between steps, not the dispatch time.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tony_tpu_torch import profiling
from tony_tpu_torch.models import TransformerConfig, make_train_step
from tony_tpu_torch.models import train as train_lib
from tony_tpu_torch.models.transformer import RECOMPUTE_RANGE
from tony_tpu_torch.observability import metrics as port_metrics
from tony_tpu_torch.observability import stepstats as port_stepstats

torch.set_num_threads(1)

MOE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           head_dim=16, d_ff=64, max_seq=32, dtype="bfloat16",
           n_experts=4, expert_top_k=2)
DENSE = {k: v for k, v in MOE.items() if k not in ("n_experts",
                                                     "expert_top_k")}
REMAT = {"none": dict(remat=False), "full": dict(remat=True),
         "dots": dict(remat=True, remat_policy="dots")}
STAGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
NODE = "autograd::engine::evaluate_function"
MARKERS = ("RegionOut", "RegionIn")


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 17))


class _Trace:
    """The host events of a Chrome trace, with the user ranges open on
    each event's thread over all of it."""

    def __init__(self, events: list) -> None:
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") in ("cpu_op", "user_annotation")]
        self.ops = [e for e in spans if e["cat"] == "cpu_op"]
        self.annotations = [e for e in spans
                            if e["cat"] == "user_annotation"]
        self._by_tid: dict = {}
        for e in self.annotations:
            self._by_tid.setdefault(e["tid"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]))

    def ranges(self, e) -> set:
        t0 = float(e["ts"])
        t1 = t0 + float(e["dur"])
        return {n for a, b, n in self._by_tid.get(e["tid"], ())
                if a <= t0 and t1 <= b and (a, b) != (t0, t1)}

    def nodes(self) -> list:
        return [e for e in self.ops if e["name"].startswith(NODE)]

    def count(self, name: str) -> int:
        return sum(e["name"] == name for e in self.annotations)


def _traced(fn) -> _Trace:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return _Trace(json.load(f)["traceEvents"])


def _one_traced_step(cfg: TransformerConfig) -> _Trace:
    init_fn, step_fn = make_train_step(cfg, device="cpu")
    state = init_fn(0)
    state, _ = step_fn(state, _tokens(cfg))  # first call: one-off costs
    return _traced(lambda: step_fn(state, _tokens(cfg, 1)))


@pytest.fixture(scope="module", params=sorted(REMAT))
def moe_trace(request):
    return request.param, _one_traced_step(
        TransformerConfig(**MOE, **REMAT[request.param]))


def _forward_regions(tr: _Trace) -> dict:
    """Sequence number -> the moe.* stages and weight casts its forward op
    ran in. The op that made a node is the last one in the forward to
    carry its number (the counter moves on as a node is made)."""
    last: dict = {}
    for e in tr.ops:
        seq = e["args"].get("Sequence number")
        ranges = tr.ranges(e)
        if seq is None or "train.forward" not in ranges \
                or e["name"].startswith(NODE):
            continue
        if seq not in last or float(e["ts"]) >= float(last[seq][0]["ts"]):
            last[seq] = (e, ranges)
    return {seq: {r for r in ranges if r in STAGES or r == "weight_cast"}
            for seq, (e, ranges) in last.items()
            if not any(m in e["name"] for m in MARKERS)}


def test_moe_backward_runs_in_bwd_ranges_on_its_thread(moe_trace):
    """Each backward node of a stage's (or a cast's) forward op runs
    inside bwd:<stage> (bwd:weight_cast) on the thread that ran it, and
    no node of an op outside runs inside one."""
    remat, tr = moe_trace
    regions = _forward_regions(tr)
    seen = {s: 0 for s in STAGES + ("weight_cast",)}
    for node in tr.nodes():
        if any(m in node["name"] for m in MARKERS):
            continue
        seq = node["args"].get("Sequence number")
        if seq not in regions:
            continue
        ranges = tr.ranges(node)
        bwd = {r[len("bwd:"):] for r in ranges if r.startswith("bwd:")}
        assert bwd == regions[seq], (remat, node["name"], ranges)
        for s in regions[seq]:
            seen[s] += 1
    assert all(seen.values()), seen
    # One bwd: range a region a layer (and the unembedding's cast), each
    # opened and closed on the backward's thread.
    for s in STAGES:
        assert tr.count("bwd:" + s) == MOE["n_layers"]
    assert tr.count("bwd:weight_cast") == 7 * MOE["n_layers"] + 1


def test_recompute_ops_carry_the_moe_ranges(moe_trace):
    """The remat recompute re-enters each stage under its moe.* range,
    inside remat.recompute; without remat there is no recompute."""
    remat, tr = moe_trace
    layers = MOE["n_layers"]
    recompute = [e for e in tr.ops if RECOMPUTE_RANGE in tr.ranges(e)]
    if remat == "none":
        assert tr.count(RECOMPUTE_RANGE) == 0 and not recompute
        assert all(tr.count(s) == layers for s in STAGES)
        return
    assert tr.count(RECOMPUTE_RANGE) == layers
    for s in STAGES:
        assert tr.count(s) == 2 * layers, s
        inside = [a for a in tr.annotations if a["name"] == s
                  and RECOMPUTE_RANGE in tr.ranges(a)]
        assert len(inside) == layers, s
    # The experts' three products a layer, and the MoE layer's own index
    # ops, carry their stage; the attention's recompute carries no moe.*.
    bmm = [e for e in recompute if e["name"] == "aten::bmm"
           and "moe.experts" in tr.ranges(e)]
    assert len(bmm) == 3 * layers
    for e in recompute:
        if e["name"] in ("aten::index_copy", "aten::index_select"):
            assert tr.ranges(e) & {"moe.dispatch", "moe.combine"}


def test_train_ranges_hold_backward_and_optimizer(moe_trace):
    """train.backward holds every backward node, on the node's thread;
    train.optimizer holds the clip's norms and AdamW; train.forward holds
    no backward node."""
    remat, tr = moe_trace
    nodes = tr.nodes()
    assert nodes
    for node in nodes:
        ranges = tr.ranges(node)
        assert "train.backward" in ranges, node["name"]
        assert not ranges & {"train.forward", "train.optimizer"}
    names = {"aten::_foreach_norm", "Optimizer.step#AdamW.step"}
    found = [e for e in tr.ops + tr.annotations if e["name"] in names]
    assert {e["name"] for e in found} == names
    for e in found:
        assert "train.optimizer" in tr.ranges(e), e["name"]
    for name in ("train.forward", "train.optimizer"):
        assert tr.count(name) == 1


@pytest.mark.parametrize("remat", sorted(REMAT))
def test_dense_weight_casts_run_in_their_ranges(remat):
    """The dense trunk's casts (wq/wk/wv/wo, the MLP's three, the
    unembedding) open weight_cast in the forward and the recompute, and
    their gradients' casts back run inside bwd:weight_cast."""
    tr = _one_traced_step(TransformerConfig(**DENSE, **REMAT[remat]))
    layers = DENSE["n_layers"]
    recomputes = 0 if remat == "none" else 7 * layers
    assert tr.count("weight_cast") == 7 * layers + 1 + recomputes
    assert tr.count("bwd:weight_cast") == 7 * layers + 1
    casts = [n for n in tr.nodes() if n["name"].endswith("ToCopyBackward0")
             and "bwd:weight_cast" in tr.ranges(n)]
    assert len(casts) == 7 * layers + 1
    assert not any(r.startswith("bwd:moe.") for n in tr.nodes()
                   for r in tr.ranges(n))


def _graph_nodes(loss) -> list[str]:
    """The names of the nodes of ``loss``'s graph, each once. The visited
    nodes are kept: a node's Python object may be made afresh each time
    it is reached, and a freed one's id taken by the next."""
    seen, kept, todo = set(), [], [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        kept.append(node)
        todo.extend(f for f, _ in node.next_functions)
    return [node.name() for node in kept]


@pytest.mark.parametrize("remat", sorted(REMAT))
def test_profiler_on_and_off_give_bit_equal_steps(remat, monkeypatch):
    """Two steps from the same weights, one under the profiler: the same
    loss, gradients and weights, bit for bit. The step's graph without
    the profiler holds no marker node; with it, the same nodes and the
    markers."""
    cfg = TransformerConfig(**MOE, **REMAT[remat])
    losses = []
    real = train_lib.lm_loss

    def kept(*args, **kwargs):
        out = real(*args, **kwargs)
        losses.append(out[0])
        return out

    monkeypatch.setattr(train_lib, "lm_loss", kept)
    init_fn, step_fn = make_train_step(cfg, device="cpu")
    runs = []
    for traced in (False, True):
        state = init_fn(0)
        if traced:
            _traced(lambda: runs.append(step_fn(state, _tokens(cfg))))
        else:
            runs.append(step_fn(state, _tokens(cfg)))
    (plain, m0), (under, m1) = runs
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key
    for a, b in zip(train_lib.leaves(plain.params),
                    train_lib.leaves(under.params)):
        assert torch.equal(a.grad, b.grad)
        assert torch.equal(a, b)
    off, on = (_graph_nodes(loss) for loss in losses)
    markers = [n for n in on if n.startswith(MARKERS)]
    assert not [n for n in off if n.startswith(MARKERS)]
    assert markers
    assert sorted(off) == sorted(n for n in on if not n.startswith(MARKERS))


def test_regions_pass_tensors_through_untouched_without_a_profiler():
    """annotate_region's enter/leave return their arguments themselves
    when no profiler records, and under no_grad while one does."""
    x = torch.ones(3, requires_grad=True)
    y = torch.zeros(2, requires_grad=True)
    with profiling.annotate_region("r") as r:
        assert r.enter(x) is x
        assert r.leave(x, y) == (x, y)
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        with torch.no_grad(), profiling.annotate_region("r") as r:
            assert r.enter(x) is x
        with profiling.annotate_region("r") as r:
            out = r.leave(r.enter(x) * 2)
        assert out.grad_fn.name().startswith("RegionOut")
    assert not profiling.recording()


# -- the step anatomy's device clock ----------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


class _Device:
    """A fake device timeline (ms): an event records the time ``now``
    and has completed once ``done`` reaches it."""

    def __init__(self):
        self.now = 0.0
        self.done = float("inf")
        self.made = 0

    def event(self):
        self.made += 1
        return _Event(self)


class _Event:
    def __init__(self, device):
        self.device = device
        self.t = None

    def record(self):
        self.t = self.device.now

    def query(self):
        return self.t is not None and self.t <= self.device.done

    def elapsed_time(self, later):
        return later.t - self.t


def _stats(device=None, **kw):
    reg = port_metrics.MetricsRegistry()
    clock = _Clock()

    class _Cfg:
        d_model, n_layers, vocab_size = 64, 2, 512

    stats = port_stepstats.StepStats(
        registry=reg, clock=clock, cfg=_Cfg(), peak_flops=1e12,
        calibrate=False, enabled=True,
        events=device.event if device is not None else None, **kw)
    return stats, reg, clock


def _phases(reg) -> dict:
    g = reg.snapshot()["gauges"]
    return {p: g[f'tony_step_phase_ms{{phase="{p}"}}']
            for p in port_stepstats.PHASES}


def _drive(stats, clock, device, steps, *, lag_ms=None, marks=True):
    """``steps`` back-to-back 100 ms steps whose dispatch blocks 98 ms in
    the launch queue; on the device each runs 99 ms and waits 1 ms for
    the next one's first launch. With ``lag_ms`` the device completes
    work that far behind its timeline."""
    for k in range(steps):
        stats.step_begin((4, 33))
        if device is not None:
            device.now = 100.0 * k
            if lag_ms is not None:
                device.done = device.now - lag_ms
        if marks:
            stats.mark_begin()
        clock.advance(0.098)
        if device is not None:
            device.now = 100.0 * k + 99.0
        if marks:
            stats.mark_end()
        stats.step_end(0.098)
        clock.advance(0.002)


@pytest.mark.parametrize("lag_ms", [None, 50.0, 150.0])
def test_host_phase_is_the_device_gap_between_steps(lag_ms):
    """The dispatch is 98 % of each 100 ms wall, the device waits 1 ms
    between steps: host reads 1 ms, compute the rest, the five phases sum
    to the wall. A device that completes its work up to one and a half
    steps late defers the observations, never their values."""
    device = _Device()
    stats, reg, clock = _stats(device)
    _drive(stats, clock, device, 8, lag_ms=lag_ms)
    phases = _phases(reg)
    assert phases["host"] == pytest.approx(1.0)
    assert phases["compute"] == pytest.approx(99.0)
    assert sum(phases.values()) == pytest.approx(100.0)
    assert reg.snapshot()["gauges"]["step_time_ms"] == pytest.approx(100.0)
    # 8 dispatches: 6 completed intervals, the first dropped; those whose
    # next begin mark has not completed are still waiting.
    waiting = {None: 0, 50.0: 1, 150.0: 2}[lag_ms]
    assert stats.steps_observed == 6 - waiting
    assert device.made == 2 * 8


def test_host_phase_subtracts_the_input_side():
    """A device gap that holds a 30 ms wait on the input counts it once,
    as data_wait: host is the rest of the gap."""
    device = _Device()
    stats, reg, clock = _stats(device)

    def slow():
        while True:
            clock.advance(0.03)
            yield (4, 33)

    batches = stats.wrap_batches(slow())
    for k in range(4):
        stats.step_begin(next(batches))
        device.now = 130.0 * k
        stats.mark_begin()
        clock.advance(0.098)
        device.now = 130.0 * k + 99.0
        stats.mark_end()
        stats.step_end(0.098)
        clock.advance(0.002)
    phases = _phases(reg)
    assert phases["data_wait"] == pytest.approx(30.0)
    assert phases["host"] == pytest.approx(1.0)
    assert sum(phases.values()) == pytest.approx(130.0)


def test_without_marks_host_is_the_dispatch():
    """No device clock, or a clock whose marks the step never records:
    host is the dispatch time, as before."""
    for device, marks in ((None, True), (_Device(), False)):
        stats, reg, clock = _stats(device)
        _drive(stats, clock, device, 4, marks=marks)
        assert _phases(reg)["host"] == pytest.approx(98.0)
        assert stats.steps_observed == 2


def test_a_device_far_behind_keeps_the_ring_bounded():
    """A device that completes nothing: at most _MAX_PENDING steps wait,
    the older ones publish their dispatch time, and the events come from
    a ring of _EVENT_RING pairs."""
    device = _Device()
    device.done = -1.0
    stats, reg, clock = _stats(device)
    _drive(stats, clock, device, 20, lag_ms=1e9)
    assert len(stats._pending) == port_stepstats._MAX_PENDING
    assert stats.steps_observed == 18 - port_stepstats._MAX_PENDING
    assert _phases(reg)["host"] == pytest.approx(98.0)
    assert device.made == 2 * port_stepstats._EVENT_RING


def test_instrumented_marks_a_step_without_its_own():
    """_instrumented records the two marks around the dispatch of a step
    that does not record them itself, and none around one that does."""
    for marked in (False, True):
        device = _Device()
        stats, _, _ = _stats(device)
        step = train_lib._instrumented(lambda: None, stats, marked=marked)
        for _ in range(3):
            step()
        assert device.made == (0 if marked else 2 * 3)
