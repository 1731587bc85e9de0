"""Step anatomy: per-step phase telemetry and live MFU, the producer side of
the JAX package's ``observability/stepstats.py``.

For every instrumented train step (``models/train._instrumented`` feeds it),
with no profiler session and no device synchronization:

* **wall**: the interval between consecutive dispatches of the step. In a
  steady loop that interval is the whole step, wherever the caller put its
  readback fence.
* **data_wait**: host time blocked on the input: the larger of the wrapped
  batch iterator's ``next()`` wait (``StepStats.wrap_batches``) and the
  data plane's ``tony_io_batch_wait_ms`` over the same interval.
* **h2d**: the ``tony_io_h2d_ms`` delta.
* **host**: the time the device waited on the host. Where the step
  records device-clock marks (``mark_begin`` before its first launch,
  ``mark_end`` after its last: two timing events on the current stream,
  from a small ring), it is the device clock's gap from the previous
  step's end mark to this step's begin mark, less the ``data_wait`` and
  ``h2d`` already counted. Eager PyTorch fills the launch queue, so a
  device-bound step's dispatch blocks until the device drains: the
  dispatch time would read ~the whole step there. A step's observation
  then waits until its marks have completed, which ``Event.query()``
  checks at later hooks; nothing synchronizes. Without a device clock
  (the CPU, or marks never recorded) it is the measured dispatch cost.
  The raw dispatch time is ``train_step_dispatch_seconds`` either way.
* **compute / collective**: the device residual (wall - data_wait - h2d -
  host), split by the plan's analytic communication share
  (``parallel.plan.estimate_phases``). The split is an estimate; the
  residual is measured, so the five phases sum to the step wall exactly.

On top of the breakdown, **MFU**: analytic model flops (PaLM 6N plus the
causal-attention term) over wall x device count x the device's peak
(``PEAK_FLOPS``, keyed by ``torch.cuda.get_device_name``), published as
``tony_mfu``; and **per-axis collective volume**,
``tony_collective_bytes_total{axis=}``.

The gauges ride the executor's heartbeat piggyback (default registry ->
``$TONY_METRICS_FILE`` -> the coordinator's ``/metrics``), where the
orchestrator's readers (``/api/stepstats``, ``tony top``) find them as they
find the JAX package's.

With ``calibrate`` (``tony.stepstats.calibrate``, on by default) the best
observed wall feeds back, as in the JAX package: into the planner's
measurement table (``plan.record_step_time``), into the autotune record's
``live_best_ms`` (``autotune.note_step_time``), and the plan's
calibration residual (``plan.calibration_residuals``) is published as
``tony_plan_residual{plan=}``; at most once per ``window`` steps
(``tony.stepstats.window``, 32), after three observed steps, and only for
a real (1 %) improvement. The record is written at ``step_end`` of the
dispatch whose ``step_begin`` observed the wall, not at that observation
(the JAX package's point): by then the step's work is queued, so the
table's file I/O runs while the device executes instead of while it idles.
"""

from __future__ import annotations

import collections
import functools
import math
import os
import time
from typing import Any, Iterator, Mapping

import torch

from tony_tpu_torch import constants
from tony_tpu_torch.observability import metrics as obs_metrics
from tony_tpu_torch.parallel import plan as plan_lib

# The exclusive phase breakdown, in reporting order.
PHASES = ("data_wait", "h2d", "compute", "collective", "host")

STEP_PHASE_GAUGE = "tony_step_phase_ms"          # labeled {phase=}
MFU_GAUGE = "tony_mfu"
MODEL_FLOPS_GAUGE = "tony_model_flops_per_step"
COLLECTIVE_BYTES_COUNTER = "tony_collective_bytes_total"  # labeled {axis=}
PLAN_RESIDUAL_GAUGE = "tony_plan_residual"       # labeled {plan=}

# Data-plane histograms whose sum deltas attribute the input side (absent
# series read as zero).
_IO_BATCH_WAIT_HISTOGRAM = "tony_io_batch_wait_ms"
_IO_H2D_HISTOGRAM = "tony_io_h2d_ms"

# Per-device peak dense bf16 flops/s for MFU, keyed by
# torch.cuda.get_device_name() ("cpu" for the CPU, nominal so CPU runs
# still give a number). Any other name has no entry: no MFU is published.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H100 PCIe": 756e12,
    "cpu": 1e11,
}


def peak_flops_per_chip(device) -> float:
    """Peak dense flops/s of one ``device`` (a ``torch.device`` or its
    name); 0.0 for a device the table does not know, so that MFU is then
    not reported rather than reported against a wrong peak."""
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return PEAK_FLOPS.get(name, 0.0)


def model_flops_per_step(cfg, batch: int, seq: int) -> float | None:
    """Analytic model flops for one train step of ``cfg`` at
    (batch, seq): PaLM 6N counting plus the causal-attention term (model
    flops: remat recompute is excluded). N holds the unembedding once and
    not the embedding, a gather (the JAX package counts
    ``2 * vocab * d_model``). None for configs that are not
    transformer-shaped (no d_model/n_layers): image classifiers get
    phases but not MFU."""
    d_model = getattr(cfg, "d_model", None)
    n_layers = getattr(cfg, "n_layers", None)
    vocab = getattr(cfg, "vocab_size", None)
    if not d_model or not n_layers or not vocab:
        return None
    n_heads = getattr(cfg, "n_heads", 8)
    head_dim = getattr(cfg, "head_dim", 64)
    n_kv = getattr(cfg, "n_kv_heads", 0) or n_heads
    d_ff = getattr(cfg, "d_ff", 4 * d_model)
    # MoE: every token goes through top_k SwiGLU experts, plus the router.
    n_experts = getattr(cfg, "n_experts", 0) or 0
    top_k = (getattr(cfg, "expert_top_k", 0) or 1) if n_experts else 1
    n_params = n_layers * (
        d_model * (n_heads + 2 * n_kv) * head_dim
        + n_heads * head_dim * d_model
        + 3 * d_model * d_ff * top_k
        + d_model * n_experts
    ) + vocab * d_model
    return (
        6.0 * n_params * batch * seq
        + 6.0 * n_layers * batch * seq * seq * n_heads * head_dim
    )


# Device-clock event pairs a StepStats keeps, and the observations at most
# waiting on them (each holds two pairs' events).
_EVENT_RING = 8
_MAX_PENDING = _EVENT_RING - 2


class _Draft:
    """An observed step whose ``host`` phase waits on the device clock: the
    previous step's end mark and this step's begin mark."""

    __slots__ = ("wall", "data_wait", "h2d", "dispatch", "end", "begin")

    def __init__(self, wall, data_wait, h2d, dispatch):
        self.wall, self.data_wait, self.h2d = wall, data_wait, h2d
        self.dispatch = dispatch
        self.end = self.begin = None


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class StepStats:
    """Per-step anatomy recorder for one instrumented step function.

    ``models/train.make_train_step`` builds one (attached to the returned
    step as ``step.stepstats``) and ``_instrumented`` drives it with
    ``step_begin``/``step_end`` around every dispatch. Nothing here
    synchronizes the device: the wall is the dispatch-to-dispatch
    interval, the input side comes from the data plane's telemetry plus
    the optional ``wrap_batches`` wrapper, and the compute/collective split
    is the plan cost model's.

    The first dispatch's interval is excluded: it holds the first call's
    one-off costs (kernel builds, allocator growth), not a step.
    ``device`` names the device whose ``PEAK_FLOPS`` entry MFU is taken
    against, unless ``peak_flops`` is given; with neither there is no MFU.
    ``events`` makes the device clock's timing events (a zero-argument
    factory of objects with ``record()``, ``query()`` and
    ``elapsed_time(later)`` in ms, as ``torch.cuda.Event``); by default a
    CUDA ``device`` has ``torch.cuda.Event(enable_timing=True)`` and any
    other device none.
    """

    def __init__(
        self,
        *,
        cfg: Any = None,
        plan: Any = None,
        mesh: Any = None,
        microbatches: int | None = None,
        steps_per_call: int = 1,
        tokens_workload: bool = True,
        size_from_shapes: bool = True,
        registry=None,
        enabled: bool | None = None,
        calibrate: bool | None = None,
        window: int | None = None,
        clock=time.perf_counter,
        peak_flops: float | None = None,
        device=None,
        events=None,
    ) -> None:
        self.enabled = (
            _env_bool(constants.TONY_STEPSTATS_ENABLED, True)
            if enabled is None else enabled
        )
        self.calibrate = (
            _env_bool(constants.TONY_STEPSTATS_CALIBRATE, True)
            if calibrate is None else calibrate
        )
        self.window = max(window if window is not None
                          else _env_int(constants.TONY_STEPSTATS_WINDOW, 32),
                          1)
        self.cfg = cfg
        self.plan = plan
        self._mesh = mesh
        self._microbatches = microbatches
        self.steps_per_call = max(int(steps_per_call), 1)
        # tokens_workload: the step's batch argument is [B, T+1] tokens
        # whose shape sizes the flops/comm model; False (image
        # classifiers) keeps the phase breakdown and skips MFU.
        self._tokens_workload = tokens_workload
        # size_from_shapes=False: the caller sizes the workload itself
        # (make_train_step calls set_workload with the global batch: the
        # hook sees only this rank's rows).
        self._size_from_shapes = size_from_shapes
        self.mfu: float | None = None
        self._registry = registry
        self._clock = clock
        self._peak_flops = peak_flops
        self._device = device
        if events is None and device is not None \
                and torch.device(device).type == "cuda":
            events = functools.partial(torch.cuda.Event, enable_timing=True)
        self._events = events
        self._ring: list[list] = []
        self._ring_next = 0
        self._marks: list | None = None     # this dispatch's [begin, end]
        self._last_end = None               # the previous dispatch's end
        self._pending: collections.deque = collections.deque()
        self.global_batch: int | None = None
        self.seq: int | None = None
        self._flops: float | None = None
        self._comm_share = 0.0
        self._comm_bytes: dict[str, float] = {}
        self._num_devices = 1
        self._sized = False
        # Rolling interval state.
        self._begins = 0
        self._last_begin: float | None = None
        self._pending_data_s = 0.0
        self._dispatch_s = 0.0
        self._record_due = False
        self._io_wait_ms: float | None = None
        self._io_h2d_ms: float | None = None
        self.steps_observed = 0
        self._best_wall_ms = math.inf
        self._recorded_ms: float | None = None
        self._last_record_step = 0
        # Metric handles, registered at the first observation (no empty
        # series from a step that is built but never driven).
        self._gauges: dict[str, Any] | None = None

    # -- wiring -------------------------------------------------------------
    def wrap_batches(self, batches: Iterator[Any]) -> Iterator[Any]:
        """Wrap the train loop's batch iterator so host time blocked in
        ``next()`` is attributed to ``data_wait``."""
        if not self.enabled:
            return batches

        def timed() -> Iterator[Any]:
            while True:
                t0 = self._clock()
                try:
                    batch = next(batches)
                except StopIteration:
                    return
                self._pending_data_s += self._clock() - t0
                yield batch

        return timed()

    def set_workload(self, global_batch: int | None,
                     seq: int | None) -> None:
        """Size the flops / communication model once the batch shapes are
        known (the first dispatch). None/None keeps the phases and
        disables the flops-derived outputs. Idempotent."""
        if self._sized:
            return
        self._sized = True
        self.global_batch = int(global_batch) if global_batch else None
        self.seq = int(seq) if seq else None
        if self.plan is None and self._mesh is not None:
            self.plan = plan_lib.plan_from_mesh(
                self._mesh, microbatches=self._microbatches)
        if self.plan is not None:
            self._num_devices = max(self.plan.num_devices, 1)
        if self.cfg is not None and self.global_batch and self.seq:
            self._flops = model_flops_per_step(
                self.cfg, self.global_batch, self.seq)
        if self.plan is not None and self._flops is not None:
            est = plan_lib.estimate_phases(
                self.plan, self.cfg,
                global_batch=self.global_batch, seq=self.seq)
            total = est["compute"] + est["collective"]
            self._comm_share = (
                est["collective"] / total if total > 0 else 0.0)
            self._comm_bytes = dict(est["comm_bytes"])
        if self._peak_flops is None:
            self._peak_flops = (0.0 if self._device is None
                                else peak_flops_per_chip(self._device))

    # -- the per-dispatch hooks (driven by _instrumented) -------------------
    def step_begin(self, batch_shape=None) -> None:
        """Called at the top of every instrumented dispatch. The interval
        since the previous ``step_begin`` is the completed step's wall: it
        holds that step's dispatch, the caller's readback fence and the
        next batch's fetch."""
        if not self.enabled:
            return
        now = self._clock()
        if not self._sized and self._size_from_shapes:
            if self._tokens_workload and batch_shape is not None \
                    and len(batch_shape) >= 2:
                # tokens are [B, T+1]; the training sequence is T.
                self.set_workload(batch_shape[0],
                                  max(batch_shape[1] - 1, 1))
            elif not self._tokens_workload:
                self.set_workload(None, None)
        self._begins += 1
        last = self._last_begin
        self._last_begin = now
        # A step whose dispatch recorded no begin mark has no device gap.
        if self._pending and self._pending[-1].begin is None:
            self._finish(self._pending.pop())
        self._poll()
        end, self._last_end = self._last_end, None
        if self._begins <= 2 or last is None:
            # Nothing precedes the first dispatch, and the first
            # dispatch's own interval (ending at the second begin) holds
            # its one-off costs: neither is a step.
            self._pending_data_s = 0.0
            self._read_io_baseline()
            return
        draft = self._draft((now - last) * 1000.0)
        if draft is None:
            return
        if end is None:
            self._finish(draft)
            return
        draft.end = end
        if len(self._pending) >= _MAX_PENDING:
            # The device lags too far: the oldest step keeps its
            # dispatch time, and its events go back to the ring.
            self._finish(self._pending.popleft())
        self._pending.append(draft)

    def step_end(self, dispatch_s: float) -> None:
        """Called as each dispatch returns, with its measured host cost;
        publishes the steps whose device-clock marks have completed, and
        writes the calibration record that an observation found due,
        while the device runs the step just queued."""
        self._dispatch_s = dispatch_s
        self._poll()
        if self._record_due:
            self._record_due = False
            self._maybe_record()

    # -- the device clock ---------------------------------------------------
    def mark_begin(self) -> None:
        """Record the step's begin mark on the current stream, before its
        first launch: the gap since the previous step's end mark is the
        previous observation's ``host`` phase."""
        if not self.enabled or self._events is None:
            return
        if len(self._ring) < _EVENT_RING:
            self._ring.append([self._events(), self._events()])
        pair = self._ring[self._ring_next]
        self._ring_next = (self._ring_next + 1) % _EVENT_RING
        pair[0].record()
        self._marks = pair
        if self._pending and self._pending[-1].begin is None:
            self._pending[-1].begin = pair[0]

    def mark_end(self) -> None:
        """Record the step's end mark on the current stream, after its
        last launch."""
        if self._marks is None:
            return
        self._marks[1].record()
        self._last_end, self._marks = self._marks[1], None

    def _poll(self) -> None:
        """Publish the waiting steps, oldest first, whose begin mark (and
        so the end mark before it, on the same stream) has completed."""
        while self._pending:
            draft = self._pending[0]
            if draft.begin is None or not draft.begin.query():
                return
            self._pending.popleft()
            self._finish(draft, draft.end.elapsed_time(draft.begin))

    # -- accounting ---------------------------------------------------------
    def _io_sum(self, name: str) -> float:
        h = self._reg().peek(name)
        if h is None or not hasattr(h, "snapshot"):
            return 0.0
        return float(h.snapshot().get("sum", 0.0))

    def _read_io_baseline(self) -> None:
        self._io_wait_ms = self._io_sum(_IO_BATCH_WAIT_HISTOGRAM)
        self._io_h2d_ms = self._io_sum(_IO_H2D_HISTOGRAM)

    def _draft(self, call_wall_ms: float) -> _Draft | None:
        """The completed interval's wall and input side, read now; its
        ``host`` phase may wait on the device clock."""
        if call_wall_ms <= 0:
            return None
        wall = call_wall_ms / self.steps_per_call
        data_s = self._pending_data_s
        self._pending_data_s = 0.0
        io_wait = self._io_sum(_IO_BATCH_WAIT_HISTOGRAM)
        io_h2d = self._io_sum(_IO_H2D_HISTOGRAM)
        d_wait = max(io_wait - (self._io_wait_ms or 0.0), 0.0)
        d_h2d = max(io_h2d - (self._io_h2d_ms or 0.0), 0.0)
        self._io_wait_ms, self._io_h2d_ms = io_wait, io_h2d
        per = 1.0 / self.steps_per_call
        # The iterator wait and the reader's batch_wait histogram overlap
        # (a blocked next() is reader wait when the data plane feeds it):
        # take the larger, never the sum.
        data_wait = min(max(data_s * 1000.0 * per, d_wait * per), wall)
        h2d = min(d_h2d * per, wall - data_wait)
        return _Draft(wall, data_wait, h2d, self._dispatch_s * 1000.0 * per)

    def _finish(self, d: _Draft, gap_ms: float | None = None) -> None:
        """Publish an observed step: ``host`` is the device clock's gap
        less the input side already counted, or without a gap the
        dispatch time; capped so the five phases sum to the wall."""
        wall, data_wait, h2d = d.wall, d.data_wait, d.h2d
        if gap_ms is None:
            host = d.dispatch
        else:
            host = max(gap_ms / self.steps_per_call - data_wait - h2d, 0.0)
        host = min(host, wall - data_wait - h2d)
        device = wall - data_wait - h2d - host
        collective = device * self._comm_share
        compute = device - collective
        self.steps_observed += self.steps_per_call
        self._publish(wall, {
            "data_wait": data_wait, "h2d": h2d, "compute": compute,
            "collective": collective, "host": host,
        })
        if wall < self._best_wall_ms:
            self._best_wall_ms = wall
        # Tried on every observation, not only on a new best: the best wall
        # often lands inside the first three steps, and a steady loop would
        # never record. _maybe_record's guards keep it to one write per
        # real improvement per window; step_end runs it.
        self._record_due = True

    # -- publishing ---------------------------------------------------------
    def _reg(self):
        if self._registry is None:
            self._registry = obs_metrics.default_registry()
        return self._registry

    def _handles(self) -> dict[str, Any]:
        if self._gauges is None:
            reg = self._reg()
            handles: dict[str, Any] = {
                p: reg.gauge(STEP_PHASE_GAUGE, labels={"phase": p})
                for p in PHASES
            }
            if self._flops:
                # Only flops-modeled workloads register the MFU family,
                # and tony_mfu only against a known peak.
                handles["flops"] = reg.gauge(MODEL_FLOPS_GAUGE)
                if self._peak_flops:
                    handles["mfu"] = reg.gauge(MFU_GAUGE)
            handles["bytes"] = {
                axis: reg.counter(COLLECTIVE_BYTES_COUNTER,
                                  labels={"axis": axis})
                for axis, v in self._comm_bytes.items() if v > 0
            }
            self._gauges = handles
        return self._gauges

    def _publish(self, wall_ms: float, phases: Mapping[str, float]) -> None:
        h = self._handles()
        for phase in PHASES:
            h[phase].set(round(phases[phase], 3))
        if self._flops and "flops" in h:
            h["flops"].set(self._flops)
            if "mfu" in h:
                mfu = self._flops / (
                    wall_ms / 1000.0 * self._num_devices * self._peak_flops
                )
                self.mfu = mfu
                h["mfu"].set(round(mfu, 5))
        for axis, counter in h["bytes"].items():
            counter.inc(self._comm_bytes[axis] * self.steps_per_call)
        # step_time_ms through report(): the gauge a train loop would set,
        # and report() drives the throttled snapshot publish.
        self._reg().report(step_time_ms=round(wall_ms, 3))

    # -- live calibration ---------------------------------------------------
    def _maybe_record(self) -> None:
        """Feed the best observed wall into the planner's measurement table
        and the autotune record's ``live_best_ms``, and publish the plan's
        residual: at most once per ``window`` steps, after three
        observations, for a real improvement."""
        if not self.calibrate or self.cfg is None:
            return
        if self.steps_observed < 3:
            return
        if self.steps_observed - self._last_record_step < self.window \
                and self._recorded_ms is not None:
            return
        if self._recorded_ms is not None \
                and self._best_wall_ms > self._recorded_ms * 0.99:
            return
        try:
            from tony_tpu_torch.parallel import autotune as autotune_lib

            if self.plan is not None:
                plan_lib.record_step_time(
                    self.plan, self.cfg, self._best_wall_ms,
                    global_batch=self.global_batch, seq=self.seq,
                )
            autotune_lib.note_step_time(
                "lm_train_step", config=self.cfg, mesh=self._mesh,
                step_ms=self._best_wall_ms,
            )
            self._recorded_ms = self._best_wall_ms
            self._last_record_step = self.steps_observed
            if self.plan is not None:
                residuals = plan_lib.calibration_residuals(
                    self.cfg, self._num_devices,
                    num_slices=getattr(self.plan, "num_slices", 1),
                    global_batch=self.global_batch, seq=self.seq,
                )
                r = residuals.get(self.plan.key())
                if r is not None:
                    self._reg().gauge(
                        PLAN_RESIDUAL_GAUGE,
                        labels={"plan": self.plan.key()},
                    ).set(round(r, 4))
        except Exception:
            # Calibration is telemetry: an unwritable cache dir or a config
            # the planner cannot digest must never touch training.
            pass
