"""On-demand distributed profiling and the continuous HBM monitor: the port's
counterpart of the JAX package's ``observability/profiling.py``, with its
public names, file names, summary keys and gauge keys, and ``torch.cuda``
inside.

* **Continuous device-memory telemetry.** ``start_device_memory_monitor``
  samples the card's allocator on a daemon thread into
  ``tony_device_hbm_bytes{device=,kind=}`` gauges in the default registry
  (``kind`` is ``bytes_in_use``, ``peak_bytes_in_use`` or ``bytes_limit``,
  as in the JAX package). ``bytes_in_use`` and ``peak_bytes_in_use`` are
  ``torch.cuda.memory_stats``' ``allocated_bytes.all.current`` and
  ``.peak``: the bytes held by live tensors. The caching allocator's
  reserved-but-free bytes are not counted as in use, so the gauge can read
  well below what ``nvidia-smi`` shows for the process. ``bytes_limit`` is
  the card's ``total_memory``. The snapshot rides the heartbeat piggyback
  like every other metric. ``runtime.initialize()`` starts the monitor when
  the executor exported ``TONY_PROFILE_HBM_INTERVAL_MS``.

* **On-demand capture.** The coordinator's ``ProfileBroker`` fans a capture
  request out on the heartbeat reply; the executor's ``ExecutorProfiler``
  runs ``run_capture`` on a background thread: a device-memory snapshot
  plus, in a process that has brought CUDA up, a ``torch.profiler`` trace
  of the window (CPU and CUDA activities, a Chrome trace under
  ``profile-trace-<task>-<req>/``). The summary is written atomically as
  ``profile-<task>-s<session>-<req>.json`` beside the task logs and ships
  back on the next heartbeat.

Which processes read the card: only one that has brought CUDA up itself
(``torch.cuda.is_initialized()``). A capture or monitor thread never
initializes CUDA: a supervisor process that never touched the card ships
the host snapshot (max RSS), as the JAX package's jax-free executor does. A
process that serves or trains on the card has CUDA up and reports
``"source": "cuda"``.

The profiler is one per process: Kineto keeps one session, and a second
``torch.profiler`` started on another thread silently ends the first one's
session. Every trace this package opens (``run_capture``,
``profiling.trace``, ``profiling.StepProfiler``) goes through
``start_trace``, which refuses a second while one is open, as
``jax.profiler.start_trace`` does, and is stopped on the thread that
started it (another thread's stop finds no session). The profiler's stop
synchronizes the card with ``torch.cuda.synchronize()``, which the jit
sanitizer's sync debug mode does not flag, so a capture thread may stop it
while the serving engine's loop thread holds a step region. The stop then
collects the trace with every Python thread of the process held: a
capture stalls the engine's loop for that time.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import sys
import threading
import time
from pathlib import Path
from typing import Any, Iterable, Mapping

log = logging.getLogger(__name__)

# Declared metric name: the continuous HBM gauge family.
HBM_GAUGE = "tony_device_hbm_bytes"

# memory_stats keys worth publishing, stats-key -> label value.
_HBM_KINDS = {
    "bytes_in_use": "bytes_in_use",
    "peak_bytes_in_use": "peak_bytes_in_use",
    "bytes_limit": "bytes_limit",
}

PROFILE_FILE_PREFIX = "profile-"
# Capture windows are bounded: a typo'd duration must not hold a trace open
# (and the profiler's buffers growing) for an hour.
MAX_DURATION_MS = 60_000
DEFAULT_DURATION_MS = 2_000


def clamp_duration_ms(duration_ms: Any,
                      default: int = DEFAULT_DURATION_MS) -> int:
    try:
        d = int(duration_ms)
    except (TypeError, ValueError):
        return default
    return max(1, min(d, MAX_DURATION_MS))


def _loaded_torch():
    """torch, but ONLY when this process already imported it AND brought
    CUDA up. The telemetry paths never import torch themselves, and never
    initialize CUDA from a capture or monitor thread: device state lives in
    the process that computes on the card, and a supervisor that never
    touched it has nothing to read."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
    except Exception:
        return None
    return torch


class _CudaDevice:
    """One card as a memory-stats source with the JAX device's surface
    (``id``, ``platform``, ``memory_stats()`` under JAX's keys)."""

    platform = "gpu"

    def __init__(self, torch, index: int) -> None:
        self._torch = torch
        self.id = index

    def memory_stats(self) -> dict[str, int]:
        cuda = self._torch.cuda
        # The allocator's counters: a host-side read, no synchronize.
        stats = cuda.memory_stats(self.id)
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(cuda.get_device_properties(self.id)
                               .total_memory),
        }


def _local_devices() -> list:
    """The cards this process drives, as memory-stats sources: its current
    device and every other card its allocator has used; [] unless CUDA is
    up in this process. The seam tests patch with fake devices."""
    torch = _loaded_torch()
    if torch is None:
        return []
    current = torch.cuda.current_device()
    return [
        _CudaDevice(torch, i) for i in range(torch.cuda.device_count())
        if i == current or torch.cuda.memory_stats(i).get(
            "allocated_bytes.all.peak", 0)
    ]


def capture_snapshot() -> dict[str, Any]:
    """Device-memory snapshot: per-card allocator stats when this process
    has CUDA up; otherwise a host fallback (max RSS), so the capture path
    always returns evidence."""
    snap: dict[str, Any] = {"ts_ms": int(time.time() * 1000)}
    devices = []
    try:
        for d in _local_devices():
            stats = None
            try:
                stats = d.memory_stats()
            except Exception:
                stats = None
            entry: dict[str, Any] = {
                "id": int(getattr(d, "id", len(devices))),
                "platform": str(getattr(d, "platform", "unknown")),
            }
            if isinstance(stats, Mapping):
                for key in _HBM_KINDS:
                    if key in stats:
                        entry[key] = int(stats[key])
            devices.append(entry)
    except Exception:
        devices = []
    if any(len(d) > 2 for d in devices):
        snap["source"] = "cuda"
        snap["devices"] = devices
    else:
        import resource

        usage = resource.getrusage(resource.RUSAGE_SELF)
        snap["source"] = "host"
        snap["devices"] = devices
        # ru_maxrss is KiB on Linux, bytes on macOS; normalize to bytes
        # assuming Linux (the deployment substrate).
        snap["host"] = {"max_rss_bytes": int(usage.ru_maxrss) * 1024}
    return snap


def user_process_hbm(metrics_snapshot: Mapping[str, Any] | None,
                     ) -> dict[str, float]:
    """The USER process's latest published ``tony_device_hbm_bytes``
    gauges, lifted out of a metrics snapshot (the file the executor already
    reads for the heartbeat piggyback): how a capture in a supervisor that
    never touches the card reports the card's memory."""
    if not isinstance(metrics_snapshot, Mapping):
        return {}
    gauges = metrics_snapshot.get("gauges")
    if not isinstance(gauges, Mapping):
        return {}
    out: dict[str, float] = {}
    for key, value in gauges.items():
        if str(key).startswith(HBM_GAUGE + "{"):
            try:
                out[str(key)] = float(value)
            except (TypeError, ValueError):
                continue
    return out


# -- the process's one profiler ---------------------------------------------

_trace_lock = threading.Lock()
_trace_owner: str | None = None
_trace_thread: int | None = None


def _activities(torch) -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_trace(owner: str):
    """Start this process's one ``torch.profiler`` session (CPU and, where
    there is CUDA, CUDA activities) and return it; raises RuntimeError when
    one is already open, through this module or on this thread. The
    session is stopped (``stop_trace``) on the thread that started it:
    Kineto's session belongs to that thread."""
    global _trace_owner, _trace_thread
    import torch

    with _trace_lock:
        if _trace_owner is not None:
            raise RuntimeError(
                f"a profiler trace is already active in this process "
                f"({_trace_owner}): only one may run at a time")
        if torch.autograd._profiler_enabled():
            raise RuntimeError("a profiler is already enabled on this "
                               "thread: only one may run at a time")
        prof = torch.profiler.profile(activities=_activities(torch))
        prof.start()
        _trace_owner = owner
        _trace_thread = threading.get_ident()
    return prof


def stop_trace(prof, out_dir: "str | os.PathLike[str]") -> Path:
    """Stop a session ``start_trace`` opened, on the thread that opened it,
    and write its Chrome trace into ``out_dir`` as
    ``<host>_<pid>.<ns>.pt.trace.json`` (the name TensorBoard's PyTorch
    profiler plugin reads)."""
    global _trace_owner
    if threading.get_ident() != _trace_thread:
        raise RuntimeError("stop the profiler trace on the thread that "
                           "started it")
    try:
        prof.stop()
    finally:
        with _trace_lock:
            _trace_owner = None
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / (f"{socket.gethostname()}_{os.getpid()}."
                  f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(str(path))
    return path


def run_capture(
    req_id: str,
    duration_ms: int,
    out_dir: "str | os.PathLike[str] | None",
    task_id: str,
    session_id: str = "0",
    metrics_source=None,
) -> dict[str, Any]:
    """Execute one capture request: a bounded ``torch.profiler`` trace of
    the window when this process has CUDA up, then the memory snapshot,
    the artifact written atomically into ``out_dir``. Returns the summary
    that rides the heartbeat back to the coordinator. ``metrics_source``
    (the executor's heartbeat metrics callable) contributes the user
    process's published device-HBM gauges."""
    duration_ms = clamp_duration_ms(duration_ms)
    summary: dict[str, Any] = {
        "req_id": str(req_id),
        "task": task_id,
        "ts_ms": int(time.time() * 1000),
        "duration_ms": duration_ms,
    }
    trace_dir = None
    traced = False
    if out_dir is not None:
        trace_dir = (Path(out_dir)
                     / f"profile-trace-{_safe(task_id)}-{_safe(req_id)}")
    try:
        if _loaded_torch() is not None and trace_dir is not None:
            trace_dir.mkdir(parents=True, exist_ok=True)
            prof = start_trace(f"capture {req_id}")
            try:
                time.sleep(duration_ms / 1000.0)
            finally:
                stop_trace(prof, trace_dir)
            traced = True
    except Exception as exc:
        # A profiler already active elsewhere in the process (or none on
        # this build): the memory snapshot below is still worth shipping.
        summary["trace_error"] = f"{type(exc).__name__}: {exc}"
    snap = capture_snapshot()
    if metrics_source is not None:
        try:
            hbm = user_process_hbm(metrics_source())
        except Exception:
            hbm = {}
        if hbm:
            snap["user_device_hbm_bytes"] = hbm
    summary["snapshot"] = snap
    summary["trace_dir"] = str(trace_dir) if traced else None
    if out_dir is not None:
        name = (f"{PROFILE_FILE_PREFIX}{_safe(task_id)}"
                f"-s{_safe(str(session_id))}-{_safe(req_id)}.json")
        try:
            out = Path(out_dir)
            out.mkdir(parents=True, exist_ok=True)
            tmp = out / f".{name}.tmp"
            tmp.write_text(json.dumps(summary, sort_keys=True) + "\n")
            os.replace(tmp, out / name)
            summary["artifact"] = name
        except OSError:
            log.warning("could not persist profile artifact", exc_info=True)
    return summary


def _safe(raw: str) -> str:
    return "".join(c if c.isalnum() or c in "._" else "_" for c in str(raw))


def find_profiles(*dirs: "str | os.PathLike[str] | None") -> list[Path]:
    """Every persisted ``profile-*.json`` artifact under the given dirs."""
    out: list[Path] = []
    for d in dirs:
        if d is None:
            continue
        root = Path(d)
        if not root.is_dir():
            continue
        out.extend(sorted(
            p for p in root.glob(f"{PROFILE_FILE_PREFIX}*.json")
            if p.is_file()
        ))
    return out


class ProfileBroker:
    """Coordinator-side fan-out state for one capture request at a time.

    ``start()`` arms a request for a set of task ids; ``command_for`` hands
    each task its command exactly once (piggybacked on the heartbeat
    REPLY); ``record_result`` collects the summaries the executors ship
    back. A new ``start`` supersedes an unfinished request: the operator
    asking again IS the retry path."""

    def __init__(self, clock_ms=None) -> None:
        self._clock_ms = clock_ms or (lambda: int(time.time() * 1000))
        self._lock = threading.Lock()
        self._req_id: str | None = None
        self._req_seq = 0
        self._duration_ms = DEFAULT_DURATION_MS
        self._started_ms: int | None = None
        # task -> "pending" | "delivered" | "captured" | "failed"
        self._state: dict[str, str] = {}
        self._summaries: dict[str, dict[str, Any]] = {}

    def start(self, tasks: Iterable[str],
              duration_ms: int | None = None) -> str:
        with self._lock:
            self._started_ms = self._clock_ms()
            # Sequence suffix: two start() calls in the same clock
            # millisecond must mint DISTINCT ids, or executors that served
            # the first request would dedupe the second away.
            self._req_seq += 1
            self._req_id = f"prof-{self._started_ms}-{self._req_seq}"
            self._duration_ms = clamp_duration_ms(
                duration_ms, DEFAULT_DURATION_MS
            )
            self._state = {t: "pending" for t in tasks}
            self._summaries = {}
            return self._req_id

    def command_for(self, task_id: str) -> dict[str, Any] | None:
        """The piggyback payload for one task's next heartbeat reply; None
        once delivered (or when no request is armed)."""
        with self._lock:
            if self._req_id is None:
                return None
            if self._state.get(task_id) != "pending":
                return None
            self._state[task_id] = "delivered"
            return {
                "profile": {
                    "req_id": self._req_id,
                    "duration_ms": self._duration_ms,
                }
            }

    def record_result(self, task_id: str,
                      summary: Mapping[str, Any] | None) -> "str | None":
        """Record one task's shipped summary; returns the state it was
        recorded under ("captured"/"failed") or None when the result was
        fenced as stale."""
        if not isinstance(summary, Mapping):
            return None
        with self._lock:
            if self._req_id is None or \
                    summary.get("req_id") != self._req_id:
                return None  # stale result from a superseded request
            # A summary without a snapshot is the executor saying the
            # capture DIED: it must read as failed, not as a success with
            # no evidence.
            state = (
                "captured" if isinstance(summary.get("snapshot"), Mapping)
                else "failed"
            )
            self._state[task_id] = state
            self._summaries[task_id] = dict(summary)
            return state

    _TERMINAL_STATES = ("captured", "failed")

    def status(self) -> dict[str, Any]:
        with self._lock:
            return {
                "req_id": self._req_id,
                "duration_ms": self._duration_ms,
                "started_ms": self._started_ms,
                # done = every task reached a terminal state (a FAILED
                # capture must not hang the CLI's poll forever).
                "done": bool(self._state) and all(
                    s in self._TERMINAL_STATES
                    for s in self._state.values()
                ),
                "tasks": {
                    t: {
                        "state": state,
                        "summary": self._summaries.get(t),
                    }
                    for t, state in sorted(self._state.items())
                },
            }


class ExecutorProfiler:
    """Executor-side capture agent: dedupes request ids, runs each capture
    on a daemon thread (a trace window must never delay a heartbeat), and
    hands the finished summary to exactly one heartbeat via
    ``take_result``."""

    def __init__(self, task_id: str,
                 out_dir: "str | os.PathLike[str] | None",
                 session_id: str = "0",
                 metrics_source=None) -> None:
        self.task_id = task_id
        self.out_dir = out_dir
        self.session_id = session_id
        # The heartbeat metrics callable: captures lift the user process's
        # published HBM gauges from it (see user_process_hbm).
        self.metrics_source = metrics_source
        self._lock = threading.Lock()
        self._seen: set[str] = set()
        self._latest_req: str | None = None
        self._pending: dict[str, Any] | None = None

    def handle_command(self, reply: Mapping[str, Any] | None) -> bool:
        """Inspect one heartbeat reply; start a capture when it carries a
        fresh profile command. Returns True when a capture started."""
        if not isinstance(reply, Mapping):
            return False
        cmd = reply.get("profile")
        if not isinstance(cmd, Mapping):
            return False
        req_id = str(cmd.get("req_id") or "")
        if not req_id:
            return False
        with self._lock:
            if req_id in self._seen:
                return False
            self._seen.add(req_id)
            self._latest_req = req_id
        duration_ms = clamp_duration_ms(cmd.get("duration_ms"))
        threading.Thread(
            target=self._capture, args=(req_id, duration_ms),
            name=f"profile-{req_id}", daemon=True,
        ).start()
        return True

    def _capture(self, req_id: str, duration_ms: int) -> None:
        try:
            summary = run_capture(
                req_id, duration_ms, self.out_dir, self.task_id,
                session_id=self.session_id,
                metrics_source=self.metrics_source,
            )
        except Exception:  # capture must never take the executor down
            log.warning("profile capture failed", exc_info=True)
            summary = {
                "req_id": req_id, "task": self.task_id,
                "ts_ms": int(time.time() * 1000), "error": "capture failed",
            }
        with self._lock:
            # A superseded long capture finishing late must not clobber the
            # CURRENT request's unshipped summary.
            if req_id == self._latest_req or self._pending is None:
                self._pending = summary

    def take_result(self) -> dict[str, Any] | None:
        """One-shot: the finished summary for the next heartbeat (then
        cleared)."""
        with self._lock:
            result, self._pending = self._pending, None
            return result


_hbm_monitor_started = False
_hbm_lock = threading.Lock()


def start_device_memory_monitor(
    registry=None, interval_s: float = 5.0,
) -> "threading.Thread | None":
    """Publish per-card HBM gauges continuously (daemon thread). No-op
    (returns None) unless this process has CUDA up; idempotent per
    process."""
    global _hbm_monitor_started
    try:
        devices = _local_devices()
    except Exception:
        return None
    if not devices:
        return None
    try:
        has_stats = isinstance(devices[0].memory_stats(), Mapping)
    except Exception:
        has_stats = False
    if not has_stats:
        return None
    with _hbm_lock:
        if _hbm_monitor_started:
            return None
        _hbm_monitor_started = True
    if registry is None:
        from tony_tpu_torch.observability.metrics import default_registry

        registry = default_registry()

    def sample() -> None:
        for d in devices:
            try:
                stats = d.memory_stats()
            except Exception:
                continue
            if not isinstance(stats, Mapping):
                continue
            for key, kind in _HBM_KINDS.items():
                if key in stats:
                    registry.gauge(
                        HBM_GAUGE, "per-device HBM usage",
                        labels={"device": str(getattr(d, "id", "?")),
                                "kind": kind},
                    ).set(float(stats[key]))

    def loop() -> None:
        while True:
            try:
                sample()
                registry.flush()
            except Exception:  # telemetry must never crash the trainer
                log.debug("hbm sample failed", exc_info=True)
            time.sleep(max(interval_s, 0.5))

    sample()  # first sample synchronously: gauges exist before step 1
    t = threading.Thread(target=loop, name="hbm-monitor", daemon=True)
    t.start()
    return t
