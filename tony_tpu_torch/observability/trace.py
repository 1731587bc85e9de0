"""Distributed trace spans: the port's copy of the JAX package's
``observability/trace.py``, so the port imports nothing of it.

One trace id per job, minted by the coordinator and propagated two ways:

* ``TONY_TRACE_ID`` in every task's launch env (coordinator -> executor ->
  user process, riding the same env contract as the task identity);
* RPC metadata: every framed request carries a ``trace`` field, which a
  server records via ``note_rpc_trace`` so handlers can stamp events with
  the caller's id.

Each process records spans into its own ``Tracer``; user processes flush
theirs to ``$TONY_LOG_DIR/trace-*.jsonl`` (one Chrome trace event per line),
and the coordinator merges every file with its own spans into one
``trace.json`` per job at stop, loadable in ``chrome://tracing`` or
Perfetto. The file names, the event format and the merge are the JAX
package's, so the coordinator merges a port process's spans as it merges a
JAX process's, and either package's ``merge_job_trace`` reads the other's
files. ``parse_jsonl`` is the copy of the events module's lenient reader
that ``read_trace_jsonl`` needs.

The locks are plain ``threading.Lock``s: what the JAX package's
``sync_sanitizer.make_lock`` returns when its lock-order sanitizer is off.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import json
import logging
import os
import threading
import time
import uuid
from pathlib import Path
from typing import Any

from tony_tpu_torch import constants

log = logging.getLogger(__name__)

TRACE_ID_ENV = "TONY_TRACE_ID"

# The trace id presented by the current RPC request (server side).
_rpc_trace: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "tony_rpc_trace", default=None
)


def note_rpc_trace(trace_id: str | None) -> None:
    """Record the caller's trace id for the duration of this dispatch."""
    _rpc_trace.set(trace_id)


def current_rpc_trace() -> str | None:
    return _rpc_trace.get()


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def ambient_trace_id() -> str | None:
    """The trace id this process was launched under, if any."""
    return os.environ.get(TRACE_ID_ENV) or None


def parse_jsonl(text: str) -> list[dict[str, Any]]:
    """Lenient JSON-lines parser: malformed lines are skipped (a torn tail
    from a crashed writer must not hide the rest of the timeline)."""
    events = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
        except ValueError:
            continue
        if isinstance(event, dict):
            events.append(event)
    return events


class Span:
    """One open interval. ``end()`` is idempotent; attributes land in the
    Chrome event's ``args``."""

    def __init__(self, tracer: "Tracer", name: str, attrs: dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.start_us = int(time.time() * 1e6)
        self._done = False

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        self._tracer._record(self)


class Tracer:
    """Per-process span recorder in Chrome trace-event form.

    ``proc`` names the lane ("executor:worker:0", "user:worker:0", ...); it
    becomes the event's ``args.proc`` and a ``process_name`` metadata row
    so Perfetto labels the track."""

    def __init__(
        self, trace_id: str | None = None, proc: str = "",
    ) -> None:
        self.trace_id = trace_id or ambient_trace_id() or new_trace_id()
        self.proc = proc or f"proc-{os.getpid()}"
        self._events: list[dict[str, Any]] = []
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------
    def begin(self, name: str, **attrs: Any) -> Span:
        return Span(self, name, attrs)

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any):
        s = self.begin(name, **attrs)
        try:
            yield s
        finally:
            s.end()

    def _record(self, span: Span) -> None:
        now_us = int(time.time() * 1e6)
        with self._lock:
            self._events.append({
                "name": span.name, "ph": "X",
                "ts": span.start_us,
                "dur": max(now_us - span.start_us, 1),
                "pid": os.getpid(), "tid": threading.get_ident() % 100000,
                "args": {"trace_id": self.trace_id, "proc": self.proc,
                         **span.attrs},
            })

    # -- export ------------------------------------------------------------
    def to_chrome_events(self) -> list[dict[str, Any]]:
        with self._lock:
            events = list(self._events)
        if events:
            events.insert(0, {
                "name": "process_name", "ph": "M", "pid": os.getpid(),
                "args": {"name": self.proc},
            })
        return events

    def write_jsonl(self, path: str | os.PathLike[str]) -> None:
        """One event per line: mergeable by the coordinator even when this
        process died before writing a well-formed JSON document."""
        try:
            with open(path, "w") as f:
                for event in self.to_chrome_events():
                    f.write(json.dumps(event) + "\n")
        except OSError:
            log.warning("could not write trace to %s", path, exc_info=True)


def read_trace_jsonl(path: str | os.PathLike[str]) -> list[dict[str, Any]]:
    """Lenient per-line reader (torn tails skipped: a SIGKILLed writer
    must not hide the other processes' spans)."""
    try:
        return parse_jsonl(Path(path).read_text())
    except OSError:
        return []


def merge_job_trace(
    tracer: Tracer, logs_dir: str | os.PathLike[str] | None,
) -> dict[str, Any]:
    """The per-job Chrome trace document: ``tracer``'s spans plus every
    ``trace-*.jsonl`` that executors and user processes left in the logs
    dir."""
    events = tracer.to_chrome_events()
    if logs_dir is not None:
        root = Path(logs_dir)
        if root.is_dir():
            for path in sorted(root.glob("trace-*.jsonl")):
                events.extend(read_trace_jsonl(path))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"trace_id": tracer.trace_id},
    }


_default_tracer: Tracer | None = None
_default_lock = threading.Lock()


def default_tracer() -> Tracer:
    """The user-process tracer: trace id from TONY_TRACE_ID, spans flushed
    to the job scratch dir (``$TONY_LOG_DIR/trace-user-<job>-<idx>-
    s<session>.jsonl``, the JAX package's name) at interpreter exit so the
    coordinator's merge picks them up."""
    global _default_tracer
    with _default_lock:
        if _default_tracer is None:
            job = os.environ.get(constants.JOB_NAME, "")
            idx = os.environ.get(constants.TASK_INDEX, "")
            proc = f"user:{job}:{idx}" if job else f"user-{os.getpid()}"
            _default_tracer = Tracer(proc=proc)
            log_dir = os.environ.get(constants.TONY_LOG_DIR)
            if log_dir:
                # Session id in the name: the scratch dir is shared across
                # session retries, and each session's spans must survive
                # into the merged job trace.
                session = os.environ.get(constants.SESSION_ID, "0")
                suffix = (
                    f"{job}-{idx}-s{session}" if job else str(os.getpid())
                )
                path = Path(log_dir) / f"trace-user-{suffix}.jsonl"
                tracer = _default_tracer
                atexit.register(
                    lambda: tracer.write_jsonl(path)
                    if tracer._events else None
                )
        return _default_tracer


def span(name: str, **attrs: Any):
    """Module-level convenience: ``with observability.span("load"): ...``."""
    return default_tracer().span(name, **attrs)
