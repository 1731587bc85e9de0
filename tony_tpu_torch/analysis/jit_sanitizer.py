"""Runtime jit sanitizer: the port's copy of the JAX package's
``analysis/jit_sanitizer.py``.

With ``TONY_JIT_SANITIZER`` set (``1``, ``report`` or ``strict``) every
callable wrapped by ``parallel.plan.instrument_jit`` reports each dispatch
here with a digest of its arguments' shapes and dtypes, and the tracker
classifies it:

* **cold**: the first signature a wrapper key dispatches; its cost is
  accounted by ``tony_compile_cache_*`` (kernel load, CUDA context,
  library handles). Not a retrace.
* **hit**: a signature seen before; nothing recorded.
* **retrace**: a new signature after the cold one. In the JAX package this
  is a silent recompile; in the port it is a step whose argument shapes
  keep changing (new allocator sizes, new kernel grids). Counted into
  ``tony_retraces_total`` (never into the compile-cache miss counter) and
  recorded with the dispatch stack. Past the budget
  (``TONY_JIT_RETRACE_BUDGET``, default 4 per key) the violation is
  flagged ``over_budget``; with ``TONY_JIT_SANITIZER=strict`` the dispatch
  raises ``RetraceBudgetExceeded``.

``step_region()`` arms ``torch.cuda.set_sync_debug_mode("error")`` where
JAX arms ``jax.transfer_guard_device_to_host("disallow")``: a synchronizing
CUDA operation inside the region (``.item()``, ``.cpu()`` of a device
tensor, a stream's ``synchronize()``, a blocking copy between host and
device) raises, and is recorded and counted into
``tony_guarded_transfers_total``. The mode does not flag a device-wide
``torch.cuda.synchronize()`` or an event's ``synchronize()``, as JAX's
guard does not flag ``block_until_ready``: no data crosses to the host. PyTorch has no explicit-transfer rule to
match ``jax.device_get``: an annotated readback inside a region runs under
``explicit_fence()``, which lowers the mode for its own body. The mode is
process-global, not per thread: a region restores the mode it found, and
is held only around a dispatch on the thread that issues it (the serving
engine's loop thread), never across a server's request threads.

Off (the default) everything passes straight through. The report has the
flight recorder's envelope: ``dump()`` writes a
``blackbox-jit-sanitizer-<pid>.json``; with ``TONY_JIT_REPORT_DIR`` set an
armed process dumps its violations at exit. Only the standard library at
import time; torch and the metrics registry are imported where they are
used.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import traceback
from contextlib import contextmanager

from tony_tpu_torch import constants

ENV_FLAG = constants.TONY_JIT_SANITIZER
ENV_RETRACE_BUDGET = constants.TONY_JIT_RETRACE_BUDGET
ENV_REPORT_DIR = constants.TONY_JIT_REPORT_DIR

RETRACE = "retrace"
GUARDED_TRANSFER = "guarded_transfer"

# Metric names (registered lazily: importing this module never touches the
# registry).
RETRACES_COUNTER = "tony_retraces_total"
GUARDED_TRANSFERS_COUNTER = "tony_guarded_transfers_total"

_TRUTHY = ("1", "true", "yes", "on", "report", "strict")
_DEFAULT_BUDGET = 4

# torch.cuda's sync debug modes: 0 off, 1 warn, 2 error.
_SYNC_OFF, _SYNC_ERROR = 0, 2
# What PyTorch's error says of a synchronizing operation.
_SYNC_MESSAGE = "synchronizing cuda operation"

# Frames from this file are noise in a violation stack.
_SELF_FILE = __file__


class RetraceBudgetExceeded(RuntimeError):
    """Raised in strict mode when one wrapper key re-traces past its
    budget: the step's arguments keep changing in steady state."""


def enabled() -> bool:
    """Opt-in check, read per dispatch (not at import) so a test can flip
    it first."""
    return os.environ.get(ENV_FLAG, "").strip().lower() in _TRUTHY


def strict() -> bool:
    return os.environ.get(ENV_FLAG, "").strip().lower() == "strict"


def retrace_budget() -> int:
    try:
        return int(os.environ.get(ENV_RETRACE_BUDGET, "")
                   or _DEFAULT_BUDGET)
    except ValueError:
        return _DEFAULT_BUDGET


def _site_stack(limit: int = 16) -> list[str]:
    """Compact dispatch stack: ``file:line in func`` strings, newest last,
    sanitizer frames stripped."""
    out = []
    for frame in traceback.extract_stack()[:-1]:
        if frame.filename == _SELF_FILE:
            continue
        out.append(f"{frame.filename}:{frame.lineno} in {frame.name}")
    return out[-limit:]


def _count(name: str) -> None:
    """Lazy registry increment; never lets observability break a
    dispatch."""
    try:
        from tony_tpu_torch import observability

        observability.default_registry().counter(name).inc()
    except Exception:
        pass


class JitTracker:
    """Per-key signature table and violation ring. One process-global
    instance backs ``instrument_jit``; tests make private ones."""

    def __init__(self, budget: "int | None" = None,
                 limit: int = 512) -> None:
        self._mu = threading.Lock()
        self._budget = retrace_budget() if budget is None else int(budget)
        self._sigs: dict[str, set] = {}
        self._retraces: collections.Counter = collections.Counter()
        self._transfers = 0
        self._violations: collections.deque = collections.deque(
            maxlen=max(int(limit), 1)
        )
        self._seq = 0

    # -- recording ---------------------------------------------------------
    def note_call(self, key: str, sig: str) -> tuple[str, int, bool]:
        """Classify one dispatch: ``(status, retrace_count, over_budget)``
        where status is 'cold' | 'hit' | 'retrace'."""
        with self._mu:
            sigs = self._sigs.setdefault(key, set())
            if sig in sigs:
                return "hit", self._retraces[key], False
            cold = not sigs
            sigs.add(sig)
            if cold:
                return "cold", 0, False
            self._retraces[key] += 1
            count = self._retraces[key]
            over = count > self._budget
            self._record_locked({
                "kind": RETRACE,
                "key": key,
                "signature": sig,
                "count": count,
                "budget": self._budget,
                "over_budget": over,
                "detail": f"`{key}` re-traced (signature #{count + 1} "
                          f"for this wrapper): its arguments changed in "
                          f"what should be steady state",
                "stack": _site_stack(),
            })
            return "retrace", count, over

    def note_transfer(self, message: str,
                      key: "str | None" = None) -> None:
        with self._mu:
            self._transfers += 1
            self._record_locked({
                "kind": GUARDED_TRANSFER,
                "key": key,
                "detail": message.splitlines()[0] if message else
                          "synchronizing CUDA operation inside an "
                          "instrumented step region",
                "stack": _site_stack(),
            })

    def _record_locked(self, violation: dict) -> None:
        self._seq += 1
        violation["seq"] = self._seq
        violation["ts_ms"] = int(time.time() * 1000)
        violation["thread"] = threading.current_thread().name
        self._violations.append(violation)

    # -- reading -----------------------------------------------------------
    def mark(self) -> int:
        """Current violation sequence: pair with violations_since for
        per-test attribution."""
        with self._mu:
            return self._seq

    def violations(self, kind: "str | None" = None) -> list[dict]:
        with self._mu:
            out = list(self._violations)
        if kind is not None:
            out = [v for v in out if v["kind"] == kind]
        return out

    def violations_since(self, mark: int,
                         kind: "str | None" = None) -> list[dict]:
        return [v for v in self.violations(kind) if v["seq"] > mark]

    def retraces(self, key: "str | None" = None) -> int:
        with self._mu:
            if key is not None:
                return self._retraces[key]
            return sum(self._retraces.values())

    def transfers(self) -> int:
        with self._mu:
            return self._transfers

    def reset(self) -> None:
        with self._mu:
            self._sigs.clear()
            self._retraces.clear()
            self._transfers = 0
            self._violations.clear()
            self._seq = 0

    def report(self) -> dict:
        """The flight recorder's document shape."""
        with self._mu:
            return {
                "proc": "jit-sanitizer",
                "keys": sorted(self._sigs),
                "retraces": dict(self._retraces),
                "transfers": self._transfers,
                "budget": self._budget,
                "reports": [],
                "rpcs": [],
                "events": list(self._violations),
            }

    def dump(self, directory, reason: str = "jit-sanitizer") -> "str | None":
        """Atomic ``blackbox-jit-sanitizer-<pid>.json`` dump (tmp +
        rename); best-effort."""
        doc = self.report()
        doc["reason"] = reason
        doc["dumped_ts_ms"] = int(time.time() * 1000)
        fname = f"blackbox-jit-sanitizer-{os.getpid()}.json"
        path = os.path.join(str(directory), fname)
        try:
            os.makedirs(str(directory), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(json.dumps(doc, indent=2, sort_keys=True) + "\n")
            os.replace(tmp, path)
            return path
        except OSError:
            return None


_default_tracker: "JitTracker | None" = None
_default_tracker_mu = threading.Lock()


def tracker() -> JitTracker:
    """The process-global tracker behind ``instrument_jit``."""
    global _default_tracker
    with _default_tracker_mu:
        if _default_tracker is None:
            _default_tracker = JitTracker()
        return _default_tracker


def note_dispatch(key: str, sig: str,
                  tracker_: "JitTracker | None" = None) -> str:
    """One instrumented dispatch: classify it, count a retrace into
    ``tony_retraces_total``, and in strict mode raise once the key's
    budget is blown. Returns the classification."""
    tr = tracker() if tracker_ is None else tracker_
    status, count, over = tr.note_call(key, sig)
    if status == "retrace":
        _count(RETRACES_COUNTER)
        if over and strict():
            raise RetraceBudgetExceeded(
                f"instrumented callable `{key}` re-traced {count} times "
                f"(budget {tr.report()['budget']}): its arguments keep "
                f"changing shape/dtype in steady state; pin the shapes or "
                f"raise {ENV_RETRACE_BUDGET}"
            )
    return status


def _get_sync_mode() -> "int | None":
    """CUDA's sync debug mode, or None where there is no CUDA."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_sync_debug_mode()


def _set_sync_mode(mode: int) -> None:
    import torch

    torch.cuda.set_sync_debug_mode(mode)


@contextmanager
def step_region(key: "str | None" = None,
                tracker_: "JitTracker | None" = None):
    """Arm CUDA's sync debug mode ("error") around a step region.

    Inside, a synchronizing CUDA operation raises with a stack and is
    recorded and counted into ``tony_guarded_transfers_total``; an
    annotated readback runs under ``explicit_fence()``. The region
    restores the mode it found. A no-op with the sanitizer off and where
    there is no CUDA, so hot paths wrap their dispatches
    unconditionally."""
    if not enabled():
        yield
        return
    previous = _get_sync_mode()
    if previous is None:
        yield
        return
    _set_sync_mode(_SYNC_ERROR)
    try:
        yield
    except Exception as exc:
        message = str(exc)
        if _SYNC_MESSAGE in message.lower():
            tr = tracker() if tracker_ is None else tracker_
            tr.note_transfer(message, key=key)
            _count(GUARDED_TRANSFERS_COUNTER)
        raise
    finally:
        _set_sync_mode(previous)


@contextmanager
def explicit_fence():
    """An annotated readback inside a step region (the per-window token
    readback of the serving engine, a KV export): the sync debug mode is
    lowered to off for the body and restored after it, as
    ``jax.device_get`` passes JAX's transfer guard. A no-op outside a
    region."""
    previous = _get_sync_mode() if enabled() else None
    if not previous:
        yield
        return
    _set_sync_mode(_SYNC_OFF)
    try:
        yield
    finally:
        _set_sync_mode(previous)


def _atexit_dump() -> None:  # pragma: no cover - process teardown
    report_dir = os.environ.get(ENV_REPORT_DIR)
    if not report_dir or _default_tracker is None:
        return
    if _default_tracker.violations():
        _default_tracker.dump(report_dir, reason="atexit")


if enabled() and os.environ.get(ENV_REPORT_DIR):  # pragma: no cover
    import atexit

    atexit.register(_atexit_dump)
