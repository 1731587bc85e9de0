"""Process-local metrics registry: the producer side of the JAX package's
``observability/metrics.py``, copied so the port imports nothing of it.

Counters, gauges and histograms with zero dependencies, a ``report()`` API
train loops call once per step, and a JSON snapshot the executor
piggybacks on its heartbeat. The snapshot format is the JAX package's, byte
for byte: the executor and the coordinator's aggregator, which stay in the
orchestrator, read what the port writes as they read what the JAX package
writes. The aggregator-side helpers (merging, Prometheus rendering,
quantiles) stay in the orchestrator and are not copied.

Metric names are validated at registration (snake_case, counters end
``_total``, time and size metrics carry a unit suffix).

Cross-process handoff: the user process (where the train loop runs) cannot
speak RPC, so a registry with a ``publish_path`` writes its snapshot
atomically to that file after each ``report()`` (throttled); the executor on
the same host reads the file and attaches the snapshot to its next
heartbeat. The default registry publishes to ``$TONY_METRICS_FILE`` when the
executor exported it.

The registry's locks are plain ``threading.Lock``s: what the JAX package's
``sync_sanitizer.make_lock`` returns when its lock-order sanitizer is off.
"""

from __future__ import annotations

import atexit
import json
import math
import os
import re
import threading
import time
from typing import Any, Iterable, Mapping

from tony_tpu_torch import constants

NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# Unit-suffix rules: a name that implies a dimension must carry its unit.
_TIME_HINT = re.compile(r"(?:^|_)(?:time|duration|latency)(?:_|$)")
_TIME_SUFFIXES = ("_ms", "_seconds", "_us")
_SIZE_HINT = re.compile(r"(?:^|_)(?:memory|size)(?:_|$)")
_SIZE_SUFFIXES = ("_bytes", "_mb", "_gb")

# Classic Prometheus default buckets (seconds-scale); callers measuring in
# other units pass their own.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


def validate_metric_name(name: str, kind: str) -> str | None:
    """The naming rules at runtime: returns the complaint, or None when
    legal."""
    if not NAME_RE.match(name):
        return f"metric name {name!r} is not snake_case"
    if kind == "counter" and not name.endswith("_total"):
        return f"counter {name!r} must end with `_total`"
    if _TIME_HINT.search(name) and not name.endswith(_TIME_SUFFIXES):
        return (
            f"time metric {name!r} must carry a unit suffix "
            f"({', '.join(_TIME_SUFFIXES)})"
        )
    if _SIZE_HINT.search(name) and not name.endswith(_SIZE_SUFFIXES):
        return (
            f"size metric {name!r} must carry a unit suffix "
            f"({', '.join(_SIZE_SUFFIXES)})"
        )
    return None


def _escape_label(value: str) -> str:
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labeled_key(name: str, labels: Mapping[str, str]) -> str:
    """Registry key for a labeled metric child: the Prometheus sample
    syntax itself (``name{a="b"}``), sorted for a canonical identity.
    Snapshots carry these keys verbatim."""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return f"{name}{{{inner}}}"


def split_labeled_key(key: str) -> tuple[str, str]:
    """(base_name, inline-label text), the inverse of ``_labeled_key``;
    plain names come back with empty labels."""
    base, sep, rest = key.partition("{")
    return (base, rest[:-1] if sep and rest.endswith("}") else "")


_LABEL_PAIR_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_labeled_key(key: str) -> tuple[str, dict[str, str]]:
    """(base_name, {label: value}): ``split_labeled_key`` with the
    inline-label text parsed into a dict."""
    base, inline = split_labeled_key(key)
    return base, {m.group(1): m.group(2)
                  for m in _LABEL_PAIR_RE.finditer(inline)}


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound; +Inf is implicit)."""

    kind = "histogram"

    def __init__(
        self, name: str, help: str = "",
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ) -> None:
        self.name = name
        self.help = help
        self.bounds = tuple(sorted(buckets))
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            if value > self._max:
                self._max = value
            for i, bound in enumerate(self.bounds):
                if value <= bound:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            cumulative = []
            running = 0
            for bound, n in zip(self.bounds, self._counts):
                running += n
                cumulative.append([bound, running])
            snap = {
                "count": self._count,
                "sum": self._sum,
                "buckets": cumulative,
            }
            if self._count:
                # The observed max rides along so quantile readouts can
                # clamp to it.
                snap["max"] = self._max
            return snap


class MetricsRegistry:
    """Thread-safe name -> metric registry with publish/snapshot plumbing.

    ``report(step=..., loss=..., step_time_ms=...)`` is the train-loop
    API: every keyword becomes a gauge; ``step`` additionally drives the
    ``train_steps_total`` counter (incremented by the step delta, so a
    resumed loop reports progress, not history).
    """

    def __init__(
        self,
        publish_path: str | os.PathLike[str] | None = None,
        publish_min_interval_s: float = 0.5,
    ) -> None:
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()
        # Guards report()'s step delta and the publish throttle; separate
        # from _lock because report() calls gauge()/counter() (which take
        # _lock) while holding it.
        self._report_lock = threading.Lock()
        self._publish_path = str(publish_path) if publish_path else None
        self._publish_min_interval_s = publish_min_interval_s
        self._last_publish = 0.0
        self._last_step: int | None = None
        if self._publish_path:
            atexit.register(self.flush)

    # -- registration ------------------------------------------------------
    def _get_or_register(self, cls, name: str, help: str,
                         labels: Mapping[str, str] | None = None, **kwargs):
        # Labeled children validate the BASE name and register under the
        # Prometheus sample key.
        complaint = validate_metric_name(name, cls.kind)
        if complaint:
            raise ValueError(complaint)
        key = _labeled_key(name, labels) if labels else name
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {key!r} already registered as "
                        f"{existing.kind}, not {cls.kind}"
                    )
                return existing
            metric = cls(key, help, **kwargs)
            self._metrics[key] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labels: Mapping[str, str] | None = None) -> Counter:
        return self._get_or_register(Counter, name, help, labels=labels)

    def gauge(self, name: str, help: str = "",
              labels: Mapping[str, str] | None = None) -> Gauge:
        return self._get_or_register(Gauge, name, help, labels=labels)

    def histogram(
        self, name: str, help: str = "",
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_register(Histogram, name, help, buckets=buckets)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def peek(self, name: str) -> Counter | Gauge | Histogram | None:
        """The registered metric under ``name`` (a labeled sample key is
        a name too), or None: read-side access that never registers."""
        with self._lock:
            return self._metrics.get(name)

    # -- the train-loop API ------------------------------------------------
    def report(self, step: int | None = None, **values: float) -> None:
        for name, value in values.items():
            self.gauge(name).set(float(value))
        if step is not None:
            step = int(step)
            self.gauge("train_step").set(step)
            with self._report_lock:
                delta = (step if self._last_step is None
                         else step - self._last_step)
                self._last_step = step
            if delta > 0:
                self.counter("train_steps_total").inc(delta)
        self._maybe_publish()

    # -- snapshot / publish ------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        """JSON-safe snapshot: the exact object that rides heartbeats."""
        counters: dict[str, float] = {}
        gauges: dict[str, float] = {}
        histograms: dict[str, Any] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, Counter):
                counters[m.name] = m.value
            elif isinstance(m, Gauge):
                gauges[m.name] = m.value
            else:
                histograms[m.name] = m.snapshot()
        return {
            "ts_ms": int(time.time() * 1000),
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
        }

    def _maybe_publish(self) -> None:
        if not self._publish_path:
            return
        now = time.monotonic()
        with self._report_lock:
            if now - self._last_publish < self._publish_min_interval_s:
                return
            self._last_publish = now
        self.flush()  # file I/O, outside the lock

    def flush(self) -> None:
        """Atomic snapshot write: the executor reading mid-write must see
        the previous complete snapshot, never a torn one."""
        if not self._publish_path:
            return
        try:
            data = json.dumps(self.snapshot())
            # Per-thread tmp: two racing flushes must tear neither the
            # published file (os.replace is atomic) nor each other's tmp.
            tmp = (f"{self._publish_path}.tmp.{os.getpid()}"
                   f".{threading.get_ident()}")
            with open(tmp, "w") as f:
                f.write(data)
            os.replace(tmp, self._publish_path)
        except OSError:
            pass  # scratch dir gone mid-teardown: telemetry is best-effort


_default_registry: MetricsRegistry | None = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry. In a tony-launched user process the
    executor exports TONY_METRICS_FILE, so snapshots auto-publish and ride
    heartbeats; anywhere else it is a plain in-memory registry."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry(
                publish_path=os.environ.get(constants.TONY_METRICS_FILE)
                or None
            )
        return _default_registry


def report(step: int | None = None, **values: float) -> None:
    """Module-level convenience: ``observability.report(step=i, loss=l)``."""
    default_registry().report(step=step, **values)
