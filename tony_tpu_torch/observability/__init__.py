"""The port's telemetry producers: the metrics registry (``metrics``;
``observability.report(step=i, loss=l)`` is the train-loop API, and in a
tony-launched process the snapshot publishes to ``$TONY_METRICS_FILE`` for
the executor's heartbeat), the per-step anatomy (``stepstats``: the phase
breakdown and live MFU of every instrumented train step), distributed
trace spans (``trace``: ``with observability.span("load_data"): ...``,
flushed to ``$TONY_LOG_DIR/trace-*.jsonl`` for the coordinator's job-trace
merge) and profiling (``profiling``: the on-demand capture and the
continuous per-card HBM gauge monitor). The readers stay in the
orchestrator."""

from tony_tpu_torch.observability.metrics import (
    MetricsRegistry,
    default_registry,
    report,
)
from tony_tpu_torch.observability.stepstats import StepStats
from tony_tpu_torch.observability.trace import Tracer, default_tracer, span

__all__ = ["MetricsRegistry", "StepStats", "Tracer", "default_registry",
           "default_tracer", "report", "span"]
