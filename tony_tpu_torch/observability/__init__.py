"""The port's telemetry producers: the metrics registry (``metrics``;
``observability.report(step=i, loss=l)`` is the train-loop API, and in a
tony-launched process the snapshot publishes to ``$TONY_METRICS_FILE`` for
the executor's heartbeat) and the per-step anatomy (``stepstats``: the
phase breakdown and live MFU of every instrumented train step). The
readers stay in the orchestrator."""

from tony_tpu_torch.observability.metrics import (
    MetricsRegistry,
    default_registry,
    report,
)
from tony_tpu_torch.observability.stepstats import StepStats

__all__ = ["MetricsRegistry", "StepStats", "default_registry", "report"]
