"""Continuous-batching LM serving on the card: ``ServingEngine`` (host
scheduler), ``serving.engine`` (device calls) and ``serving.http``
(``ServingServer``)."""

from tony_tpu_torch.serving.scheduler import (
    ServingEngine,
    ServingQueueFull,
    ServingRequest,
)

__all__ = ["ServingEngine", "ServingQueueFull", "ServingRequest"]
