"""The port's object store: ``gs://`` URIs for checkpoints and corpora.

``GcsStorage`` speaks the GCS REST surface through an injectable transport
(``transport.UrllibTransport`` in production); ``FileObjectStorage`` maps
``gs://bucket/key`` onto ``<root>/bucket/key``. ``default_storage()`` is the
process-wide store the checkpoint manager and the reader reach gs:// paths
through. It is the port's own singleton, separate from the JAX package's: a
process that drives both packages sets both.
"""

from __future__ import annotations

import os

from tony_tpu_torch import constants
from tony_tpu_torch.cloud.gcs import (
    FileObjectStorage,
    GcsError,
    GcsStorage,
    is_gs_uri,
    split_gs_uri,
)
from tony_tpu_torch.cloud.transport import UrllibTransport, default_token_provider

_default_storage: GcsStorage | FileObjectStorage | None = None


def default_storage() -> GcsStorage | FileObjectStorage:
    """The process-wide store for call sites that cannot take an injected
    client (the checkpoint manager's object store, the reader's ranged
    reads). ``set_default_storage`` swaps it; ``TONY_GCS_EMULATOR_DIR`` maps
    gs:// onto a local directory (executor subprocesses inherit it, so a
    whole job runs gs:// paths offline); otherwise the urllib client is
    built on first use."""
    global _default_storage
    if _default_storage is None:
        emulator = os.environ.get(constants.TONY_GCS_EMULATOR_DIR)
        _default_storage = (
            FileObjectStorage(emulator) if emulator else GcsStorage()
        )
    return _default_storage


def set_default_storage(storage: GcsStorage | FileObjectStorage | None
                        ) -> None:
    """Install ``storage`` as the process-wide store; None makes the next
    ``default_storage()`` build one from the environment again."""
    global _default_storage
    _default_storage = storage


__all__ = [
    "FileObjectStorage",
    "GcsError",
    "GcsStorage",
    "UrllibTransport",
    "default_storage",
    "default_token_provider",
    "is_gs_uri",
    "set_default_storage",
    "split_gs_uri",
]
