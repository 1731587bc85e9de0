"""Checkpointing as a staged pipeline — see ``checkpoint/manager.py``.

The port's copy of the JAX package's checkpoint package, in the same
layers: ``stores`` (step storage: local directories and gs:// prefixes), ``layout`` (the
completeness and differential-chain rules), ``differential`` (hash-per-leaf
diff planning), ``pipeline`` (the bounded snapshot -> persist worker
pipeline) and ``manager`` (``CheckpointManager``, ``FlushSignal``). The
on-disk format is the JAX manager's, byte for byte.
"""

from tony_tpu_torch.checkpoint.layout import (  # noqa: F401
    CKPT_COMMITTED_GAUGE,
    KIND_DIFF,
    KIND_FULL,
    LAYOUT_FORMAT,
)
from tony_tpu_torch.checkpoint.manager import (  # noqa: F401
    _MANIFEST,
    CheckpointManager,
    FlushSignal,
    _decode,
    _encode,
)
from tony_tpu_torch.checkpoint.stores import (  # noqa: F401
    _FsCheckpointStore,
    _ObjectCheckpointStore,
    _fsync_write,
    store_for,
)
