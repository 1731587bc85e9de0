"""Data plane: sharded record readers feeding the port's input pipeline.

The port's copy of the JAX package's ``io``: N files are concatenated into
one byte range, split contiguously across M readers, each reader prefetches
on a background thread into a bounded buffer with an optional shuffle pool,
and consumers pull batches. ``device_prefetch`` carries them onto the card
from pinned memory on a side stream.
"""

from tony_tpu_torch.io.blocks import read_header, write_jsonl_blocks
from tony_tpu_torch.io.reader import (
    DevicePrefetcher,
    ShardedRecordReader,
    device_prefetch,
    sharded_batches,
)
from tony_tpu_torch.io.splits import (
    FileSegment,
    compute_read_split,
    create_read_info,
)

__all__ = [
    "compute_read_split",
    "create_read_info",
    "FileSegment",
    "ShardedRecordReader",
    "sharded_batches",
    "DevicePrefetcher",
    "device_prefetch",
    "write_jsonl_blocks",
    "read_header",
]
