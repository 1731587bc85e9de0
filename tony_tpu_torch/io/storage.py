"""Storage dispatch for the data plane: sizes, byte ranges and line
streams of local files. The reader's byte-range split math is
storage-agnostic; ``gs://`` corpora (the orchestrator's object store) are
not ported yet and raise."""

from __future__ import annotations

import os

from tony_tpu_torch.checkpoint.stores import gs_not_ported, is_gs_uri

__all__ = ["file_size", "is_gs_uri", "local_path", "open_lines", "read_range"]


def local_path(path: str) -> str:
    """``path`` itself; raises for a gs:// URI."""
    if is_gs_uri(path):
        raise gs_not_ported(path)
    return path


def file_size(path: str) -> int:
    return os.path.getsize(local_path(path))


def read_range(path: str, offset: int, length: int) -> bytes:
    """``length`` bytes at ``offset``; short only at end of file."""
    if length <= 0:
        return b""
    with open(local_path(path), "rb") as f:
        f.seek(offset)
        return f.read(length)


def open_lines(path: str):
    """A seek/readline/tell file object over a local file."""
    return open(local_path(path), "rb")
