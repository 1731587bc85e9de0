"""Storage dispatch for the data plane: the reader's byte-range split math
is storage-agnostic, so the only difference between a local corpus and a
``gs://`` one is how sizes, ranges and line streams are fetched. The port's
copy of the JAX package's ``io/storage.py``.

Remote access goes through ``tony_tpu_torch.cloud.default_storage()``
(urllib in production, ``FileObjectStorage`` under
``TONY_GCS_EMULATOR_DIR``, fakes in tests). Stores without
``size``/``get_range`` fall back to whole-object reads: correct, just
unoptimized.
"""

from __future__ import annotations

import os
from typing import Any

from tony_tpu_torch.cloud.gcs import is_gs_uri

__all__ = ["RangeLineStream", "file_size", "is_gs_uri", "open_lines",
           "read_range"]


def _store():
    from tony_tpu_torch.cloud import default_storage

    return default_storage()


def file_size(path: str) -> int:
    if is_gs_uri(path):
        store = _store()
        if hasattr(store, "size"):
            return store.size(path)
        return len(store.get_bytes(path))
    return os.path.getsize(path)


def read_range(path: str, offset: int, length: int) -> bytes:
    """``length`` bytes at ``offset``; short only at end of object/file."""
    if length <= 0:
        return b""
    if is_gs_uri(path):
        store = _store()
        if hasattr(store, "get_range"):
            return store.get_range(path, offset, length)
        return store.get_bytes(path)[offset:offset + length]
    with open(path, "rb") as f:
        f.seek(offset)
        return f.read(length)


class RangeLineStream:
    """Minimal seek/readline/tell file object over ranged fetches, for the
    jsonl path (which needs line framing plus the split-brain boundary
    rules: seek one byte back, read the last owned record past the range
    end). Fetches ``CHUNK`` bytes per request; ``tell()`` reports the
    first unconsumed byte, matching buffered-file semantics."""

    CHUNK = 1 << 20

    def __init__(self, path: str, size: int | None = None) -> None:
        self._path = path
        self._size = file_size(path) if size is None else size
        self._cursor = 0
        # The buffer is consumed via an offset, never re-sliced: a per-line
        # copy of the remainder would be quadratic in CHUNK.
        self._buf = b""
        self._off = 0  # _buf[_off:] is unconsumed; _cursor points at it

    def seek(self, pos: int) -> None:
        self._cursor = pos
        self._buf = b""
        self._off = 0

    def tell(self) -> int:
        return self._cursor

    def readline(self) -> bytes:
        parts: list[bytes] = []
        while True:
            nl = self._buf.find(b"\n", self._off)
            if nl >= 0:
                parts.append(self._buf[self._off:nl + 1])
                self._cursor += nl + 1 - self._off
                self._off = nl + 1
                return b"".join(parts)
            tail = self._buf[self._off:]
            parts.append(tail)
            self._cursor += len(tail)
            self._buf = b""
            self._off = 0
            if self._cursor >= self._size:
                return b"".join(parts)
            n = min(self.CHUNK, self._size - self._cursor)
            self._buf = read_range(self._path, self._cursor, n)
            if not self._buf:  # object shrank underneath us
                return b"".join(parts)

    def __enter__(self) -> "RangeLineStream":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


def open_lines(path: str):
    """Context-managed seek/readline/tell stream over a local file or a
    gs:// object."""
    if is_gs_uri(path):
        return RangeLineStream(path)
    return open(path, "rb")
