"""Byte-range split arithmetic (HdfsAvroFileSplitReader.java:285-297,
379-416): divide the concatenation of all input files into ``num_tasks``
contiguous, non-overlapping ranges that exactly cover the total, then map
each task's range back onto per-file (offset, length) segments."""

from __future__ import annotations

from dataclasses import dataclass


def compute_read_split(total_len: int, task_index: int, num_tasks: int) -> tuple[int, int]:
    """(start, length) of ``task_index``'s share of ``total_len`` bytes.
    Remainder bytes go one-each to the first ``total_len % num_tasks`` tasks,
    so lengths differ by at most 1 and the union is exact."""
    if num_tasks <= 0:
        raise ValueError(f"num_tasks must be positive, got {num_tasks}")
    if not 0 <= task_index < num_tasks:
        raise ValueError(f"task_index {task_index} out of range [0, {num_tasks})")
    base, extra = divmod(total_len, num_tasks)
    start = task_index * base + min(task_index, extra)
    length = base + (1 if task_index < extra else 0)
    return start, length


@dataclass(frozen=True)
class FileSegment:
    path: str
    offset: int
    length: int


def create_read_info(
    files: list[tuple[str, int]], task_index: int, num_tasks: int
) -> list[FileSegment]:
    """Map this task's global byte range onto per-file segments.
    ``files``: [(path, size_bytes)] in a deterministic order shared by all
    tasks (the reference sorts its listing for the same reason)."""
    total = sum(size for _, size in files)
    start, length = compute_read_split(total, task_index, num_tasks)
    end = start + length
    segments: list[FileSegment] = []
    pos = 0
    for path, size in files:
        file_start, file_end = pos, pos + size
        lo = max(start, file_start)
        hi = min(end, file_end)
        if lo < hi:
            segments.append(FileSegment(path, lo - file_start, hi - lo))
        pos = file_end
    return segments
