"""Sharded record reader with background prefetch, and the device
prefetcher that carries its batches onto the card.

The port's copy of the JAX package's ``io/reader.py``. Record semantics per
format:

  - ``jsonl``: newline-delimited records. A reader whose byte range starts
    mid-record skips forward to the next newline; the reader owning the
    record's first byte reads it to completion even past its range end —
    the classic split-brain rule (the reference does the same with Avro
    sync markers, HdfsAvroFileSplitReader.java:190-240), so every record is
    read exactly once across readers.
  - ``tokens``: fixed-size binary records of ``record_len`` values of
    ``dtype`` (the LM-training format: pre-tokenized sequences). Ranges are
    aligned down/up to record boundaries, which keeps every record whole.
  - ``jsonl-blocks``: gzip/zstd block-compressed jsonl containers
    (io/blocks.py — the Avro-container analogue: sync-marker framing so
    byte-range splits still work, header-embedded schema surfaced by
    ``schema_json`` without reading data). A reader owns every block
    whose sync marker starts in its range.

The fetcher thread decodes records into a bounded queue
(DataFetcher:176-282's bounded buffer); an optional shuffle pool trades
memory for sample decorrelation exactly like the reference's shuffle
buffer (:160-174).

The ``tokens`` format without shuffle is the byte-heavy path: span reads
(``chunk_records`` x 4 records per ``preadv``, byte-capped) are issued by a
small worker pool with a sliding in-flight window, consumed in submission
order, and batches are assembled by a rollover buffer (zero-copy when a
batch lies inside one chunk).

``device_prefetch`` / ``DevicePrefetcher`` move host->device copies onto a
background thread and a side CUDA stream from pinned memory, with ``depth``
batches in flight; ``sharded_batches`` wraps a tokens reader into full
batches on the device.

Tuning comes from ``TONY_IO_PREFETCH_DEPTH`` / ``TONY_IO_READ_WORKERS`` /
``TONY_IO_CHUNK_RECORDS`` (the executor exports ``tony.io.*`` conf as
those) unless given explicitly.

Metrics: every reader and prefetcher of the process feeds one
``tony_io_*`` family in the default registry, with the JAX package's names
and buckets: span reads (``tony_io_read_ms``, ``tony_io_bytes_read_total``),
rollover copies (``tony_io_assemble_ms``), the consumer's wait on the
fetcher (``tony_io_batch_wait_ms``, ``tony_io_prefetch_queue_depth``) and
on ``device_prefetch`` (``tony_io_queue_wait_ms``), and the device copies
(``tony_io_h2d_ms``, ``tony_io_h2d_bytes_total``,
``tony_io_h2d_inflight_depth``).

Storage: a local corpus is read span by span through the native library
(``io/native.py``: one ``pread`` a span, and a readahead hint for each span
before it is queued); a ``gs://`` corpus through ranged reads of
``cloud.default_storage()`` (``io/storage.py``).

Fault injection: a ``throttle_io`` entry of the job's ``TONY_FAULT_PLAN``
sleeps inside the batch iterator's ``next()`` (``resilience/faults.py``).
"""

from __future__ import annotations

import collections
import json
import os
import queue
import random
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np
import torch

from tony_tpu_torch import constants
from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.io import native
from tony_tpu_torch.io.splits import FileSegment, create_read_info
from tony_tpu_torch.io.storage import (file_size, is_gs_uri, open_lines,
                                         read_range)
from tony_tpu_torch.parallel.mesh import axis_coordinate, axis_size
from tony_tpu_torch.resilience.faults import io_faults_from_env

_SENTINEL = object()

# Millisecond-scale histogram buckets: reads and H2D transfers span ~0.1 ms
# (warm page cache) to seconds (cold remote storage).
_MS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
)

# Declared metric names: the tony_io_* family.
IO_BYTES_READ_COUNTER = "tony_io_bytes_read_total"
IO_READ_MS_HISTOGRAM = "tony_io_read_ms"
IO_ASSEMBLE_MS_HISTOGRAM = "tony_io_assemble_ms"
IO_BATCH_WAIT_MS_HISTOGRAM = "tony_io_batch_wait_ms"
IO_PREFETCH_QUEUE_DEPTH_GAUGE = "tony_io_prefetch_queue_depth"
IO_H2D_BYTES_COUNTER = "tony_io_h2d_bytes_total"
IO_H2D_MS_HISTOGRAM = "tony_io_h2d_ms"
IO_QUEUE_WAIT_MS_HISTOGRAM = "tony_io_queue_wait_ms"
IO_H2D_INFLIGHT_DEPTH_GAUGE = "tony_io_h2d_inflight_depth"


class _IoMetrics:
    """Lazy handles into the process's default registry. One shared
    instance per registry: readers and prefetchers all feed the same
    ``tony_io_*`` family. A reader or prefetcher made after the default
    registry was replaced takes handles into the new one."""

    _instance: "_IoMetrics | None" = None
    _lock = threading.Lock()

    def __init__(self, registry) -> None:
        self.registry = registry
        self.bytes_read = registry.counter(
            IO_BYTES_READ_COUNTER,
            "bytes fetched from storage by the sharded reader",
        )
        self.read_ms = registry.histogram(
            IO_READ_MS_HISTOGRAM,
            "wall time of one span read (pread)",
            buckets=_MS_BUCKETS,
        )
        self.assemble_ms = registry.histogram(
            IO_ASSEMBLE_MS_HISTOGRAM,
            "host-side batch-assembly copy time (rollover buffer)",
            buckets=_MS_BUCKETS,
        )
        self.batch_wait_ms = registry.histogram(
            IO_BATCH_WAIT_MS_HISTOGRAM,
            "consumer stall waiting on the reader's prefetch queue",
            buckets=_MS_BUCKETS,
        )
        self.queue_depth = registry.gauge(
            IO_PREFETCH_QUEUE_DEPTH_GAUGE,
            "chunks currently buffered between fetcher and consumer",
        )
        self.h2d_bytes = registry.counter(
            IO_H2D_BYTES_COUNTER,
            "bytes handed to the host->device copy by device_prefetch",
        )
        self.h2d_ms = registry.histogram(
            IO_H2D_MS_HISTOGRAM,
            "wall time of one host->device copy enqueue",
            buckets=_MS_BUCKETS,
        )
        self.queue_wait_ms = registry.histogram(
            IO_QUEUE_WAIT_MS_HISTOGRAM,
            "consumer stall per batch waiting on device_prefetch",
            buckets=_MS_BUCKETS,
        )
        self.h2d_depth = registry.gauge(
            IO_H2D_INFLIGHT_DEPTH_GAUGE,
            "device transfers currently in flight in device_prefetch",
        )

    @classmethod
    def get(cls) -> "_IoMetrics":
        from tony_tpu_torch.observability import default_registry

        registry = default_registry()
        with cls._lock:
            if cls._instance is None or cls._instance.registry is not registry:
                cls._instance = cls(registry)
            return cls._instance


class _Failure:
    """Producer-side exception in transit to the consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


def _env_int(name: str, default: int, floor: int = 1) -> int:
    try:
        return max(floor, int(os.environ.get(name, "") or default))
    except ValueError:
        return default


class ShardedRecordReader:
    def __init__(
        self,
        paths: list[str],
        task_index: int = 0,
        num_tasks: int = 1,
        *,
        fmt: str = "jsonl",
        dtype: Any = np.uint16,
        record_len: int | None = None,
        batch_size: int = 32,
        shuffle: bool = False,
        shuffle_pool: int = 1024,
        buffer_records: int = 4096,
        seed: int = 0,
        read_workers: int | None = None,
        chunk_records: int | None = None,
    ) -> None:
        if fmt not in ("jsonl", "tokens", "jsonl-blocks"):
            raise ValueError(f"unknown format {fmt!r}")
        if fmt == "tokens" and not record_len:
            raise ValueError("tokens format needs record_len")
        self.fmt = fmt
        self.task_index, self.num_tasks = task_index, num_tasks
        self.dtype = np.dtype(dtype)
        self.record_len = record_len
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.shuffle_pool = shuffle_pool
        self._rng = random.Random(seed + task_index)
        # Data-plane tuning: explicit args win (illegal values rejected,
        # matching the config_check ≥1 rule); otherwise the TONY_IO_* env
        # the executor exports from tony.io.* conf; otherwise the shipped
        # defaults.
        if chunk_records is not None and int(chunk_records) < 1:
            raise ValueError(f"chunk_records must be >= 1, got {chunk_records}")
        if read_workers is not None and int(read_workers) < 1:
            raise ValueError(f"read_workers must be >= 1, got {read_workers}")
        self.chunk_records = (
            int(chunk_records) if chunk_records is not None
            else _env_int(constants.TONY_IO_CHUNK_RECORDS,
                          self._CHUNK_RECORDS)
        )
        self.read_workers = (
            int(read_workers) if read_workers is not None
            else _env_int(constants.TONY_IO_READ_WORKERS,
                          self._READ_WORKERS)
        )
        self._metrics = _IoMetrics.get()

        files = [(str(p), file_size(str(p))) for p in sorted(paths)]
        self._sizes = dict(files)
        self.segments = create_read_info(files, task_index, num_tasks)
        if fmt == "tokens":
            self.segments = [self._align_tokens(s) for s in self.segments]
            self.segments = [s for s in self.segments if s.length > 0]

        # Chunk-granular streams carry ~chunk_records rows per queue item,
        # BYTE-CAPPED: a "record" may be a 147 KB image, and 256 of those
        # per queue item (38 MB) times a 16-deep queue would buffer more
        # than half a GB. Rows per chunk shrink so one item stays ≤
        # ~_CHUNK_BYTES_CAP; token-sized records are unaffected.
        maxsize = max(buffer_records, 1)
        if self.fmt == "tokens":
            # The byte cap applies to EVERY tokens read path (the shuffle
            # branch reads the same spans, it just copies rows out).
            self._chunk_rows = max(1, min(
                self.chunk_records,
                self._CHUNK_BYTES_CAP // self._record_bytes(),
            ))
            if not shuffle:
                # Bound the queue in BYTES too: byte-capped chunks shrink
                # rows-per-item, and a maxsize derived purely from
                # buffer_records // rows would grow the item count right
                # back to the half-GB blowup the chunk cap exists to
                # prevent. Peak host buffering ≈ _QUEUE_BYTES_CAP of
                # queued chunks PLUS the parallel-read window's in-flight
                # spans ((read_workers+2) × ≤4·_CHUNK_BYTES_CAP) — ~175 MB
                # worst case at the defaults, vs ~600 MB before.
                maxsize = max(maxsize // self._chunk_rows, 2)
                item_bytes = self._chunk_rows * self._record_bytes()
                maxsize = max(2, min(
                    maxsize, self._QUEUE_BYTES_CAP // item_bytes
                ))
        else:
            self._chunk_rows = self.chunk_records
        self._queue: queue.Queue = queue.Queue(maxsize=maxsize)
        # Rollover assembly state (_next_batch_from_chunks): the head
        # chunk plus a consumption offset replace the old pending list —
        # no per-batch np.concatenate of everything buffered.
        self._head: np.ndarray | None = None
        self._head_off = 0
        self._fds: dict[str, int] = {}
        self._fds_lock = threading.Lock()
        self._stop = threading.Event()
        self._fetch_exc: BaseException | None = None
        self._fetcher = threading.Thread(
            target=self._fetch_guarded, daemon=True
        )
        self._fetcher.start()

    # -- range alignment ----------------------------------------------------
    def _record_bytes(self) -> int:
        return self.record_len * self.dtype.itemsize

    def _align_tokens(self, seg: FileSegment) -> FileSegment:
        rb = self._record_bytes()
        # Owner-of-first-byte rule, record-granular: round the start UP to
        # the next boundary (a partial head belongs to the previous reader,
        # which rounds its own end up past it) and the end UP as well.
        start = -(-seg.offset // rb) * rb
        end = -(-(seg.offset + seg.length) // rb) * rb
        fsize = self._sizes[seg.path]
        end = min(end, fsize - fsize % rb)
        return FileSegment(seg.path, start, max(0, end - start))

    # -- fetcher thread ------------------------------------------------------
    @property
    def _chunk_granular(self) -> bool:
        """Tokens without shuffle move [n, record_len] chunks through the
        queue (256x fewer queue hops); shuffle needs single records."""
        return self.fmt == "tokens" and not self.shuffle

    def _fetch_guarded(self) -> None:
        """A fetcher-thread failure (unreadable file, bad container
        magic, IO error mid-read) must not read as a clean end-of-shard:
        the exception is captured and re-raised from the consumer's next
        ``next_batch`` — silent truncation would train on a partial
        corpus. The sentinel is enqueued HERE, strictly after the
        exception is recorded: were the loop to enqueue it first (in a
        finally), a consumer blocked in queue.get() could observe the
        sentinel before _fetch_exc is set and read the failure as a
        clean end of shard."""
        try:
            self._fetch_loop()
        except BaseException as exc:  # re-raised by the consumer
            self._fetch_exc = exc
        finally:
            self._close_fds()
            self._put(_SENTINEL)

    def _fetch_loop(self) -> None:
        # Termination contract: _fetch_guarded (the only caller) enqueues
        # the sentinel after this returns or raises — never from here, so
        # a failure can't surface the sentinel before its exception.
        if self._chunk_granular:
            self._fetch_chunks_parallel()
            return
        pool: list[Any] = []
        for rec in self._iter_records():
            if self._stop.is_set():
                return
            if self.shuffle:
                if len(pool) < self.shuffle_pool:
                    pool.append(rec)
                    continue
                j = self._rng.randrange(len(pool))
                pool[j], rec = rec, pool[j]
            self._put(rec)
        if self.shuffle:
            self._rng.shuffle(pool)
            for rec in pool:
                if self._stop.is_set():
                    return
                self._put(rec)

    def _put(self, item: Any) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                self._metrics.queue_depth.set(self._queue.qsize())
                return
            except queue.Full:
                continue

    def _iter_records(self) -> Iterator[Any]:
        for seg in self.segments:
            if self.fmt == "tokens":
                yield from self._iter_tokens(seg)
            elif self.fmt == "jsonl-blocks":
                yield from self._iter_blocks(seg)
            else:
                yield from self._iter_jsonl(seg)

    def _iter_blocks(self, seg: FileSegment) -> Iterator[Any]:
        from tony_tpu_torch.io.blocks import iter_block_records

        yield from iter_block_records(
            seg.path, seg.offset, seg.length,
            size=self._sizes[seg.path],
        )

    # Records per queue chunk: large enough to amortize the syscall and the
    # prefetch-queue hop, small enough that one chunk never dominates the
    # buffer. One read *span* covers 4 chunks (the per-read overhead —
    # ctypes hop, GET round-trip — amortizes below the memcpy cost).
    # Byte-heavy records shrink the effective rows per chunk so one queue
    # item stays ≤ _CHUNK_BYTES_CAP and one span ≤ 4× that.
    _CHUNK_RECORDS = 256
    _READ_WORKERS = 4
    _SPAN_CHUNKS = 4
    _CHUNK_BYTES_CAP = 4 << 20
    _QUEUE_BYTES_CAP = 64 << 20

    # -- span reads (shared by the serial and parallel token paths) ---------
    def _fd_for(self, path: str) -> int:
        """One fd per local path, shared across read workers — pread has
        no seek state, so concurrent span reads on one fd are safe."""
        with self._fds_lock:
            fd = self._fds.get(path)
            if fd is None:
                fd = os.open(path, os.O_RDONLY)
                self._fds[path] = fd
            return fd

    def _close_fds(self) -> None:
        with self._fds_lock:
            for fd in self._fds.values():
                try:
                    os.close(fd)
                except OSError:
                    pass
            self._fds.clear()

    def _read_span(self, path: str, offset: int, n_records: int) -> np.ndarray:
        """One span of ``n_records`` fixed-size records as a writable
        [n, record_len] array of ``dtype``. Raises on IO errors AND on
        short reads (the segment table was computed from the file sizes
        at open, so a short read means the corpus changed underneath us —
        never silently truncate)."""
        rb = self._record_bytes()
        record_len = rb // self.dtype.itemsize
        want = n_records * rb
        t0 = time.perf_counter()
        if is_gs_uri(path):
            data = read_range(path, offset, want)
            got = len(data) // rb
            # One copy: frombuffer is a zero-copy (read-only) view of the
            # response body; .copy() makes the one writable array.
            rows = np.frombuffer(
                data, dtype=self.dtype, count=got * record_len
            ).reshape(got, record_len).copy()
        elif native.available():
            arr = native.pread_records(self._fd_for(path), offset, rb,
                                       n_records)
            if arr is None:
                raise OSError(
                    f"native pread failed on {path} at byte {offset}"
                )
            got = len(arr)
            # got == 0 (file truncated to/below offset) must reach the
            # short-read diagnostic below, not die in reshape(0, -1).
            rows = (
                arr.reshape(-1).view(self.dtype).reshape(got, -1)
                if got else np.empty((0, record_len), self.dtype)
            )
        else:
            # preadv straight into the output array: no intermediate bytes
            # object, no seek state shared across workers. Platforms
            # without preadv (macOS) take os.pread plus one copy — still
            # positional, still worker-safe.
            fd = self._fd_for(path)
            rows = np.empty((n_records, record_len), self.dtype)
            flat = rows.reshape(-1).view(np.uint8)
            has_preadv = hasattr(os, "preadv")
            done = 0
            while done < want:
                if has_preadv:
                    n = os.preadv(fd, [flat[done:]], offset + done)
                else:
                    data = os.pread(fd, want - done, offset + done)
                    n = len(data)
                    flat[done:done + n] = np.frombuffer(data, np.uint8)
                if n == 0:
                    break
                done += n
            got = done // rb
            rows = rows[:got]
        if got < n_records:
            raise OSError(
                f"short read on {path} at byte {offset}: wanted "
                f"{n_records} records, got {got} — corpus changed "
                f"underneath the reader"
            )
        self._metrics.read_ms.observe((time.perf_counter() - t0) * 1e3)
        self._metrics.bytes_read.inc(got * rb)
        return rows

    def _span_descriptors(self) -> list[tuple[str, int, int]]:
        """(path, byte offset, n_records) for every read span across all
        owned segments, in stream order."""
        rb = self._record_bytes()
        span = self._chunk_rows * self._SPAN_CHUNKS
        descs: list[tuple[str, int, int]] = []
        for seg in self.segments:
            offset, remaining = seg.offset, seg.length // rb
            while remaining > 0:
                n = min(span, remaining)
                descs.append((seg.path, offset, n))
                offset += n * rb
                remaining -= n
        return descs

    def _fetch_chunks_parallel(self) -> None:
        """The byte-heavy fast path: span preads issued by a worker pool
        with a sliding window of in-flight futures, consumed in
        submission order so the stream stays byte-identical to the serial
        path. While the consumer drains span N, spans N+1..N+window are
        already being read — disk/GCS latency overlaps the H2D+step
        pipeline downstream."""
        descs = self._span_descriptors()
        if not descs:
            return
        window = self.read_workers + 2
        inflight: collections.deque = collections.deque()
        with ThreadPoolExecutor(
            max_workers=self.read_workers,
            thread_name_prefix="tony-io-read",
        ) as pool:
            try:
                for desc in descs:
                    if self._stop.is_set():
                        return
                    if not is_gs_uri(desc[0]) and native.available():
                        # Page-cache hint for the span about to be queued:
                        # by the time its future runs, the kernel's
                        # readahead has usually landed.
                        native.readahead(
                            self._fd_for(desc[0]), desc[1],
                            desc[2] * self._record_bytes(),
                        )
                    inflight.append(pool.submit(self._read_span, *desc))
                    if len(inflight) >= window:
                        if not self._emit_span(inflight.popleft().result()):
                            return
                while inflight:
                    if not self._emit_span(inflight.popleft().result()):
                        return
            finally:
                for fut in inflight:
                    fut.cancel()

    def _emit_span(self, rows: np.ndarray) -> bool:
        """Slice one span into chunk-sized queue items (zero-copy views).
        Returns False when the reader is stopping."""
        for lo in range(0, len(rows), self._chunk_rows):
            if self._stop.is_set():
                return False
            self._put(rows[lo: lo + self._chunk_rows])
        return True

    def _iter_token_chunks(self, seg: FileSegment) -> Iterator[np.ndarray]:
        """Serial span reads for one segment, yielded as chunk-sized
        views — the shuffle path's source (shuffle needs single records,
        so it cannot ride the parallel pipeline's ordering window)."""
        rb = self._record_bytes()
        span = self._chunk_rows * self._SPAN_CHUNKS
        offset, remaining = seg.offset, seg.length // rb
        while remaining > 0:
            n = min(span, remaining)
            rows = self._read_span(seg.path, offset, n)
            for lo in range(0, len(rows), self._chunk_rows):
                yield rows[lo: lo + self._chunk_rows]
            offset += n * rb
            remaining -= n

    def _iter_tokens(self, seg: FileSegment) -> Iterator[np.ndarray]:
        """Record-granular path (shuffle needs single records). Rows are
        COPIED out of the chunk: the shuffle pool retains individual rows
        for a long time, and a view would pin its entire chunk buffer
        (up to chunk_records x the intended footprint)."""
        for chunk in self._iter_token_chunks(seg):
            for row in chunk:
                yield row.copy()

    def _iter_jsonl(self, seg: FileSegment) -> Iterator[Any]:
        with open_lines(seg.path) as f:
            if seg.offset == 0:
                f.seek(0)
            else:
                # Seek one byte back before skipping: if offset sits exactly
                # on a record start, the preceding byte is the newline, so
                # readline() consumes only it and the record stays ours
                # (Hadoop LineRecordReader's boundary rule).
                f.seek(seg.offset - 1)
                f.readline()
            end = seg.offset + seg.length
            while f.tell() < end:  # owner reads its last record past `end`
                line = f.readline()
                if not line:
                    return
                line = line.strip()
                if line:
                    yield json.loads(line)

    # -- consumer API (getSchemaJson:446-463, nextBatch*:503-542) -----------
    def schema_json(self) -> str:
        """Schema introspection (the getSchemaJson analogue). ``tokens``
        describes the fixed record layout; ``jsonl-blocks`` returns the
        container header's embedded schema (negotiated, no data block
        touched — HdfsAvroFileSplitReader.java:446-463's property),
        falling back to first-record introspection when the writer
        embedded none; ``jsonl`` reports the field names/types of the
        shard's first record (without consuming it)."""
        if self.fmt == "tokens":
            return json.dumps({
                "format": "tokens",
                "dtype": self.dtype.name,
                "record_len": self.record_len,
            })
        if self.fmt == "jsonl-blocks":
            from tony_tpu_torch.io.blocks import read_header

            # Consult EVERY container backing this reader before falling
            # back to record introspection: the writer may have embedded
            # the schema in any of them (e.g. an older first container
            # with an empty header followed by schema-carrying ones).
            for path in self._sizes:
                codec, schema, _ = read_header(path)
                if schema:
                    return json.dumps({
                        "format": "jsonl-blocks", "codec": codec,
                        "schema": schema,
                    })
        iter_one = (
            self._iter_blocks if self.fmt == "jsonl-blocks"
            else self._iter_jsonl
        )
        for seg in self.segments:
            for rec in iter_one(seg):
                fields = (
                    {k: type(v).__name__ for k, v in rec.items()}
                    if isinstance(rec, dict) else type(rec).__name__
                )
                return json.dumps({"format": self.fmt, "fields": fields})
        return json.dumps({"format": self.fmt, "fields": {}})

    def next_batch_file(self, directory: str | os.PathLike[str] = ".") -> str | None:
        """One batch spilled to a local file, returning its path — the
        nextBatchFile/LocalSpill analogue (:503-542) for consumers that
        want to mmap large batches instead of holding them in the Python
        heap. ``tokens`` batches land as ``.npy`` (np.load/mmap_mode
        ready); ``jsonl`` batches as newline-delimited ``.jsonl``. The
        caller owns deleting the file."""
        import tempfile

        batch = self.next_batch()
        if batch is None:
            return None
        if self.fmt == "tokens":
            fd, path = tempfile.mkstemp(suffix=".npy", dir=str(directory))
            with os.fdopen(fd, "wb") as f:
                np.save(f, batch)
        else:
            fd, path = tempfile.mkstemp(suffix=".jsonl", dir=str(directory))
            with os.fdopen(fd, "w") as f:
                for rec in batch:
                    f.write(json.dumps(rec) + "\n")
        return path

    def next_batch(self) -> list[Any] | np.ndarray | None:
        """One batch, or None at end of shard (batches may be short at the
        tail). Token format returns [batch, record_len] arrays."""
        if self._chunk_granular:
            return self._next_batch_from_chunks()
        out: list[Any] = []
        while len(out) < self.batch_size:
            item = self._queue.get()
            if item is _SENTINEL:
                self._queue.put(_SENTINEL)  # keep the stream terminated
                self._raise_fetch_failure()
                break
            out.append(item)
        if not out:
            return None
        if self.fmt == "tokens":
            return np.stack(out)
        return out

    def _next_chunk(self) -> bool:
        """Pull the next chunk into the rollover head. False at sentinel
        (stream terminated — failure already re-raised if any)."""
        t0 = time.perf_counter()
        item = self._queue.get()
        self._metrics.batch_wait_ms.observe((time.perf_counter() - t0) * 1e3)
        self._metrics.queue_depth.set(self._queue.qsize())
        if item is _SENTINEL:
            self._queue.put(_SENTINEL)
            self._raise_fetch_failure()
            return False
        self._head, self._head_off = item, 0
        return True

    def _next_batch_from_chunks(self) -> np.ndarray | None:
        """Assemble exact batch_size batches from queued chunks via a
        rollover buffer: a batch fully inside the head chunk is a
        ZERO-COPY view (chunk rows are exclusively this batch's, so
        in-place consumer mutation stays safe — but the view pins its
        backing span array, bounded at 4×_CHUNK_BYTES_CAP; consumers that
        RETAIN many host batches should copy, like the shuffle path
        does); a batch crossing chunk boundaries copies each row exactly
        once into a preallocated output. The old implementation concatenated the entire pending
        list per batch — O(buffered bytes) of copying per call. Leftover
        head rows carry into the next call, so batch boundaries are
        identical to the record-granular path."""
        bs = self.batch_size
        out: np.ndarray | None = None
        filled = 0
        while filled < bs:
            if self._head is None and not self._next_chunk():
                break
            head = self._head
            assert head is not None
            avail = len(head) - self._head_off
            if filled == 0 and avail >= bs:
                lo = self._head_off
                self._head_off += bs
                if self._head_off >= len(head):
                    self._head = None
                return head[lo: lo + bs]
            if out is None:
                out = np.empty((bs,) + head.shape[1:], head.dtype)
            take = min(bs - filled, avail)
            t0 = time.perf_counter()
            out[filled: filled + take] = (
                head[self._head_off: self._head_off + take]
            )
            self._metrics.assemble_ms.observe(
                (time.perf_counter() - t0) * 1e3
            )
            filled += take
            self._head_off += take
            if self._head_off >= len(head):
                self._head = None
        if filled == 0:
            return None
        assert out is not None
        return out if filled == bs else out[:filled]

    def _raise_fetch_failure(self) -> None:
        # _fetch_exc stays SET: a caller that catches the first raise and
        # retries (or a later consumer of the same reader) must keep
        # failing loudly, not read the requeued sentinel as a clean end
        # of shard.
        if self._fetch_exc is not None:
            raise RuntimeError(
                "record fetcher failed; the shard is NOT exhausted"
            ) from self._fetch_exc

    def __iter__(self) -> Iterator[Any]:
        # Chaos seam: a `throttle_io` entry in the job's fault plan starves
        # this iterator deterministically (the sleep happens inside next(),
        # so the step anatomy reads it as data_wait, like a real slow input
        # pipeline).
        faults = io_faults_from_env()
        while True:
            batch = self.next_batch()
            if batch is None:
                return
            if faults is not None:
                faults.maybe_throttle()
            yield batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._fetcher.join(timeout=5)
        # Close fds only once the fetcher (and therefore every pool
        # worker holding them in preadv or native pread) is done — closing
        # under an in-flight read risks EBADF or, after fd-number reuse,
        # a read from an unrelated file. A fetcher that outlives the
        # timeout closes them itself in _fetch_guarded's finally.
        if not self._fetcher.is_alive():
            self._close_fds()
        # Re-terminate the stream: the drain above may have swallowed the
        # sentinel (and _put no-ops once _stop is set), so a consumer
        # blocked in queue.get() — e.g. a DevicePrefetcher's transfer
        # thread mid-epoch — must still observe end-of-stream instead of
        # hanging forever.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        try:
            self._queue.put_nowait(_SENTINEL)
        except queue.Full:
            pass

    def __enter__(self) -> "ShardedRecordReader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of a batch: dicts, lists and tuples are
    containers, everything else is a leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class _Staged:
    """A batch copied to the card on the prefetcher's side stream, with the
    event its copies complete at. ``hand_over`` orders the consumer's
    stream after that event and marks every tensor as used there, so the
    caching allocator cannot give their memory back to the side stream
    while the consumer's step still reads it."""

    __slots__ = ("batch", "done")

    def __init__(self, batch: Any, done: torch.cuda.Event) -> None:
        self.batch = batch
        self.done = done

    def hand_over(self, device: torch.device) -> Any:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(self.done)

        def mark(t):
            t.record_stream(stream)
            return t

        return _tree_map(mark, self.batch)


def _make_transfer(device: torch.device, put_fn, stop: threading.Event,
                   metrics: _IoMetrics) -> Callable[[Any], Any]:
    """One host->device transfer closure for the pool workers —
    deliberately free of any DevicePrefetcher reference so pending futures
    never pin an abandoned prefetcher. On CUDA each leaf is staged in
    pinned memory and copied with ``non_blocking=True`` on a side stream."""
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def transfer(b):
        if stop.is_set():
            return None  # discarded; close() already owns teardown
        if put_fn is not None:
            return put_fn(b)
        # tony_io_h2d_ms times the enqueue of the copy (the pinned staging
        # and the non-blocking copy's launch on the side stream), as the
        # JAX package times the device_put dispatch: not the copy's
        # completion on the card.
        t0 = time.perf_counter()
        if side is None:
            out = _tree_map(torch.as_tensor, b)
        else:
            with torch.cuda.stream(side):
                out = _Staged(_tree_map(
                    lambda x: torch.as_tensor(x).pin_memory().to(
                        device, non_blocking=True), b), side.record_event())
        metrics.h2d_ms.observe((time.perf_counter() - t0) * 1e3)
        nbytes = getattr(b, "nbytes", None)
        if nbytes:
            metrics.h2d_bytes.inc(nbytes)
        return out

    return transfer


class _Inflight:
    """The transfers in flight, counted by the producer thread and the
    consumer under one lock, published to ``tony_io_h2d_inflight_depth``."""

    def __init__(self, gauge) -> None:
        self._gauge = gauge
        self._n = 0
        self._lock = threading.Lock()

    def add(self, delta: int) -> None:
        with self._lock:
            self._n += delta
            self._gauge.set(self._n)

    def zero(self) -> None:
        """Nothing is left in flight (the stream ended or was closed)."""
        self._gauge.set(0)


def _producer_loop(batches, q, slots, stop, pool, transfer,
                   inflight: _Inflight, self_ref) -> None:
    """DevicePrefetcher's producer thread body. Runs on locals + a weak
    self reference only: when the consumer abandons the iterator and the
    object is collected, the next slot-wait tick notices the dead weakref
    and shuts the pipeline down instead of leaking the thread."""
    abandoned = False
    try:
        while True:
            # Slot BEFORE advancing the source: the lookahead bound
            # covers the batch about to be read too, so depth=N never
            # pulls (and buffers) more than N batches beyond the
            # consumer.
            acquired = False
            while not stop.is_set():
                if self_ref() is None:
                    abandoned = True
                    stop.set()
                    break
                if slots.acquire(timeout=0.1):
                    acquired = True
                    break
            if not acquired:
                return
            try:
                b = next(batches)
            except StopIteration:
                slots.release()
                return
            inflight.add(1)
            q.put(pool.submit(transfer, b))
            del b
    except BaseException as exc:
        q.put(_Failure(exc))
    finally:
        q.put(_SENTINEL)
        if abandoned:
            pool.shutdown(wait=False, cancel_futures=True)
            inflight.zero()


class DevicePrefetcher:
    """Host->device pipeline with ``depth`` transfers in flight, issued
    from a background thread (optionally a small pool via
    ``transfer_workers``): while the consumer's step N runs, batches
    N+1..N+depth-1 are being read AND copied. On CUDA the copies run from
    pinned memory on a side stream; the consumer's stream waits on each
    batch's copy event when the batch is handed over, so the step never
    reads a batch before it landed.

    Semantics:

      * output order == input order (futures are consumed in submission
        order);
      * ``depth`` bounds total in-flight batches INCLUDING the one handed
        to the consumer, so ``depth=1`` degenerates to eager per-batch
        transfers and ``depth=2`` is classic double buffering;
      * a producer exception (source iterator OR a failed transfer)
        surfaces to the consumer at the position it occurred — after any
        earlier successful batches, never swallowed — and keeps raising
        on retry;
      * ``close()`` (or ``with``-exit) releases the worker promptly even
        mid-iteration; it never deadlocks on a full pipeline;
      * an iterator abandoned without ``close()`` stops its thread once it
        is collected (the thread holds only a weak reference).
    """

    def __init__(
        self,
        batches: Iterator[Any],
        device="cuda",
        depth: int | None = None,
        *,
        transfer_workers: int = 1,
        put_fn: Callable[[Any], Any] | None = None,
    ) -> None:
        if depth is None:
            depth = _env_int(constants.TONY_IO_PREFETCH_DEPTH, 2)
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = depth
        self.device = resolve_device(device)
        self._metrics = _IoMetrics.get()
        self._q: queue.Queue = queue.Queue()
        self._slots = threading.Semaphore(depth)
        self._held = False  # consumer holds the yielded batch's slot
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self._closed = False
        # A counter object of its own, not an attribute: the producer loop
        # must not hold a strong `self` reference.
        self._inflight = _Inflight(self._metrics.h2d_depth)
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, min(transfer_workers, depth)),
            thread_name_prefix="tony-h2d",
        )
        transfer = _make_transfer(self.device, put_fn, self._stop,
                                  self._metrics)
        # The producer thread gets everything it needs as arguments plus
        # only a WEAK reference to self: a prefetcher abandoned without
        # close() (`for b in device_prefetch(...): break`) then becomes
        # collectible, the weakref dies, and the loop shuts itself down.
        self._thread = threading.Thread(
            target=_producer_loop,
            args=(iter(batches), self._q, self._slots, self._stop,
                  self._pool, transfer, self._inflight, weakref.ref(self)),
            daemon=True,
        )
        self._thread.start()

    # -- consumer side -------------------------------------------------------
    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self):
        # Release the previously-yielded batch's slot only now: the
        # consumer calling next() is the signal it is done with batch
        # N-1, which keeps lookahead exactly depth-1 beyond the batch in
        # hand (depth=1 == eager).
        if self._held:
            self._held = False
            self._inflight.add(-1)
            self._slots.release()
        if self._exc is not None:
            # Sticky failure: every subsequent pull re-raises, so a
            # consumer that catches and retries can never read the
            # pipeline as cleanly exhausted.
            raise self._exc
        if self._closed:
            raise StopIteration  # closed pipelines terminate, never hang
        t0 = time.perf_counter()
        item = self._q.get()
        if item is _SENTINEL:
            self._q.put(_SENTINEL)  # keep the stream terminated
            self._inflight.zero()
            self._pool.shutdown(wait=False)  # workers idle by now
            raise StopIteration
        if isinstance(item, _Failure):
            self._exc = item.exc
            raise item.exc
        try:
            out = item.result()
        except BaseException as exc:
            self._exc = exc
            self._inflight.add(-1)
            self._slots.release()
            raise
        self._held = True
        self._metrics.queue_wait_ms.observe(
            (time.perf_counter() - t0) * 1e3
        )
        if isinstance(out, _Staged):
            out = out.hand_over(self.device)
        return out

    def close(self) -> None:
        """Stop the transfer thread and drop queued work. Safe to call
        mid-iteration and more than once; never blocks on a full
        pipeline (the producer's slot wait polls the stop event), and a
        ``next()`` after close terminates instead of hanging on the
        drained queue."""
        self._closed = True
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._thread.join(timeout=5)
        self._inflight.zero()

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __del__(self) -> None:  # backstop; the weakref producer is primary
        try:
            self._stop.set()
            self._pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass


def device_prefetch(
    batches: Iterator[Any],
    device="cuda",
    depth: int | None = None,
    *,
    transfer_workers: int = 1,
):
    """Overlapped host->device pipeline: keep ``depth`` batches' transfers
    IN FLIGHT ahead of the consumer, issued from a background thread.
    ``depth=None`` reads ``TONY_IO_PREFETCH_DEPTH`` (default 2 — classic
    double buffering). A batch is an array or tensor, or a dict, list or
    tuple of them; it comes out as tensors on ``device``. Returns a
    ``DevicePrefetcher`` (iterator + context manager; ``close()`` releases
    the worker mid-iteration)."""
    return DevicePrefetcher(
        batches, device, depth, transfer_workers=transfer_workers
    )


def sharded_batches(
    reader: ShardedRecordReader, mesh=None, axes=("dp", "ep"), *,
    prefetch: int | None = None, transfer_workers: int = 1, device="cuda",
):
    """Wrap a tokens-format reader into an iterator of tensors on
    ``device`` — the step input the train step expects. Short tail batches
    are dropped. Transfers are pipelined through ``device_prefetch``
    (depth ``prefetch``, default ``TONY_IO_PREFETCH_DEPTH``).

    With a ``mesh`` the batch is split over ``axes``: each rank's batches
    are its own slice of the global batch, so ``reader`` must be this
    rank's shard of the corpus (``task_index``/``num_tasks`` = its position
    along ``axes`` and their size; ``runtime.sharded_reader`` builds it),
    and ``device`` the mesh's device type."""
    if mesh is not None:
        want = (axis_coordinate(mesh, axes), axis_size(mesh, axes))
        if (reader.task_index, reader.num_tasks) != want:
            raise ValueError(
                f"this rank feeds batch shard {want[0]} of {want[1]} over "
                f"mesh axes {axes}; the reader reads shard "
                f"{reader.task_index} of {reader.num_tasks}"
            )
        if resolve_device(device).type != mesh.device_type:
            raise ValueError(f"a {mesh.device_type} mesh takes no batches "
                             f"on {device}")

    def full_batches():
        for batch in reader:
            if batch.shape[0] == reader.batch_size:
                yield batch

    prefetcher = device_prefetch(
        full_batches(), device, prefetch, transfer_workers=transfer_workers,
    )
    try:
        yield from prefetcher
    finally:
        prefetcher.close()
