"""Block-compressed jsonl container with sync-marker framing.

The reference reads Avro container files: a self-describing header whose
schema is surfaced to the consumer (getSchemaJson,
HdfsAvroFileSplitReader.java:446-463) and per-block compression with
16-byte sync markers so byte-range splits land on block boundaries
(:190-240). This is the same design, tpu-corpus-shaped: records are
newline-delimited JSON, compressed per block (gzip or zstd), each block
preceded by a fixed sync marker and followed by a CRC so a split reader
can locate — and trust — the next block from any byte offset.

Layout::

    header:  MAGIC(8) | codec(u8) | schema_len(u32 LE) | schema_json
    block:   SYNC(8) | raw_len(u32) | comp_len(u32) | payload | crc32(u32)

Split rule (identical to the reader's jsonl/tokens owner-of-first-byte
rule): a reader owns every block whose SYNC marker starts inside its
byte range, reading the last one to completion past the range end; a
range starting mid-block scans forward to the next marker. A sync-byte
collision inside compressed payload is caught by the CRC (and the
implausible-length guard) and scanning resumes one byte later, so false
positives cannot corrupt the stream — Avro gets the same property from
validating its 16-byte marker.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Any, Iterator

from tony_tpu_torch.io.storage import file_size, is_gs_uri, read_range

MAGIC = b"TONYJBL1"
SYNC = b"\xf1\x1aTNYSYN"  # 8 bytes, starts outside ASCII-JSON space
_BLOCK_HDR = struct.Struct("<II")  # raw_len, comp_len
_CRC = struct.Struct("<I")
# Sanity ceiling for lengths parsed at a sync candidate: a real block
# never exceeds this, so garbage lengths from a payload collision are
# rejected before any giant read is attempted.
MAX_BLOCK = 1 << 28

CODECS = {"none": 0, "gzip": 1, "zstd": 2}
_CODEC_NAMES = {v: k for k, v in CODECS.items()}


def _compress(codec: str, data: bytes) -> bytes:
    if codec == "none":
        return data
    if codec == "gzip":
        return zlib.compress(data, 6)
    if codec == "zstd":
        import zstandard

        return zstandard.ZstdCompressor().compress(data)
    raise ValueError(f"unknown codec {codec!r}; expected {sorted(CODECS)}")


def _decompress(codec: str, data: bytes, raw_len: int) -> bytes:
    if codec == "none":
        return data
    if codec == "gzip":
        return zlib.decompress(data)
    if codec == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=raw_len
        )
    raise ValueError(f"unknown codec {codec!r}")


def write_jsonl_blocks(
    path: str,
    records: Any,
    *,
    codec: str = "gzip",
    block_records: int = 256,
    schema: dict | None = None,
) -> int:
    """Write ``records`` (any iterable of JSON-able objects) as a block-
    compressed container; returns the number of records written.
    ``schema`` (a JSON-able description, e.g. field->type) is embedded in
    the header and surfaced by ``ShardedRecordReader.schema_json`` without
    touching any data block — the getSchemaJson negotiation."""
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}; expected {sorted(CODECS)}")
    schema_bytes = json.dumps(schema or {}).encode()
    gs = is_gs_uri(path)
    # Local files stream block by block: a corpus-sized container must not
    # need corpus-sized RAM. Only the gs:// branch buffers (object PUTs are
    # whole-object).
    sink: Any = io.BytesIO() if gs else open(path, "wb")
    try:
        sink.write(MAGIC)
        sink.write(bytes([CODECS[codec]]))
        sink.write(_CRC.pack(len(schema_bytes)))
        sink.write(schema_bytes)

        n = 0
        pending: list[bytes] = []

        def flush() -> None:
            if not pending:
                return
            raw = b"".join(pending)
            comp = _compress(codec, raw)
            sink.write(SYNC)
            sink.write(_BLOCK_HDR.pack(len(raw), len(comp)))
            sink.write(comp)
            sink.write(_CRC.pack(zlib.crc32(comp)))
            pending.clear()

        for rec in records:
            pending.append(json.dumps(rec).encode() + b"\n")
            n += 1
            if len(pending) >= block_records:
                flush()
        flush()

        if gs:
            from tony_tpu_torch.cloud import default_storage

            default_storage().put_bytes(path, sink.getvalue())
    finally:
        sink.close()
    return n


def read_header(path: str) -> tuple[str, dict, int]:
    """(codec_name, schema, first_data_byte). Raises on non-container
    files so a mis-declared format fails loudly, not as garbage JSON."""
    head = read_range(path, 0, len(MAGIC) + 1 + _CRC.size)
    if head[: len(MAGIC)] != MAGIC:
        raise ValueError(
            f"{path}: not a jsonl-blocks container (bad magic)"
        )
    codec_id = head[len(MAGIC)]
    codec = _CODEC_NAMES.get(codec_id)
    if codec is None:
        raise ValueError(f"{path}: unknown codec id {codec_id}")
    (schema_len,) = _CRC.unpack(head[len(MAGIC) + 1:])
    if schema_len > MAX_BLOCK:
        raise ValueError(f"{path}: implausible schema length {schema_len}")
    off = len(MAGIC) + 1 + _CRC.size
    schema = json.loads(read_range(path, off, schema_len) or b"{}")
    return codec, schema, off + schema_len


_SCAN_CHUNK = 1 << 20


def _next_sync(path: str, pos: int, end: int) -> int:
    """First byte offset >= pos where SYNC starts, or -1 past ``end``
    (markers at/after ``end`` belong to the next reader). Scans in 1 MiB
    chunks with an overlap so a marker straddling a chunk edge is found."""
    while pos < end:
        chunk = read_range(path, pos, _SCAN_CHUNK + len(SYNC) - 1)
        if not chunk:
            return -1
        hit = chunk.find(SYNC)
        if hit != -1:
            at = pos + hit
            return at if at < end else -1
        if len(chunk) < len(SYNC):
            return -1
        pos += min(_SCAN_CHUNK, len(chunk) - len(SYNC) + 1)
    return -1


def iter_block_payloads(
    path: str, offset: int, length: int, *, size: int | None = None,
) -> Iterator[bytes]:
    """Decompressed payloads of every block this byte range OWNS (sync
    marker starts inside [offset, offset+length)); the first data byte of
    the file is clamped past the header. CRC or length-check failures at
    a sync candidate are treated as payload collisions: scanning resumes
    one byte later."""
    codec, _, data_start = read_header(path)
    fsize = file_size(path) if size is None else size
    end = min(offset + length, fsize)
    pos = max(offset, data_start)
    aligned = pos == data_start  # mid-range starts must scan to a marker
    while True:
        if aligned and pos < end:
            # After a successfully parsed block (or from the first data
            # byte) the next marker sits exactly at pos — probe it with
            # one small read instead of a 1 MiB scan window (the scan is
            # only for mid-block range starts and collision recovery).
            probe = read_range(path, pos, len(SYNC))
            at = pos if probe == SYNC else _next_sync(path, pos, end)
        else:
            at = _next_sync(path, pos, end)
        aligned = False
        if at < 0:
            return
        hdr = read_range(path, at + len(SYNC), _BLOCK_HDR.size)
        if len(hdr) < _BLOCK_HDR.size:
            return
        raw_len, comp_len = _BLOCK_HDR.unpack(hdr)
        if raw_len > MAX_BLOCK or comp_len > MAX_BLOCK:
            pos = at + 1  # payload collision with the sync bytes
            continue
        body_at = at + len(SYNC) + _BLOCK_HDR.size
        body = read_range(path, body_at, comp_len + _CRC.size)
        if len(body) < comp_len + _CRC.size:
            pos = at + 1  # truncated tail or collision near EOF
            continue
        comp, (crc,) = body[:comp_len], _CRC.unpack(body[comp_len:])
        if zlib.crc32(comp) != crc:
            pos = at + 1
            continue
        yield _decompress(codec, comp, raw_len)
        pos = body_at + comp_len + _CRC.size
        aligned = True  # the next marker, if any, starts right here


def iter_block_records(
    path: str, offset: int, length: int, *, size: int | None = None,
) -> Iterator[Any]:
    """JSON records of every owned block, in file order."""
    for payload in iter_block_payloads(path, offset, length, size=size):
        for line in payload.splitlines():
            line = line.strip()
            if line:
                yield json.loads(line)
