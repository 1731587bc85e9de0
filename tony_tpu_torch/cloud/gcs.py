"""The object store client: put/get/list/delete, bytes, ranges and files
over the GCS JSON/upload REST surface, and ``FileObjectStorage``, the same
surface over a local directory.

The port's own copy of the JAX package's ``cloud/gcs.py``, with the same
names, requests and semantics. No SDK: plain REST through the injectable
``HttpTransport`` seam (``cloud/transport.py``), so recorded-response tests
cover the whole surface. The checkpoint manager (``gs://`` step prefixes)
and the reader (``gs://`` corpora, ranged reads) reach it through
``cloud.default_storage()``.
"""

from __future__ import annotations

import json
import logging
import urllib.parse
from pathlib import Path
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from tony_tpu_torch.cloud.transport import HttpTransport

log = logging.getLogger(__name__)

_API = "https://storage.googleapis.com"


def is_gs_uri(uri: str | Path) -> bool:
    return str(uri).startswith("gs://")


def split_gs_uri(uri: str) -> tuple[str, str]:
    """gs://bucket/some/key -> ("bucket", "some/key")."""
    if not is_gs_uri(uri):
        raise ValueError(f"not a gs:// URI: {uri!r}")
    rest = str(uri)[len("gs://"):]
    bucket, _, key = rest.partition("/")
    if not bucket:
        raise ValueError(f"gs:// URI missing bucket: {uri!r}")
    return bucket, key


def _rfc3339_epoch(stamp: str | None) -> float | None:
    """GCS ``updated`` stamp ("2026-07-30T12:34:56.789Z") -> epoch
    seconds; missing/unparseable stamps read as None ("active") — the
    checkpoint GC must never treat an object whose age it cannot
    establish as quiescent, or a straggler's in-flight step could be
    deleted mid-write (same rule as the FS store's OSError path)."""
    if not stamp:
        return None
    try:
        import datetime

        return datetime.datetime.fromisoformat(
            stamp.replace("Z", "+00:00")
        ).timestamp()
    except ValueError:
        return None


class GcsError(RuntimeError):
    def __init__(self, status: int, url: str, body: bytes) -> None:
        super().__init__(
            f"GCS request failed with HTTP {status} for {url}: "
            f"{body[:300]!r}"
        )
        self.status = status


class GcsStorage:
    """Minimal object store client: put/get/list/delete, bytes and files.

    ``transport`` is any ``transport.HttpTransport``; the default is the
    urllib transport with metadata-server / gcloud auth (see
    ``transport.UrllibTransport``).
    """

    def __init__(self, transport: "HttpTransport | None" = None) -> None:
        if transport is None:
            from tony_tpu_torch.cloud.transport import UrllibTransport

            transport = UrllibTransport()
        self.transport = transport

    # -- bytes --------------------------------------------------------------
    def put_bytes(self, uri: str, data: bytes) -> None:
        bucket, key = split_gs_uri(uri)
        url = (
            f"{_API}/upload/storage/v1/b/{urllib.parse.quote(bucket)}/o"
            f"?uploadType=media&name={urllib.parse.quote(key, safe='')}"
        )
        status, body = self.transport.request(
            "POST", url, data, {"Content-Type": "application/octet-stream"}
        )
        if status != 200:
            raise GcsError(status, url, body)
        log.debug("uploaded %d bytes to %s", len(data), uri)

    def get_bytes(self, uri: str) -> bytes:
        bucket, key = split_gs_uri(uri)
        url = (
            f"{_API}/storage/v1/b/{urllib.parse.quote(bucket)}/o/"
            f"{urllib.parse.quote(key, safe='')}?alt=media"
        )
        status, body = self.transport.request("GET", url, None, {})
        if status != 200:
            raise GcsError(status, url, body)
        return body

    # -- files --------------------------------------------------------------
    def upload_file(self, local: str | Path, uri: str) -> None:
        """Streamed upload: the request body is the open file object (the
        transport sends Content-Length from its size), so a multi-GB venv
        archive never lands in client RAM."""
        bucket, key = split_gs_uri(uri)
        url = (
            f"{_API}/upload/storage/v1/b/{urllib.parse.quote(bucket)}/o"
            f"?uploadType=media&name={urllib.parse.quote(key, safe='')}"
        )
        size = Path(local).stat().st_size
        with open(local, "rb") as f:
            status, body = self.transport.request(
                "POST", url, f,
                {
                    "Content-Type": "application/octet-stream",
                    "Content-Length": str(size),
                },
            )
        if status != 200:
            raise GcsError(status, url, body)
        log.debug("uploaded %d bytes to %s", size, uri)

    def download_file(self, uri: str, local: str | Path) -> None:
        """Streamed when the transport supports it (UrllibTransport does);
        fake/simple transports fall back to the in-memory path."""
        path = Path(local)
        path.parent.mkdir(parents=True, exist_ok=True)
        stream = getattr(self.transport, "request_stream", None)
        if stream is None:
            path.write_bytes(self.get_bytes(uri))
            return
        bucket, key = split_gs_uri(uri)
        url = (
            f"{_API}/storage/v1/b/{urllib.parse.quote(bucket)}/o/"
            f"{urllib.parse.quote(key, safe='')}?alt=media"
        )
        status, resp = stream("GET", url)
        if status != 200:
            with resp:
                raise GcsError(status, url, resp.read()[:300])
        with resp, open(path, "wb") as out:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)

    def get_range(self, uri: str, offset: int, length: int) -> bytes:
        """``length`` bytes from ``offset`` via an HTTP Range request — the
        data plane's random-access primitive (the FSDataInputStream.seek
        analogue, HdfsAvroFileSplitReader.java:379-416). GCS serves ranged
        object reads natively, so byte-range splits port directly."""
        if length <= 0:
            return b""
        bucket, key = split_gs_uri(uri)
        url = (
            f"{_API}/storage/v1/b/{urllib.parse.quote(bucket)}/o/"
            f"{urllib.parse.quote(key, safe='')}?alt=media"
        )
        status, body = self.transport.request(
            "GET", url, None,
            {"Range": f"bytes={offset}-{offset + length - 1}"},
        )
        if status == 206:
            return body
        if status == 200:
            # Server ignored the Range header (tiny objects / proxies):
            # the body is the whole object.
            return body[offset:offset + length]
        raise GcsError(status, url, body)

    # -- metadata -----------------------------------------------------------
    def size(self, uri: str) -> int:
        """Object size in bytes from metadata (no body transfer)."""
        bucket, key = split_gs_uri(uri)
        url = (
            f"{_API}/storage/v1/b/{urllib.parse.quote(bucket)}/o/"
            f"{urllib.parse.quote(key, safe='')}"
        )
        status, body = self.transport.request("GET", url, None, {})
        if status != 200:
            raise GcsError(status, url, body)
        return int(json.loads(body)["size"])

    def exists(self, uri: str) -> bool:
        bucket, key = split_gs_uri(uri)
        url = (
            f"{_API}/storage/v1/b/{urllib.parse.quote(bucket)}/o/"
            f"{urllib.parse.quote(key, safe='')}"
        )
        status, body = self.transport.request("GET", url, None, {})
        if status == 200:
            return True
        if status == 404:
            return False
        raise GcsError(status, url, body)

    def list_prefix(self, uri: str) -> list[str]:
        """All object keys under a gs://bucket/prefix (full keys, paging
        followed)."""
        return [name for name, _ in self.list_prefix_mtimes(uri)]

    def list_prefix_mtimes(self, uri: str) -> list[tuple[str, float | None]]:
        """(key, last-updated epoch seconds or None=age unknown) under a
        prefix — the quiescence signal the checkpoint GC uses (objects
        carry an ``updated`` RFC3339 stamp in list metadata)."""
        bucket, prefix = split_gs_uri(uri)
        out: list[tuple[str, float | None]] = []
        page = ""
        while True:
            url = (
                f"{_API}/storage/v1/b/{urllib.parse.quote(bucket)}/o"
                f"?prefix={urllib.parse.quote(prefix, safe='')}"
            )
            if page:
                url += f"&pageToken={urllib.parse.quote(page)}"
            status, body = self.transport.request("GET", url, None, {})
            if status != 200:
                raise GcsError(status, url, body)
            doc = json.loads(body)
            for item in doc.get("items", []):
                out.append((item["name"], _rfc3339_epoch(item.get("updated"))))
            page = doc.get("nextPageToken", "")
            if not page:
                return out

    def delete(self, uri: str) -> None:
        bucket, key = split_gs_uri(uri)
        url = (
            f"{_API}/storage/v1/b/{urllib.parse.quote(bucket)}/o/"
            f"{urllib.parse.quote(key, safe='')}"
        )
        status, body = self.transport.request("DELETE", url, None, {})
        if status not in (200, 204, 404):
            raise GcsError(status, url, body)


class FileObjectStorage:
    """The GcsStorage surface over a local directory: ``gs://bucket/key``
    maps to ``<root>/bucket/key``. This is the dev/test object store — the
    tony-mini analogue of the reference testing its HDFS paths on a
    MiniDFSCluster: set ``TONY_GCS_EMULATOR_DIR`` (or call
    ``set_default_storage``) and every gs:// code path (staging, history,
    data plane, checkpoints) runs against local files, including in
    executor subprocesses that inherit the env var."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)

    def _path(self, uri: str) -> Path:
        bucket, key = split_gs_uri(uri)
        return self.root / bucket / key

    def put_bytes(self, uri: str, data: bytes) -> None:
        p = self._path(uri)
        p.parent.mkdir(parents=True, exist_ok=True)
        # Per-object atomicity, like a real object store PUT.
        tmp = p.with_name(f".{p.name}.tmp")
        tmp.write_bytes(data)
        tmp.replace(p)

    def get_bytes(self, uri: str) -> bytes:
        p = self._path(uri)
        if not p.is_file():
            raise GcsError(404, str(p), b"no such object")
        return p.read_bytes()

    def get_range(self, uri: str, offset: int, length: int) -> bytes:
        if length <= 0:
            return b""
        p = self._path(uri)
        if not p.is_file():
            raise GcsError(404, str(p), b"no such object")
        with open(p, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def upload_file(self, local: str | Path, uri: str) -> None:
        self.put_bytes(uri, Path(local).read_bytes())

    def download_file(self, uri: str, local: str | Path) -> None:
        path = Path(local)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(self.get_bytes(uri))

    def size(self, uri: str) -> int:
        p = self._path(uri)
        if not p.is_file():
            raise GcsError(404, str(p), b"no such object")
        return p.stat().st_size

    def exists(self, uri: str) -> bool:
        return self._path(uri).is_file()

    def list_prefix(self, uri: str) -> list[str]:
        return [name for name, _ in self.list_prefix_mtimes(uri)]

    def list_prefix_mtimes(self, uri: str) -> list[tuple[str, float]]:
        bucket, prefix = split_gs_uri(uri)
        base = self.root / bucket
        if not base.is_dir():
            return []
        return sorted(
            (str(p.relative_to(base)), p.stat().st_mtime)
            for p in base.rglob("*")
            if p.is_file() and not p.name.startswith(".")
            and str(p.relative_to(base)).startswith(prefix)
        )

    def delete(self, uri: str) -> None:
        p = self._path(uri)
        if p.is_file():
            p.unlink()
