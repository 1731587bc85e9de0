"""The HTTP transport of the object store client: the storage half of the
JAX package's ``cloud/gcp.py``, copied with the same names and semantics.

``HttpTransport`` is the seam ``GcsStorage`` sends every request through;
``UrllibTransport`` is the production one, stdlib HTTP with a Bearer token
from ``default_token_provider`` (the GCE metadata server, else ``gcloud auth
print-access-token``), cached for the token's reported life and refreshed
once on a 401/403. The queued-resource API and the ssh runner of the JAX
module are the TPU control plane and have no counterpart here.
"""

from __future__ import annotations

import json
import subprocess
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Mapping, Protocol

_METADATA_TOKEN_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/"
    "service-accounts/default/token"
)


class HttpTransport(Protocol):
    def request(
        self, method: str, url: str, body,
        headers: Mapping[str, str],
    ) -> tuple[int, bytes]:
        """Returns (status_code, response_body). ``body`` is bytes, None,
        or an open binary file (streamed uploads — callers then supply
        Content-Length). Error statuses are returned, not raised — callers
        decide what is fatal.

        Transports MAY additionally expose
        ``request_stream(method, url) -> (status, readable)`` for streamed
        downloads; GcsStorage uses it when present."""



def _metadata_token() -> tuple[str, float] | None:
    req = urllib.request.Request(
        _METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"}
    )
    try:
        with urllib.request.urlopen(req, timeout=2) as resp:
            doc = json.loads(resp.read())
            # The metadata server serves a CACHED token until shortly
            # before expiry — expires_in is the real remaining life, which
            # can be far under the nominal 3600 s.
            return doc["access_token"], float(doc.get("expires_in", 3600))
    except Exception:
        return None


def _gcloud_token() -> tuple[str, float] | None:
    try:
        out = subprocess.run(
            ["gcloud", "auth", "print-access-token"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    token = out.stdout.strip()
    if out.returncode == 0 and token:
        # gcloud does not report remaining life; assume a conservative
        # half of the nominal hour.
        return token, 1800.0
    return None


def default_token_provider() -> tuple[str, float]:
    """(access token, seconds of remaining life) for the Google APIs: the
    GCE/TPU-VM metadata server when running inside the cloud (the default
    service account — no key files on disk), else the operator's gcloud
    credentials."""
    got = _metadata_token() or _gcloud_token()
    if not got:
        raise RuntimeError(
            "no Google Cloud credentials: not on GCE (metadata server "
            "unreachable) and `gcloud auth print-access-token` failed — "
            "run `gcloud auth login` or supply a token_provider"
        )
    return got


class UrllibTransport:
    """stdlib HTTP with Bearer auth. Tokens are cached for their reported
    ``expires_in`` minus a safety margin (never a fixed window — the
    metadata server hands out the SAME cached token until shortly before
    expiry, so a fresh fetch can have minutes of life left), and a
    401/403 response drops the cache and retries once with a new token so
    a long-running coordinator survives token rollover."""

    _EXPIRY_MARGIN_S = 300.0

    def __init__(
        self, token_provider: Callable[[], str | tuple[str, float]] | None = None,
        timeout_s: float = 60.0,
    ) -> None:
        self._provider = token_provider or default_token_provider
        self._timeout = timeout_s
        self._token: str | None = None
        self._token_expiry = 0.0  # monotonic deadline for the cached token
        # One transport is shared across threads (default_storage feeds
        # concurrent reader fetchers); the lock also collapses a refresh
        # stampede into one provider call.
        self._token_lock = threading.Lock()

    def _bearer(self) -> str:
        with self._token_lock:
            now = time.monotonic()
            if self._token is None or now >= self._token_expiry:
                got = self._provider()
                token, life = got if isinstance(got, tuple) else (got, 3600.0)
                self._token = token
                # Margin against clock skew / in-flight requests; even a
                # nearly-dead token is still cached briefly so a stuck
                # metadata server cannot be hammered in a poll loop.
                self._token_expiry = now + max(
                    life - self._EXPIRY_MARGIN_S, 30.0
                )
            return self._token

    def _drop_token(self) -> None:
        # Expire, don't clear: a concurrent _bearer() between the drop and
        # the refresh must see the old (possibly still valid) token, never
        # None — its own 401 retry covers the stale case.
        with self._token_lock:
            self._token_expiry = 0.0

    def request(
        self, method: str, url: str, body,
        headers: Mapping[str, str],
    ) -> tuple[int, bytes]:
        for attempt in (0, 1):
            hdrs = {"Authorization": f"Bearer {self._bearer()}", **headers}
            req = urllib.request.Request(
                url, data=body, headers=hdrs, method=method
            )
            try:
                with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as e:
                if e.code in (401, 403) and attempt == 0:
                    # Expired/rolled credentials, not a caller error:
                    # refresh once. (Streamed bodies cannot be replayed,
                    # but streamed uploads go through request() only with
                    # seekable files — rewind those.)
                    e.read()
                    self._drop_token()
                    if hasattr(body, "seek"):
                        body.seek(0)
                    continue
                return e.code, e.read()
        raise AssertionError("unreachable")

    def request_stream(self, method: str, url: str):
        """Streamed GET: returns (status, readable response). The caller
        owns closing the response (GcsStorage.download_file does)."""
        for attempt in (0, 1):
            req = urllib.request.Request(
                url, headers={"Authorization": f"Bearer {self._bearer()}"},
                method=method,
            )
            try:
                resp = urllib.request.urlopen(req, timeout=self._timeout)
                return resp.status, resp
            except urllib.error.HTTPError as e:
                if e.code in (401, 403) and attempt == 0:
                    e.read()
                    self._drop_token()
                    continue
                return e.code, e
        raise AssertionError("unreachable")
