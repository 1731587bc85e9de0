"""The port's object store held against the JAX package on the CPU.

Both packages' ``GcsStorage`` drive one recording fake transport with the
same scripted responses and must send the same requests (method, URL,
headers, body) and return the same results; the port's ``UrllibTransport``
caches and refreshes its token as JAX's does (the cases of
``tests/test_cloud.py``); a ``FileObjectStorage`` root written by one
package reads the same in the other; and ``default_storage()`` honors
``TONY_GCS_EMULATOR_DIR`` in each package separately."""

from __future__ import annotations

import io
import json
import re
import urllib.error
import urllib.request

import pytest

from tony_tpu import cloud as jax_cloud
from tony_tpu.cloud import gcs as jax_gcs
from tony_tpu.cloud.gcp import UrllibTransport as JaxUrllibTransport
from tony_tpu_torch import cloud as port_cloud
from tony_tpu_torch.cloud import gcs as port_gcs
from tony_tpu_torch.cloud.transport import UrllibTransport

PACKAGES = {"jax": jax_gcs, "port": port_gcs}


class RecordingTransport:
    """Scripted HTTP transport: responses matched in order by (method, url
    regex); every request is recorded with its headers."""

    def __init__(self, script) -> None:
        self.script = list(script)
        self.requests: list[tuple] = []

    def request(self, method, url, body, headers):
        if hasattr(body, "read"):
            body = body.read()  # streamed upload: record the payload
        self.requests.append((method, url, dict(headers), body))
        for i, (m, url_re, status, resp) in enumerate(self.script):
            if m == method and re.search(url_re, url):
                self.script.pop(i)
                if isinstance(resp, (dict, list)):
                    resp = json.dumps(resp).encode()
                return status, resp
        raise AssertionError(f"unexpected request: {method} {url}")


def _listing(names, token=""):
    doc = {"items": [{"name": n, "updated": f"2026-07-30T12:00:0{i}.5Z"}
                     for i, n in enumerate(names)]}
    if token:
        doc["nextPageToken"] = token
    return doc


# name -> (script, call(storage, tmp_path) -> result)
CASES = {
    "put_get": (
        [("POST", r"/upload/storage/v1/b/bkt/o\?uploadType=media", 200, b"{}"),
         ("GET", r"/o/dir%2Fa%20b\.bin\?alt=media", 200, b"payload")],
        lambda s, tmp: (s.put_bytes("gs://bkt/dir/a b.bin", b"payload"),
                        s.get_bytes("gs://bkt/dir/a b.bin")),
    ),
    "get_range_206": (
        [("GET", r"\?alt=media", 206, b"3456")],
        lambda s, tmp: s.get_range("gs://bkt/c.tokens", 3, 4),
    ),
    "get_range_full_body_200": (
        [("GET", r"\?alt=media", 200, b"0123456789")],
        lambda s, tmp: s.get_range("gs://bkt/c.tokens", 3, 4),
    ),
    "get_range_empty": (
        [], lambda s, tmp: s.get_range("gs://bkt/c.tokens", 3, 0),
    ),
    "size": (
        [("GET", r"/o/c\.tokens$", 200, {"size": "4096"})],
        lambda s, tmp: s.size("gs://bkt/c.tokens"),
    ),
    "exists": (
        [("GET", r"/o/yes$", 200, b"{}"), ("GET", r"/o/no$", 404, b"")],
        lambda s, tmp: (s.exists("gs://bkt/yes"), s.exists("gs://bkt/no")),
    ),
    "list_prefix_paged": (
        [("GET", r"\?prefix=ck%2F$", 200, _listing(["ck/a", "ck/b"], "p2")),
         ("GET", r"pageToken=p2", 200, _listing(["ck/c"]))],
        lambda s, tmp: s.list_prefix("gs://bkt/ck/"),
    ),
    "list_prefix_mtimes": (
        [("GET", r"\?prefix=ck%2F$", 200,
          {"items": [{"name": "ck/a", "updated": "2026-07-30T12:34:56.789Z"},
                     {"name": "ck/b"},
                     {"name": "ck/c", "updated": "not a stamp"}]})],
        lambda s, tmp: s.list_prefix_mtimes("gs://bkt/ck/"),
    ),
    "delete": (
        [("DELETE", r"/o/x$", 204, b""), ("DELETE", r"/o/y$", 404, b"")],
        lambda s, tmp: (s.delete("gs://bkt/x"), s.delete("gs://bkt/y")),
    ),
    "upload_download_file": (
        [("POST", r"uploadType=media&name=f", 200, b"{}"),
         ("GET", r"/o/f\?alt=media", 200, b"file bytes")],
        lambda s, tmp: _file_roundtrip(s, tmp),
    ),
}


def _file_roundtrip(storage, tmp):
    src = tmp / "src.bin"
    src.write_bytes(b"file bytes")
    storage.upload_file(src, "gs://bkt/f")
    dst = tmp / "out" / "dst.bin"
    storage.download_file("gs://bkt/f", dst)
    return dst.read_bytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_gcs_storage_sends_jax_s_requests(case, tmp_path):
    script, call = CASES[case]
    seen = {}
    for name, mod in PACKAGES.items():
        transport = RecordingTransport(script)
        (tmp_path / name).mkdir()
        result = call(mod.GcsStorage(transport), tmp_path / name)
        assert not transport.script, f"{name}: unused responses"
        seen[name] = (transport.requests, result)
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("status", [403, 404, 500])
def test_gcs_errors_match(status):
    errors = {}
    for name, mod in PACKAGES.items():
        storage = mod.GcsStorage(RecordingTransport(
            [("GET", r"alt=media", status, b"nope")] * 2
            + [("GET", r"/o/k$", status, b"nope")]))
        for call in (lambda: storage.get_bytes("gs://b/k"),
                     lambda: storage.get_range("gs://b/k", 0, 2),
                     lambda: storage.size("gs://b/k")):
            with pytest.raises(mod.GcsError) as info:
                call()
            errors.setdefault(name, []).append(
                (info.value.status, str(info.value)))
    assert errors["port"] == errors["jax"]


def test_uri_helpers_match():
    for uri in ("gs://b/k/x", "gs://b", "gs://b/"):
        assert port_gcs.split_gs_uri(uri) == jax_gcs.split_gs_uri(uri)
    for bad in ("/tmp/x", "gs:///k"):
        with pytest.raises(ValueError):
            port_gcs.split_gs_uri(bad)
        with pytest.raises(ValueError):
            jax_gcs.split_gs_uri(bad)
    assert port_gcs.is_gs_uri("gs://b/k") and not port_gcs.is_gs_uri("/x")


# -- UrllibTransport: the cases tests/test_cloud.py pins JAX's to ----------

def _urlopen_script(monkeypatch, responses):
    """urllib.request.urlopen over a scripted list: bytes are a 200 body,
    an int an HTTPError of that status."""
    calls = []

    class FakeResp:
        status = 200

        def __init__(self, data):
            self._data = data

        def read(self, *n):
            return self._data

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake_urlopen(req, timeout=None):
        calls.append(req)
        r = responses.pop(0)
        if isinstance(r, int):
            raise urllib.error.HTTPError(req.full_url, r, "err", {},
                                         io.BytesIO(b"denied"))
        return FakeResp(r)

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    return calls


@pytest.mark.parametrize("life,advance,fetches", [
    (600.0, [299.0], [1]), (600.0, [299.0, 2.0], [1, 2]),
    (120.0, [45.0], [2]), (3600.0, [3299.0, 2.0], [1, 2]),
])
def test_token_cache_follows_expires_in(monkeypatch, life, advance, fetches):
    """Cached for the reported life less the 300 s margin (at least
    30 s), in both packages on one fake clock."""
    clock = [1000.0]
    for mod in ("tony_tpu.cloud.gcp", "tony_tpu_torch.cloud.transport"):
        monkeypatch.setattr(f"{mod}.time.monotonic", lambda: clock[0])
    got = {}
    for name, cls in (("jax", JaxUrllibTransport), ("port", UrllibTransport)):
        clock[0] = 1000.0
        count = []

        def provider(count=count):
            count.append(1)
            return f"tok{len(count)}", life

        tr = cls(token_provider=provider)
        seen = [tr._bearer()]
        for dt in advance:
            clock[0] += dt
            seen.append(tr._bearer())
        got[name] = (seen, len(count))
    assert got["port"] == got["jax"]
    assert got["port"][1] == fetches[-1]


def test_bare_token_provider_is_an_hour(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr("tony_tpu_torch.cloud.transport.time.monotonic",
                        lambda: clock[0])
    tokens = iter(["a", "b"])
    tr = UrllibTransport(token_provider=lambda: next(tokens))
    assert tr._bearer() == "a"
    clock[0] += 3299.0
    assert tr._bearer() == "a"
    clock[0] += 2.0
    assert tr._bearer() == "b"


@pytest.mark.parametrize("script,want,n_calls", [
    ([401, b"ok"], (200, b"ok"), 2),
    ([403, b"ok"], (200, b"ok"), 2),
    ([403, 403], (403, b"denied"), 2),
    ([500], (500, b"denied"), 1),
])
def test_401_drops_token_and_retries_once(monkeypatch, script, want,
                                          n_calls):
    results = {}
    for name, cls in (("jax", JaxUrllibTransport), ("port", UrllibTransport)):
        tokens = iter(["stale", "fresh"])
        tr = cls(token_provider=lambda tokens=tokens: (next(tokens), 3600.0))
        calls = _urlopen_script(monkeypatch, list(script))
        got = tr.request("GET", "https://x/y", None, {"Range": "bytes=0-1"})
        results[name] = (got, [(c.get_header("Authorization"),
                                c.get_header("Range")) for c in calls])
    assert results["port"] == results["jax"]
    assert results["port"][0] == want and len(results["port"][1]) == n_calls


def test_streamed_upload_is_rewound_for_the_retry(monkeypatch):
    bodies = []

    def fake_urlopen(req, timeout=None):
        bodies.append(req.data.read())
        if len(bodies) == 1:
            raise urllib.error.HTTPError(req.full_url, 401, "err", {},
                                         io.BytesIO(b""))

        class Resp:
            status = 200

            def read(self):
                return b"done"

            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

        return Resp()

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    tr = UrllibTransport(token_provider=lambda: ("t", 3600.0))
    assert tr.request("POST", "https://x/u", io.BytesIO(b"abc"),
                      {}) == (200, b"done")
    assert bodies == [b"abc", b"abc"]


def test_request_stream_retries_once(monkeypatch):
    tokens = iter(["stale", "fresh"])
    tr = UrllibTransport(token_provider=lambda: (next(tokens), 3600.0))
    calls = _urlopen_script(monkeypatch, [401, b"body"])
    status, resp = tr.request_stream("GET", "https://x/y")
    assert status == 200 and resp.read() == b"body"
    assert [c.get_header("Authorization") for c in calls] == [
        "Bearer stale", "Bearer fresh"]


def test_default_token_provider_raises_without_credentials(monkeypatch):
    from tony_tpu_torch.cloud import transport

    monkeypatch.setattr(transport, "_metadata_token", lambda: None)
    monkeypatch.setattr(transport, "_gcloud_token", lambda: None)
    with pytest.raises(RuntimeError, match="no Google Cloud credentials"):
        transport.default_token_provider()
    monkeypatch.setattr(transport, "_gcloud_token", lambda: ("g", 1800.0))
    assert transport.default_token_provider() == ("g", 1800.0)


# -- FileObjectStorage roots across the packages --------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_file_object_storage_roots_cross_packages(tmp_path, writer, reader):
    w = PACKAGES[writer].FileObjectStorage(tmp_path)
    r = PACKAGES[reader].FileObjectStorage(tmp_path)
    w.put_bytes("gs://bkt/ck/step_2/a.npz", b"0123456789")
    w.put_bytes("gs://bkt/ck/step_2/b.json", b"{}")
    src = tmp_path / "up.bin"
    src.write_bytes(b"uploaded")
    w.upload_file(src, "gs://bkt/data/c.tokens")
    assert r.get_bytes("gs://bkt/ck/step_2/a.npz") == b"0123456789"
    assert r.get_range("gs://bkt/ck/step_2/a.npz", 3, 4) == b"3456"
    assert r.get_range("gs://bkt/ck/step_2/a.npz", 8, 10) == b"89"
    assert r.size("gs://bkt/data/c.tokens") == 8
    assert r.exists("gs://bkt/ck/step_2/b.json")
    assert not r.exists("gs://bkt/ck/step_2/missing")
    assert r.list_prefix_mtimes("gs://bkt/ck/") == w.list_prefix_mtimes(
        "gs://bkt/ck/")
    assert r.list_prefix("gs://bkt/") == [
        "ck/step_2/a.npz", "ck/step_2/b.json", "data/c.tokens"]
    r.download_file("gs://bkt/data/c.tokens", tmp_path / "dl" / "c")
    assert (tmp_path / "dl" / "c").read_bytes() == b"uploaded"
    r.delete("gs://bkt/ck/step_2/a.npz")
    assert not w.exists("gs://bkt/ck/step_2/a.npz")
    for store in (w, r):
        with pytest.raises(Exception) as info:
            store.get_bytes("gs://bkt/nope")
        assert info.value.status == 404


def test_default_storage_follows_the_emulator_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(port_cloud, "_default_storage", None)
    monkeypatch.setattr(jax_cloud, "_default_storage", None)
    monkeypatch.setenv("TONY_GCS_EMULATOR_DIR", str(tmp_path))
    store = port_cloud.default_storage()
    assert isinstance(store, port_gcs.FileObjectStorage)
    assert store.root == tmp_path and port_cloud.default_storage() is store
    # The JAX package keeps its own singleton: a write through one reads
    # in the other only through the shared root.
    jax_store = jax_cloud.default_storage()
    assert isinstance(jax_store, jax_gcs.FileObjectStorage)
    jax_store.put_bytes("gs://b/k", b"v")
    assert store.get_bytes("gs://b/k") == b"v"
    fake = port_gcs.GcsStorage(RecordingTransport([]))
    port_cloud.set_default_storage(fake)
    assert port_cloud.default_storage() is fake
    assert jax_cloud.default_storage() is jax_store
    port_cloud.set_default_storage(None)
    monkeypatch.delenv("TONY_GCS_EMULATOR_DIR")
    real = port_cloud.default_storage()
    assert isinstance(real, port_gcs.GcsStorage)
    assert isinstance(real.transport, UrllibTransport)
