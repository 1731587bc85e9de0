"""The port's native data-plane library on the CPU.

The library builds here with the host compiler; its scanners agree with
the Python semantics the JAX package pins its own library to
(``tests/test_io.py``), ``pread_records`` reads whole records at span edges
and stops short at the end of the file, ``readahead`` answers a bool, and
the port's reader yields the same batches with the library on and off,
equal to the JAX reader's. The library has no fallback: without a compiler,
after a failed build or with a library that does not load, ``available()``
raises."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from tony_tpu.io import ShardedRecordReader as JaxReader
from tony_tpu_torch import kernels
from tony_tpu_torch.io import ShardedRecordReader, native

RL = 8


def _py_starts(chunk: bytes) -> list[int]:
    return [m + 1 for m in range(len(chunk) - 1) if chunk[m:m + 1] == b"\n"]


CHUNKS = [
    b'{"a":1}\n{"b":2}\n{"c":3}\npartial',
    b"",
    b"no newline",
    b"x\n",
    b"\n",
    b"\n\n\n",
    b"\nlead",
    b"a\nb\nc\n",
    b"\x00\n\xff\n\x00",
]


def test_the_library_builds_here():
    assert native.available() is True
    path = native.library_path()
    assert path.is_file() and path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libtony_io-") and path.suffix == ".so"
    assert native.build() == path  # built once: nothing to do


@pytest.mark.parametrize("chunk", CHUNKS, ids=repr)
def test_scanners_match_python(chunk):
    assert native.scan_record_starts(chunk) == _py_starts(chunk)
    assert native.count_records(chunk) == chunk.count(b"\n")


def test_scanners_on_the_jax_cases():
    chunk = b'{"a":1}\n{"b":2}\n{"c":3}\npartial'
    assert native.scan_record_starts(chunk) == [8, 16, 24]
    assert native.count_records(chunk) == 3


@pytest.fixture
def token_file(tmp_path):
    data = np.random.default_rng(0).integers(
        0, 2**16, size=(67, RL)).astype(np.uint16)
    path = tmp_path / "t.bin"
    data.tofile(path)
    fd = os.open(path, os.O_RDONLY)
    try:
        yield fd, data
    finally:
        os.close(fd)


@pytest.mark.parametrize("first,count", [
    (0, 67), (0, 1), (31, 5), (64, 3), (63, 10), (67, 4), (80, 2),
])
def test_pread_records_at_edges_and_eof(token_file, first, count):
    fd, data = token_file
    rb = RL * 2
    arr = native.pread_records(fd, first * rb, rb, count)
    assert arr.dtype == np.uint8 and arr.shape[1] == rb
    want = data[first:first + count]
    assert len(arr) == len(want)
    np.testing.assert_array_equal(arr.view(np.uint16), want)


def test_pread_records_drops_a_partial_tail_record(tmp_path):
    path = tmp_path / "odd.bin"
    path.write_bytes(bytes(range(40)))
    fd = os.open(path, os.O_RDONLY)
    try:
        arr = native.pread_records(fd, 0, 16, 3)
    finally:
        os.close(fd)
    assert arr.shape == (2, 16)
    assert bytes(arr.reshape(-1)) == bytes(range(32))


def test_pread_records_reports_io_errors_as_none(tmp_path):
    fd = os.open(tmp_path, os.O_RDONLY)  # a directory: pread fails
    try:
        assert native.pread_records(fd, 0, 16, 2) is None
    finally:
        os.close(fd)


def test_readahead_answers_a_bool(token_file, tmp_path):
    fd, _ = token_file
    assert native.readahead(fd, 0, 4096) is True
    closed = os.open(tmp_path / "t.bin", os.O_RDONLY)
    os.close(closed)
    assert native.readahead(closed, 0, 4096) is False


def _corpus(tmp_path, fmt):
    rng = np.random.default_rng(1)
    paths = []
    for i, n in enumerate((41, 30)):
        rows = rng.integers(0, 60000, (n, RL)).astype(np.uint16)
        if fmt == "tokens":
            path = tmp_path / f"c{i}.tokens"
            rows.tofile(path)
        else:
            path = tmp_path / f"c{i}.jsonl"
            path.write_text("".join(json.dumps({"tokens": r.tolist()}) + "\n"
                                    for r in rows))
        paths.append(str(path))
    kw = {"fmt": fmt, "batch_size": 4}
    if fmt == "tokens":
        kw.update(dtype=np.uint16, record_len=RL, chunk_records=3,
                  read_workers=2)
    return paths, kw


def _batches(reader) -> list:
    with reader:
        return [b.tolist() if isinstance(b, np.ndarray) else b
                for b in reader]


@pytest.mark.parametrize("num_tasks", [1, 3])
@pytest.mark.parametrize("fmt", ["tokens", "jsonl"])
def test_reader_with_and_without_the_library_equals_jax(
        tmp_path, monkeypatch, fmt, num_tasks):
    paths, kw = _corpus(tmp_path, fmt)
    calls = {"pread": 0, "readahead": 0}
    pread, readahead = native.pread_records, native.readahead

    def counted_pread(*a):
        calls["pread"] += 1
        return pread(*a)

    def counted_readahead(*a):
        calls["readahead"] += 1
        return readahead(*a)

    monkeypatch.setattr(native, "pread_records", counted_pread)
    monkeypatch.setattr(native, "readahead", counted_readahead)
    total = 0
    for task in range(num_tasks):
        want = _batches(JaxReader(paths, task, num_tasks, **kw))
        on = _batches(ShardedRecordReader(paths, task, num_tasks, **kw))
        with monkeypatch.context() as off_patch:
            off_patch.setattr(native, "available", lambda: False)
            before = dict(calls)
            off = _batches(ShardedRecordReader(paths, task, num_tasks, **kw))
            assert calls == before  # the preadv path: no native call
        assert on == off == want
        total += sum(len(b) for b in on)
    assert total == 71
    if fmt == "tokens":
        assert calls["pread"] > 0 and calls["readahead"] == calls["pread"]
    else:
        assert calls == {"pread": 0, "readahead": 0}


def test_a_short_native_read_is_an_error(tmp_path, monkeypatch):
    paths, kw = _corpus(tmp_path, "tokens")
    monkeypatch.setattr(native, "pread_records",
                        lambda fd, off, rb, n: np.empty((0, rb), np.uint8))
    with pytest.raises(RuntimeError, match="NOT exhausted") as info:
        _batches(ShardedRecordReader(paths[:1], **kw))
    assert "short read" in str(info.value.__cause__)
    monkeypatch.setattr(native, "pread_records", lambda *a: None)
    with pytest.raises(RuntimeError) as info:
        _batches(ShardedRecordReader(paths[:1], **kw))
    assert "native pread failed" in str(info.value.__cause__)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build dir and no loaded library."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


def test_a_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setenv("CXX", str(fresh_build / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.available()
    assert not native.library_path().exists()
    monkeypatch.delenv("CXX")
    monkeypatch.setenv("PATH", str(fresh_build))
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        native.available()


def test_a_failed_build_raises_with_the_compiler_output(fresh_build,
                                                       monkeypatch):
    fake = fresh_build / "cxx"
    fake.write_text("#!/bin/sh\necho 'tony_io.cc:1: error: broken'\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match="exit 3") as info:
        native.available()
    assert "error: broken" in str(info.value)
    assert not list((fresh_build / "build").iterdir())  # no tmp left over
    # Not remembered: a working compiler afterwards builds and loads.
    monkeypatch.delenv("CXX")
    assert native.available()
    assert native.library_path().parent == fresh_build / "build"


def test_a_library_that_does_not_load_raises(fresh_build):
    """A corrupt file where the build would be is loaded, fails, and
    raises: it is not silently replaced by the Python path."""
    bad = native.library_path()
    bad.parent.mkdir(parents=True)
    bad.write_bytes(b"not a library")
    with pytest.raises(RuntimeError, match="does not load"):
        native.available()
    bad.unlink()
    assert native.available()
    assert native.count_records(b"a\nb\n") == 2
