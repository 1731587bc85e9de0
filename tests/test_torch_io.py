"""The port's input slice held against the JAX package on the CPU.

``ShardedRecordReader`` parity: the same files (fixed-width tokens, jsonl,
``.jblk`` containers) read by the JAX package's reader and the port's, at
task counts 1 and 2, give identical batches. ``device_prefetch`` with
``device="cpu"``: order, the depth bound, an error at its position and
sticky, ``close()`` mid-iteration, an abandoned iterator, and a closed
reader under it (mirroring tests/test_io_pipeline.py). Then
``runtime.sharded_reader`` sharding by ``RANK``/``WORLD_SIZE`` and
``sharded_batches``."""

from __future__ import annotations

import gc
import json
import time
import weakref

import numpy as np
import pytest
import torch

from tony_tpu.io import ShardedRecordReader as JaxReader
from tony_tpu.io import write_jsonl_blocks as jax_write_jsonl_blocks
from tony_tpu_torch import runtime as rt
from tony_tpu_torch.io import (
    DevicePrefetcher,
    ShardedRecordReader,
    device_prefetch,
    sharded_batches,
    write_jsonl_blocks,
)

RL = 9  # tokens per record


def _corpus(tmp_path, fmt: str) -> tuple[list[str], dict]:
    """Two files of 37 and 26 records in ``fmt`` and the reader kwargs."""
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((37, 26)):
        rows = rng.integers(0, 60000, (n, RL)).astype(np.uint16)
        if fmt == "tokens":
            path = tmp_path / f"c{i}.tokens"
            rows.tofile(path)
        elif fmt == "jsonl":
            path = tmp_path / f"c{i}.jsonl"
            path.write_text("".join(json.dumps({"tokens": r.tolist(),
                                                "i": j}) + "\n"
                                    for j, r in enumerate(rows)))
        else:
            path = tmp_path / f"c{i}.jblk"
            jax_write_jsonl_blocks(str(path), ({"tokens": r.tolist()}
                                               for r in rows),
                                   block_records=5, schema={"tokens": "list"})
        paths.append(str(path))
    kw = {"fmt": "jsonl-blocks" if fmt == "jblk" else fmt, "batch_size": 4}
    if fmt == "tokens":
        kw.update(dtype=np.uint16, record_len=RL, chunk_records=3)
    return paths, kw


def _batches(reader) -> list:
    with reader:
        return [b.tolist() if isinstance(b, np.ndarray) else b
                for b in reader]


@pytest.mark.parametrize("num_tasks", [1, 2])
@pytest.mark.parametrize("fmt", ["tokens", "jsonl", "jblk"])
def test_reader_batches_equal_the_jax_readers(tmp_path, fmt, num_tasks):
    paths, kw = _corpus(tmp_path, fmt)
    total = 0
    for task in range(num_tasks):
        want = _batches(JaxReader(paths, task, num_tasks, **kw))
        got = _batches(ShardedRecordReader(paths, task, num_tasks, **kw))
        assert got == want
        total += sum(len(b) for b in got)
    assert total == 63  # every record exactly once across the tasks
    port = ShardedRecordReader(paths, **kw)
    assert port.schema_json() == JaxReader(paths, **kw).schema_json()
    port.close()


@pytest.fixture
def gcs(tmp_path, monkeypatch):
    """Both packages' default storage on one ``FileObjectStorage`` root."""
    from tony_tpu import cloud as jax_cloud
    from tony_tpu_torch import cloud as port_cloud

    root = tmp_path / "gcs"
    monkeypatch.setattr(jax_cloud, "_default_storage",
                        jax_cloud.FileObjectStorage(root))
    monkeypatch.setattr(port_cloud, "_default_storage",
                        port_cloud.FileObjectStorage(root))
    return port_cloud.default_storage()


@pytest.mark.parametrize("num_tasks", [1, 2])
@pytest.mark.parametrize("fmt", ["tokens", "jsonl", "jblk"])
def test_reader_over_gs_equals_the_jax_readers(tmp_path, gcs, monkeypatch,
                                               fmt, num_tasks):
    """The same corpus as gs:// objects: ranged reads (tokens),
    ``RangeLineStream`` (jsonl, with a 64-byte fetch so records straddle
    fetches) and block containers give the local file's batches, in JAX's
    reader and in the port's."""
    from tony_tpu.io import storage as jax_storage
    from tony_tpu_torch.io import storage as port_storage

    monkeypatch.setattr(jax_storage.RangeLineStream, "CHUNK", 64)
    monkeypatch.setattr(port_storage.RangeLineStream, "CHUNK", 64)
    paths, kw = _corpus(tmp_path, fmt)
    uris = []
    for path in paths:
        uri = f"gs://bkt/corpus/{path.rsplit('/', 1)[1]}"
        gcs.upload_file(path, uri)
        uris.append(uri)
    for task in range(num_tasks):
        want = _batches(JaxReader(paths, task, num_tasks, **kw))
        assert _batches(JaxReader(uris, task, num_tasks, **kw)) == want
        assert _batches(ShardedRecordReader(uris, task, num_tasks, **kw)
                        ) == want


def test_range_line_stream_tells_the_first_unconsumed_byte(gcs):
    from tony_tpu.io.storage import RangeLineStream as JaxStream
    from tony_tpu_torch.io.storage import RangeLineStream

    gcs.put_bytes("gs://b/lines", b"ab\ncdef\n\ng\nlast")
    for cls in (RangeLineStream, JaxStream):
        seen = []
        with cls("gs://b/lines") as f:
            f.CHUNK = 3
            f.seek(1)
            while True:
                line = f.readline()
                seen.append((line, f.tell()))
                if not line:
                    break
        assert seen == [(b"b\n", 3), (b"cdef\n", 8), (b"\n", 9),
                        (b"g\n", 11), (b"last", 15), (b"", 15)]


def test_jblk_written_to_gs_reads_in_both_readers(gcs):
    recs = [{"tokens": [i, i + 1]} for i in range(13)]
    write_jsonl_blocks("gs://bkt/c.jblk", recs, block_records=4)
    for reader in (JaxReader, ShardedRecordReader):
        got = _batches(reader(["gs://bkt/c.jblk"], fmt="jsonl-blocks",
                              batch_size=5))
        assert [r for b in got for r in b] == recs


def test_jblk_written_by_the_port_reads_in_the_jax_reader(tmp_path):
    recs = [{"tokens": list(range(i, i + 4))} for i in range(23)]
    path = str(tmp_path / "p.jblk")
    assert write_jsonl_blocks(path, recs, block_records=4) == 23
    with JaxReader([path], fmt="jsonl-blocks", batch_size=5) as r:
        assert [rec for b in r for rec in b] == recs


def test_shuffle_matches_the_jax_reader(tmp_path):
    paths, kw = _corpus(tmp_path, "tokens")
    kw.update(shuffle=True, shuffle_pool=8, seed=3)
    assert _batches(ShardedRecordReader(paths, **kw)) == \
        _batches(JaxReader(paths, **kw))


# ---------------------------------------------------------------------------
# device_prefetch on the CPU
# ---------------------------------------------------------------------------

def _endless():
    i = 0
    while True:
        yield np.full((4,), i, np.int32)
        i += 1


def test_prefetch_keeps_order_and_gives_tensors():
    src = [np.full((2, 3), i, np.int32) for i in range(7)]
    with device_prefetch(iter(src), "cpu", depth=3) as it:
        got = list(it)
    assert [int(b[0, 0]) for b in got] == list(range(7))
    assert all(torch.is_tensor(b) and b.dtype == torch.int32 for b in got)
    pair = next(device_prefetch(iter([{"x": np.ones(2), "y": (np.zeros(1),)}]),
                                "cpu"))
    assert torch.is_tensor(pair["x"]) and torch.is_tensor(pair["y"][0])


def test_prefetch_depth_one_is_eager():
    pulled = []

    def src():
        for i in range(3):
            pulled.append(i)
            yield np.full((1,), i, np.int32)

    it = device_prefetch(src(), "cpu", depth=1)
    next(it)
    time.sleep(0.05)
    assert pulled == [0]
    next(it)
    time.sleep(0.05)
    assert pulled == [0, 1]
    it.close()


def test_prefetch_depth_bounds_the_lookahead():
    pulled = []

    def src():
        for i in range(20):
            pulled.append(i)
            yield np.full((1,), i, np.int32)

    it = device_prefetch(src(), "cpu", depth=3)
    next(it)
    time.sleep(0.2)
    assert pulled == [0, 1, 2]  # the batch in hand counts
    it.close()


def test_prefetch_source_error_surfaces_in_place_and_sticks():
    def src():
        for i in range(4):
            yield np.full((2,), i, np.int32)
        raise OSError("disk died mid-shard")

    it = device_prefetch(src(), "cpu", depth=2)
    assert [int(next(it)[0]) for _ in range(4)] == [0, 1, 2, 3]
    for _ in range(2):
        with pytest.raises(OSError, match="disk died"):
            next(it)
    it.close()


def test_prefetch_transfer_error_surfaces_in_place_and_sticks():
    def bad_put(b):
        if int(b[0]) == 2:
            raise RuntimeError("transfer rejected")
        return b

    src = (np.full((1,), i, np.int32) for i in range(5))
    it = DevicePrefetcher(src, "cpu", depth=3, put_fn=bad_put)
    assert [int(next(it)[0]) for _ in range(2)] == [0, 1]
    for _ in range(2):
        with pytest.raises(RuntimeError, match="transfer rejected"):
            next(it)
    it.close()


def test_prefetch_close_mid_iteration_is_prompt_and_terminates():
    it = device_prefetch(_endless(), "cpu", depth=2)
    next(it)
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < 3
    it._thread.join(timeout=3)
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)
    with device_prefetch(_endless(), "cpu") as ctx:
        next(ctx)
    assert not ctx._thread.is_alive()


def test_prefetch_exhausted_stream_keeps_stopping():
    it = device_prefetch(iter([np.zeros(1, np.int32)]), "cpu", depth=2)
    next(it)
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(it)
    it.close()


def test_abandoned_prefetcher_stops_its_thread():
    it = device_prefetch(_endless(), "cpu", depth=2)
    next(it)
    thread, ref = it._thread, weakref.ref(it)
    del it
    deadline = time.monotonic() + 10
    while thread.is_alive() and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.05)
    assert ref() is None and not thread.is_alive()


def test_reader_close_unblocks_the_prefetcher(tmp_path):
    path = tmp_path / "c.tokens"
    np.arange(2000 * 8, dtype=np.uint16).tofile(path)
    reader = ShardedRecordReader([str(path)], fmt="tokens", record_len=8,
                                 batch_size=4, buffer_records=64)
    it = device_prefetch(iter(reader), "cpu", depth=2)
    next(it)
    reader.close()
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < 3
    it._thread.join(timeout=3)
    assert not it._thread.is_alive()


def test_prefetch_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_prefetch(iter([np.zeros(1)]))
    with pytest.raises(ValueError, match="depth"):
        device_prefetch(iter([]), "cpu", depth=0)


# ---------------------------------------------------------------------------
# runtime.sharded_reader and sharded_batches
# ---------------------------------------------------------------------------

def test_runtime_sharded_reader_shards_by_rank(tmp_path, monkeypatch):
    paths, kw = _corpus(tmp_path, "tokens")
    seen = []
    for rank in range(3):
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("WORLD_SIZE", "3")
        reader = rt.sharded_reader(paths, **kw)
        want = _batches(JaxReader(paths, rank, 3, **kw))
        got = _batches(reader)
        assert got == want
        seen += [tuple(r) for b in got for r in b]
    assert len(seen) == len(set(seen)) == 63


class _Rank1OfDp2:
    """Rank 1 of a dp=2 mesh, as far as ``sharded_batches`` reads one
    (a real mesh needs two processes)."""

    device_type = "cpu"

    def size(self, dim: int) -> int:
        return 2 if dim == 0 else 1

    def get_local_rank(self, name: str) -> int:
        return 1 if name == "dp" else 0


def test_sharded_batches_drop_the_short_tail(tmp_path):
    paths, kw = _corpus(tmp_path, "tokens")  # 63 records, batches of 4
    reader = ShardedRecordReader(paths, **kw)
    got = list(sharded_batches(reader, device="cpu", prefetch=2))
    assert len(got) == 15 and all(tuple(b.shape) == (4, RL) for b in got)
    reader.close()
    # With a mesh the reader must be this rank's shard of the batch axes:
    # rank 1 of dp=2 feeds shard 1 of 2, not a whole-corpus reader.
    with pytest.raises(ValueError, match="batch shard 1 of 2"):
        next(sharded_batches(reader, mesh=_Rank1OfDp2(), device="cpu"))
