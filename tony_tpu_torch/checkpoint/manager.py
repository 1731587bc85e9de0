"""Async, per-process, differential train-state checkpointing in PyTorch.

The port's ``CheckpointManager``: the JAX package's manager with the same
constructor, env knobs, public methods and on-disk format, so either
package restores what the other wrote.

* **Format.** ``step_<n>/process_<i>.npz`` holds one raw little-endian
  uint8 blob per leaf piece, named ``<path>#s<i>``, plus ``__manifest__``
  (JSON: ``dtype``, ``shape``, ``num_shards``, ``shard_shapes``,
  ``shard_indices``, ``piece_hashes`` and, for a leaf a differential save
  did not rewrite, ``ref_step``). ``process_<i>.json`` is the commit
  sidecar (sha256 of the npz, kind, base steps) and ``metadata.json``,
  written last by process 0, the step marker (``checkpoint/layout.py``).
  Paths are ``jax.tree_util.keystr`` paths: a port ``TrainState`` is
  written under the JAX ``TrainState``'s paths (``interop.train_state_leaves``),
  any other tree under dict ``['k']``, NamedTuple ``.f`` and sequence
  ``[i]`` keys. bf16 goes through torch, never through numpy's dtype.
* **Snapshot.** The port's train step updates its state in place, so
  ``save(k, state)`` copies every leaf into pinned host buffers (reused
  across saves) before the next step may write: the copies run on a side
  CUDA stream after an event on the caller's stream, and the next write is
  ordered after them (for a ``TrainState``, a one-shot hook on the
  optimizer's ``step`` makes the caller's stream wait on the copy event;
  for any other tree the caller's stream waits at once). The encode thread
  waits on the same event before it hashes. ``background_snapshot=True``
  (reading the live state later, on the encode thread) is only safe without
  in-place updates, so the port refuses it.
* **Data-parallel states.** A rank of ``make_train_step(cfg, mesh)`` holds
  pieces of its split leaves: it writes each piece with the leaf's global
  ``shape`` and the piece's ``shard_shapes`` and ``shard_indices`` in global
  coordinates, as a JAX process writes its addressable shards. A restore
  reads its own file when the piece there lines up with the template's
  placement, and otherwise reassembles the global leaf from every file
  and cuts its piece.
* **Storage.** A local directory (fsync + atomic rename) or a ``gs://``
  prefix, written through ``cloud.default_storage()`` (``stores.py``); the
  torn-step GC reads an object store's ages against the newest ``updated``
  stamp of its own listing, not the local clock.
* **Fault injection.** The persist stage obeys the ``TONY_FAULT_PLAN``
  checkpoint faults (``resilience/faults.py``): delayed, failed and
  partial (torn) writes.
* **Pipeline, differential saves, fallback, GC, flush signal,
  cross-topology restore**: as in the JAX package (``pipeline.py``,
  ``differential.py``, ``layout.py``).
* **Metrics**, in the default registry under the JAX package's names and
  buckets: ``tony_ckpt_snapshot_ms`` (what ``save`` takes on the caller's
  thread: a set of pinned host buffers, allocated by the first saves of a
  process and reused after, and issuing the copies on CUDA; the copies
  themselves on the CPU),
  ``tony_ckpt_persist_ms`` (serialize, write, commit), the pipeline's
  ``tony_ckpt_queue_depth``, the shard bytes written as
  ``tony_ckpt_bytes_total{kind=full|diff}``, and, on process 0, the newest
  complete step as ``tony_ckpt_committed_step``. As in the JAX package
  there is no restore metric.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from tony_tpu_torch import constants
from tony_tpu_torch.checkpoint import layout
from tony_tpu_torch.checkpoint.differential import DiffTracker, hash_pieces
from tony_tpu_torch.checkpoint.pipeline import SavePipeline
from tony_tpu_torch.checkpoint.stores import _ObjectCheckpointStore, store_for
from tony_tpu_torch.interop import (
    load_train_state,
    train_state_leaves,
    train_state_placements,
)
from tony_tpu_torch.models.train import TrainState
from tony_tpu_torch.resilience.faults import checkpoint_faults_from_env

log = logging.getLogger(__name__)

_MANIFEST = "__manifest__"

# Declared metric names, the JAX package's: snapshot = what save() costs
# the train loop; persist = the background serialize+write+commit wall;
# queue depth = saves in flight behind the bounded pipeline; bytes = shard
# bytes written, labeled kind=full|diff; committed step = the newest
# complete step (process 0), which the heartbeat piggyback carries to the
# coordinator's goodput ledger.
CKPT_SNAPSHOT_HISTOGRAM = "tony_ckpt_snapshot_ms"
CKPT_PERSIST_HISTOGRAM = "tony_ckpt_persist_ms"
CKPT_QUEUE_DEPTH_GAUGE = "tony_ckpt_queue_depth"
CKPT_BYTES_COUNTER = "tony_ckpt_bytes_total"
CKPT_COMMITTED_GAUGE = layout.CKPT_COMMITTED_GAUGE
_SNAPSHOT_BUCKETS = (1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0, 5000.0,
                     10000.0)


def _registry():
    from tony_tpu_torch.observability.metrics import default_registry

    return default_registry()


def _observe_ms(name: str, value_ms: float) -> None:
    try:
        _registry().histogram(name, buckets=_SNAPSHOT_BUCKETS).observe(
            value_ms
        )
    except ValueError:  # a foreign registry squatting the name
        pass


def _set_gauge(name: str, value: float) -> None:
    try:
        _registry().gauge(name).set(value)
    except ValueError:
        pass


def _count_bytes(kind: str, n: int) -> None:
    try:
        _registry().counter(
            CKPT_BYTES_COUNTER, labels={"kind": kind}
        ).inc(n)
    except ValueError:
        pass

# Manifest dtype names (numpy's, and ml_dtypes' "bfloat16") <-> torch.
_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def _as_tensor(value: Any) -> torch.Tensor:
    """A leaf as a tensor (no copy where it can be avoided): tensors as
    they are, numpy arrays and scalars through torch (an ml_dtypes bf16
    array through its uint16 bits)."""
    if torch.is_tensor(value):
        return value.detach()
    arr = np.asarray(value)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy()  # keeps a 0-d array 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _encode(t: torch.Tensor) -> np.ndarray:
    """Raw little-endian bytes of a host tensor as a flat uint8 array (a
    view): the blob format of the JAX manager's ``_encode``."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _decode(raw: np.ndarray, dtype: str, shape: list[int]) -> torch.Tensor:
    if dtype not in _DTYPES:
        raise ValueError(f"checkpoint dtype {dtype!r} is not supported")
    flat = torch.from_numpy(np.ascontiguousarray(raw).view(np.uint8))
    return flat.view(_DTYPES[dtype]).reshape(shape)


def _keystr_leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(keystr path, leaf) of a tree of dicts (sorted keys), NamedTuples
    and sequences, as ``jax.tree_util`` flattens it; None is empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _keystr_leaves(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += _keystr_leaves(getattr(tree, f), f"{prefix}.{f}")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += _keystr_leaves(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _is_train_state(tree: Any) -> bool:
    return isinstance(tree, TrainState) and isinstance(
        tree.opt_state, torch.optim.Optimizer)


def _tree_leaves(tree: Any) -> list[tuple[str, Any]]:
    return (train_state_leaves(tree) if _is_train_state(tree)
            else _keystr_leaves(tree))


def _unflatten(tree: Any, values: dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), values,
                                       f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, values, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return values[prefix]


def _place(template: Any, value: torch.Tensor) -> Any:
    """A restored host tensor in the template leaf's kind: a tensor on the
    template's device, else a numpy array (numpy has no bfloat16: such a
    leaf needs a tensor template)."""
    if torch.is_tensor(template):
        return value.to(template.device)
    return value.numpy()


def _placements(tree: Any) -> dict[str, Any]:
    """{path: Placement} of a data-parallel TrainState's split and
    replicated leaves; empty for any other tree."""
    return train_state_placements(tree) if _is_train_state(tree) else {}


def _span(shape, placement) -> tuple[tuple[int, ...], list[list[int]]]:
    """(global shape, [start, stop] per dim) of a leaf of local ``shape``
    with ``placement`` (None: the whole leaf)."""
    if placement is None:
        return tuple(shape), [[0, int(d)] for d in shape]
    return (tuple(placement.global_shape),
            [[a, b] for a, b in placement.index])


def _leaf_info(t: torch.Tensor, placement=None) -> dict:
    shape, index = _span(t.shape, placement)
    return {"dtype": _NAMES[t.dtype], "shape": list(shape), "num_shards": 1,
            "shard_shapes": [list(t.shape)], "shard_indices": [index]}


class _CorruptStepError(Exception):
    """A step that listed as complete turned out unreadable (checksum
    mismatch, vanished donor, missing blob): readers fall back to the
    previous complete step instead of surfacing an exception."""


class _HostBuffers:
    """Sets of host buffers, one tensor per leaf, carved from one pinned
    block per set (when any leaf lives on CUDA). A save takes a set and the
    persist stage gives it back, so the ~state-sized pinned allocation is
    paid once, not per save; at most ``pipeline_depth + 1`` sets exist."""

    _ALIGN = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._free: list[tuple[tuple, dict[str, torch.Tensor]]] = []

    def take(self, leaves: list[tuple[str, torch.Tensor]],
             pin: bool) -> tuple[tuple, dict[str, torch.Tensor]]:
        key = (pin,) + tuple((p, tuple(t.shape), t.dtype) for p, t in leaves)
        with self._lock:
            for i, (k, bufs) in enumerate(self._free):
                if k == key:
                    del self._free[i]
                    return key, bufs
            self._free.clear()  # another structure: drop stale sets
        sizes = [t.numel() * t.element_size() for _, t in leaves]
        offsets, total = [], 0
        for n in sizes:
            offsets.append(total)
            total += -(-n // self._ALIGN) * self._ALIGN
        block = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=pin)
        bufs = {}
        for (path, t), off, n in zip(leaves, offsets, sizes):
            bufs[path] = block[off:off + n].view(t.dtype).view(t.shape)
        return key, bufs

    def give(self, key: tuple, bufs: dict[str, torch.Tensor]) -> None:
        with self._lock:
            self._free.append((key, bufs))

    def clear(self) -> None:
        with self._lock:
            self._free.clear()


class _SaveJob:
    __slots__ = ("step", "snapped", "ready", "buffers")

    def __init__(self, step, snapped, ready, buffers):
        self.step = step
        self.snapped = snapped  # [(path, host tensor, info)]
        self.ready = ready      # CUDA events the host copies complete at
        self.buffers = buffers  # (key, set) to give back after persisting


class _PersistPayload:
    __slots__ = ("step", "manifest", "blobs", "kind", "base_steps",
                 "buffers")

    def __init__(self, step, manifest, blobs, kind, base_steps, buffers):
        self.step = step
        self.manifest = manifest
        self.blobs = blobs
        self.kind = kind
        self.base_steps = base_steps
        self.buffers = buffers


class FlushSignal:
    """The user-process half of the coordinator's checkpoint-flush order
    (live migration / evict-time flush). The executor writes the signal
    file when a ``ckpt_flush`` command rides its heartbeat reply;
    ``requested(step)`` turns True exactly once per order, at the first
    step at or past the order's target."""

    def __init__(self, path: str | os.PathLike[str] | None = None) -> None:
        if path is None:
            path = os.environ.get(constants.TONY_CKPT_FLUSH_FILE)
        self._path = Path(path) if path else None
        self._served: str | None = None

    @property
    def active(self) -> bool:
        return self._path is not None

    def requested(self, step: int | None = None) -> bool:
        if self._path is None:
            return False
        try:
            raw = self._path.read_text()
        except OSError:
            return False
        try:
            req = json.loads(raw)
        except ValueError:
            return False
        if not isinstance(req, dict):
            return False
        req_id = str(req.get("req_id", "") or "")
        if not req_id or req_id == self._served:
            return False
        target = req.get("step")
        if target is not None and step is not None:
            try:
                if int(step) < int(target):
                    return False
            except (TypeError, ValueError):
                pass
        self._served = req_id
        return True


class CheckpointManager:
    def __init__(
        self,
        directory: str | os.PathLike[str],
        *,
        process_id: int = 0,
        num_processes: int = 1,
        max_to_keep: int = 3,
        torn_gc_grace_s: float = 300.0,
        pipeline_depth: int | None = None,
        persist_workers: int | None = None,
        differential: bool | None = None,
        full_every: int | None = None,
        background_snapshot: bool | None = None,
    ) -> None:
        bg = (background_snapshot if background_snapshot is not None
              else _env_bool(constants.TONY_CKPT_BG_SNAPSHOT, False))
        if bg:
            raise ValueError(
                "background_snapshot=True reads the state after save() "
                "returns, which is only safe when the train step does not "
                "update its state in place; the port's step always does, "
                "so every save copies its snapshot before returning"
            )
        self._store: Any = store_for(directory)
        self.directory: Any = getattr(
            self._store, "directory", str(directory)
        )
        self.process_id = process_id
        self.num_processes = num_processes
        self.max_to_keep = max_to_keep
        # Torn (incomplete) dirs are only GC'd once quiescent for this long,
        # so process 0 can't delete a straggler's in-flight older-step write
        # out from under it when processes desync.
        self.torn_gc_grace_s = torn_gc_grace_s
        depth = (pipeline_depth if pipeline_depth is not None
                 else _env_int(constants.TONY_CKPT_PIPELINE_DEPTH, 2))
        workers = (persist_workers if persist_workers is not None
                   else _env_int(constants.TONY_CKPT_PERSIST_WORKERS, 1))
        self._diff = DiffTracker(
            full_every=(full_every if full_every is not None
                        else _env_int(constants.TONY_CKPT_FULL_EVERY, 5)),
            enabled=(differential if differential is not None
                     else _env_bool(constants.TONY_CKPT_DIFFERENTIAL, True)),
        )
        self._pipeline = SavePipeline(
            self._encode_job, self._persist_payload,
            depth=depth, workers=workers,
            on_depth=lambda d: _set_gauge(CKPT_QUEUE_DEPTH_GAUGE, d),
        )
        self._buffers = _HostBuffers()
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self._commit_lock = threading.Lock()
        self.last_committed_step: int | None = None
        self._flush = FlushSignal()

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        """Snapshot ``state`` at ``step``: every leaf is copied to host
        buffers ordered before any later in-place write (see the module
        note), so the caller may run the next step at once; encoding,
        differential planning, serialization and the commit run on the
        pipeline's threads, up to ``pipeline_depth`` saves in flight.
        Raises a prior async save's failure; ``blocking=True`` drains the
        pipeline and persists inline (the pre-exit final save)."""
        self._raise_pending()
        if blocking:
            self.wait()
            self._persist_payload(
                self._encode_job(self._snapshot_job(step, state)))
            return
        self._pipeline.submit(self._snapshot_job(step, state))

    def _copy_stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def _snapshot_job(self, step: int, state: Any) -> _SaveJob:
        t0 = time.monotonic()
        leaves = [(path, _as_tensor(v)) for path, v in _tree_leaves(state)]
        on_cuda = [(p, t) for p, t in leaves if t.is_cuda]
        key, bufs = self._buffers.take(leaves, pin=bool(on_cuda))
        ready = []
        by_device: dict[torch.device, list] = {}
        for path, t in on_cuda:
            by_device.setdefault(t.device, []).append((path, t))
        for device, group in by_device.items():
            caller = torch.cuda.current_stream(device)
            side = self._copy_stream(device)
            side.wait_event(caller.record_event())
            with torch.cuda.stream(side):
                for path, t in group:
                    bufs[path].copy_(t, non_blocking=True)
                    # The caller may drop a leaf (an old step counter)
                    # before the copy ran: keep its memory until then.
                    t.record_stream(side)
                done = side.record_event()
            ready.append(done)
            if _is_train_state(state):
                self._wait_before_update(state.opt_state, caller, done)
            else:
                caller.wait_event(done)
        for path, t in leaves:
            if not t.is_cuda:
                bufs[path].copy_(t)
        placements = _placements(state)
        snapped = [(path, bufs[path], _leaf_info(t, placements.get(path)))
                   for path, t in leaves]
        _observe_ms(CKPT_SNAPSHOT_HISTOGRAM,
                    (time.monotonic() - t0) * 1000.0)
        return _SaveJob(step, snapped, ready, (key, bufs))

    @staticmethod
    def _wait_before_update(opt: torch.optim.Optimizer,
                            stream: torch.cuda.Stream,
                            done: torch.cuda.Event) -> None:
        """Order the optimizer's next in-place update after the snapshot's
        copies: the next step's forward and backward only read the state,
        so they overlap the copies, and only ``opt.step`` waits."""
        def hook(optimizer, args, kwargs):
            stream.wait_event(done)
            handle.remove()

        handle = opt.register_step_pre_hook(hook)

    def _encode_job(self, job: _SaveJob) -> _PersistPayload:
        """Snapshot/encode stage (strictly ordered): wait for the host
        copies, hash every leaf's encoded pieces, and plan the
        differential."""
        try:
            for event in job.ready:
                event.synchronize()
            manifest: dict[str, dict] = {}
            encoded: dict[str, list[np.ndarray]] = {}
            leaf_hashes: dict[str, tuple[str, ...]] = {}
            for path, host, info in job.snapped:
                enc = [_encode(host)]
                info = dict(info)
                hashes = hash_pieces(enc)
                info["piece_hashes"] = list(hashes)
                manifest[path] = info
                encoded[path] = enc
                leaf_hashes[path] = hashes
            plan = self._diff.plan(job.step, leaf_hashes)
        except BaseException:
            self._buffers.give(*job.buffers)
            raise
        blobs: dict[str, np.ndarray] = {}
        for path, enc in encoded.items():
            ref = plan.refs.get(path)
            if ref is not None:
                manifest[path]["ref_step"] = ref
                continue
            for i, piece in enumerate(enc):
                blobs[f"{path}#s{i}"] = piece
        return _PersistPayload(job.step, manifest, blobs, plan.kind,
                               plan.base_steps, job.buffers)

    def _persist_payload(self, payload: _PersistPayload) -> None:
        """Persist stage: serialize, write the shard, the commit sidecar
        and (process 0) the step marker, publish telemetry, then GC.
        Fault injection (``tony.fault.plan`` via ``TONY_FAULT_PLAN``) lands
        where a real disk or GCS failure would, as in the JAX package:
        ``delay`` sleeps here (the wall stays off the step path), ``error``
        raises into the pipeline's surfaced-failure path, and ``partial``
        writes the shard but withholds sidecar and marker, a torn step
        that readers never see."""
        step = payload.step
        t0 = time.monotonic()
        partial = False
        try:
            faults = checkpoint_faults_from_env()
            if faults is not None:
                delay_ms = faults.write_delay_ms(step)
                if delay_ms:
                    time.sleep(delay_ms / 1000.0)
                faults.maybe_fail_write(step)
                partial = faults.partial_write(step)
            buf = io.BytesIO()
            np.savez(
                buf,
                **payload.blobs,
                **{_MANIFEST: np.frombuffer(
                    json.dumps(payload.manifest).encode(), dtype=np.uint8
                )},
            )
        finally:
            payload.blobs = None
            self._buffers.give(*payload.buffers)
        data = buf.getvalue()
        self._store.put_file(step, layout.shard_name(self.process_id), data)
        if partial:
            log.error(
                "fault injection: checkpoint step %d shard written but "
                "commit withheld (partial write)", step,
            )
            return
        self._store.put_file(
            step, layout.sidecar_name(self.process_id),
            json.dumps({
                "step": step,
                "kind": payload.kind,
                "sha256": hashlib.sha256(data).hexdigest(),
                "base_steps": payload.base_steps,
            }).encode(),
        )
        if self.process_id == 0:
            # The step marker: a step is restorable only once this AND
            # all num_processes shard+sidecar files exist.
            self._store.put_file(
                step, layout.MARKER,
                json.dumps({
                    "step": step,
                    "num_processes": self.num_processes,
                    "format": layout.LAYOUT_FORMAT,
                }).encode(),
            )
        with self._commit_lock:
            if (self.last_committed_step is None
                    or step > self.last_committed_step):
                self.last_committed_step = step
        _observe_ms(CKPT_PERSIST_HISTOGRAM,
                    (time.monotonic() - t0) * 1000.0)
        _count_bytes(payload.kind, len(data))
        if self.process_id == 0:
            # The committed-step gauge is GLOBAL, not per-process: process
            # 0, the marker writer, reads the reader-side completeness rule
            # and publishes the newest COMPLETE step (a lagging peer makes
            # it conservative, never early); other processes publish
            # nothing.
            entries = self._store.step_entries()
            complete = self._complete_steps(entries)
            if complete:
                _set_gauge(CKPT_COMMITTED_GAUGE, float(complete[-1]))
            self._gc(entries, complete)
        log.info("checkpoint step %d committed (%s, %d bytes) under %s",
                 step, payload.kind, len(data), self.directory)

    def _raise_pending(self) -> None:
        try:
            self._pipeline.raise_pending()
        except RuntimeError:
            # A failed persist may own leaves later diffs were planned
            # against: the next save after a surfaced failure is full.
            self._diff.reset()
            raise

    def wait(self) -> None:
        """Block until every in-flight async save is durable; re-raises
        the first pipeline failure if one occurred."""
        try:
            self._pipeline.drain()
        except RuntimeError:
            self._diff.reset()
            raise

    def close(self) -> None:
        """Stop the save pipeline's threads and drop the host buffer sets;
        a later async ``save`` raises. Saves still in flight are not
        waited for: drain first (``wait()``, or a blocking save). Not in
        the JAX package, whose manager lives as long as its process."""
        self._pipeline.close()
        self._buffers.clear()

    # -- flush signal (live migration) --------------------------------------
    def flush_requested(self, step: int | None = None) -> bool:
        """True exactly once per coordinator flush order, at the first
        ``step`` at or past the order's target: the train loop should
        then ``save(step, state)`` out of band."""
        return self._flush.requested(step)

    # -- restore ------------------------------------------------------------
    def _complete_steps(self, entries=None) -> list[int]:
        return layout.complete_steps(
            self._store, self.num_processes, entries
        )

    def latest_step(self) -> int | None:
        steps = self._complete_steps()
        return steps[-1] if steps else None

    def restore_resumable(self, state_template: Any) -> Any | None:
        """Coordinator-assisted resume: when ``TONY_RESUME_STEP`` is set
        (the newest step the coordinator saw complete before retrying),
        restore that exact step first, and fall back to the newest
        complete step when it is gone, torn or corrupt. Behaves like
        plain ``restore`` outside a retried session."""
        resume = os.environ.get(constants.TONY_RESUME_STEP)
        if resume:
            try:
                step = int(resume)
            except ValueError:
                log.warning("ignoring bad TONY_RESUME_STEP=%r", resume)
            else:
                restored = self.restore(state_template, step=step)
                if restored is not None:
                    return restored
                log.warning(
                    "TONY_RESUME_STEP=%d is not restorable here — "
                    "falling back to the newest complete step", step,
                )
        return self.restore(state_template)

    def restore(self, state_template: Any, step: int | None = None) -> Any | None:
        """Load the newest complete checkpoint (or ``step``, if complete)
        into the structure of ``state_template``. Returns None when nothing
        restorable exists (including an explicit ``step`` that is missing,
        torn, or fails its shard checksum).

        A port ``TrainState`` is restored in place: its step, params and
        AdamW state are overwritten (``interop.load_train_state``) and the
        same state is returned. Any other tree comes back as a new tree of
        that structure: tensors on the template leaf's device, numpy
        arrays elsewhere. Every leaf is read and verified before anything
        is written, so a step found unreadable leaves the template as it
        was, and (without an explicit ``step``) the next older complete
        step is tried.

        A checkpoint written by another number of processes is
        reassembled from every process's shard file by the manifest's
        shard coordinates, as the JAX manager does."""
        complete = self._complete_steps()
        if step is not None:
            if step not in complete:
                return None
            candidates = [step]
        else:
            candidates = list(reversed(complete))
        for cand in candidates:
            try:
                values = self._restore_step(cand, state_template)
            except _CorruptStepError as exc:
                log.warning(
                    "checkpoint step %d is unreadable (%s) — falling "
                    "back to the previous complete step", cand, exc,
                )
                continue
            if _is_train_state(state_template):
                return load_train_state(state_template, values)
            leaves = dict(_tree_leaves(state_template))
            return _unflatten(state_template, {
                p: _place(leaves[p], v) for p, v in values.items()})
        return None

    def _restore_step(self, step: int,
                      state_template: Any) -> dict[str, torch.Tensor]:
        """{path: host tensor} of every template leaf at ``step``."""
        saved_n = self._saved_num_processes(step)
        force_cross = False
        own_id = self.process_id
        if self.process_id >= saved_n:
            # This rank did not exist when the checkpoint was written:
            # every leaf reassembles from the donor files.
            own_id, force_cross = 0, True
        files: dict[tuple[int, int], tuple[dict, Any]] = {}
        try:
            own = self._read_shard_file(step, own_id, files)
            if own is None:  # deleted between listing and read
                raise _CorruptStepError("own shard file vanished")
            manifest, _ = own
            placements = _placements(state_template)
            values = {}
            for key, leaf in _tree_leaves(state_template):
                info = manifest.get(key)
                if info is None:
                    raise ValueError(
                        f"checkpoint step {step} is missing leaf {key!r} — "
                        f"model/optimizer structure changed since it was "
                        f"written"
                    )
                local = tuple(getattr(leaf, "shape", ()))
                placement = placements.get(key)
                shape, index = _span(local, placement)
                if not force_cross and self._fast_path_ok(shape, local,
                                                          index, info):
                    values[key] = self._leaf_pieces(step, own_id, key, info,
                                                    files)[0]
                    continue
                whole = self._restore_leaf_cross_topology(
                    shape, info, key, step, saved_n, files)
                values[key] = (whole[placement.region()].clone()
                               if placement is not None and placement.sharded
                               else whole)
            return values
        finally:
            for _, npz in files.values():
                npz.close()

    def _saved_num_processes(self, step: int) -> int:
        meta = layout.parse_metadata(self._store.get_file(step, layout.MARKER))
        return layout.metadata_num_processes(meta, self.num_processes)

    def _read_shard_file(
        self, step: int, process_id: int,
        cache: dict[tuple[int, int], tuple[dict, Any]] | None = None,
    ) -> tuple[dict, Any] | None:
        """(manifest, open NpzFile), via ``cache`` when given, verified
        against the commit sidecar's sha256 when there is one; a mismatch
        raises ``_CorruptStepError``."""
        key = (step, process_id)
        if cache is not None and key in cache:
            return cache[key]
        raw = self._store.get_file(step, layout.shard_name(process_id))
        if raw is None:
            return None
        sidecar = layout.parse_sidecar(
            self._store.get_file(step, layout.sidecar_name(process_id))
        )
        if sidecar is not None and sidecar.get("sha256"):
            digest = hashlib.sha256(raw).hexdigest()
            if digest != sidecar["sha256"]:
                raise _CorruptStepError(
                    f"shard process_{process_id}.npz at step {step} fails "
                    f"its commit checksum"
                )
        data = np.load(io.BytesIO(raw))
        manifest = json.loads(bytes(data[_MANIFEST]).decode())
        entry = (manifest, data)
        if cache is not None:
            cache[key] = entry
        return entry

    def _leaf_pieces(
        self, step: int, process_id: int, key: str, info: dict,
        files: dict[tuple[int, int], tuple[dict, Any]],
    ) -> list[torch.Tensor]:
        """Decode ``key``'s pieces for one process, following the
        differential reference when the manifest says the bytes live in
        an earlier step's shard file."""
        src_step = int(info.get("ref_step", step))
        entry = self._read_shard_file(src_step, process_id, files)
        if entry is None:
            raise _CorruptStepError(
                f"differential base step {src_step} for leaf {key!r} "
                f"(process {process_id}) vanished"
            )
        _, npz = entry
        pieces = []
        for i in range(info["num_shards"]):
            blob = f"{key}#s{i}"
            try:
                raw = npz[blob]
            except KeyError:
                raise _CorruptStepError(
                    f"leaf {key!r} piece {i} missing from step "
                    f"{src_step}'s shard file"
                ) from None
            pieces.append(_decode(raw, info["dtype"],
                                  info["shard_shapes"][i]))
        return pieces

    @staticmethod
    def _fast_path_ok(shape: tuple, local: tuple, index: list,
                      info: dict) -> bool:
        """True when this process's single piece is exactly the template's
        piece: the same global ``shape``, the same ``local`` shape and
        (when the manifest records it) the same ``index`` in global
        coordinates. A multi-process save of a replicated leaf records the
        global shape, a split one only a slab of it."""
        recorded = info.get("shard_indices")
        return (
            info["num_shards"] == 1
            and tuple(info["shape"]) == shape
            and tuple(info["shard_shapes"][0]) == local
            and (recorded is None or recorded[0] == index)
        )

    def _restore_leaf_cross_topology(
        self, t_shape: tuple, info: dict, key: str, step: int, saved_n: int,
        files: dict[tuple[int, int], tuple[dict, Any]],
    ) -> torch.Tensor:
        """Reassemble ``key``'s global value from every process's recorded
        shard coordinates."""
        shape = tuple(info["shape"])
        if shape != t_shape:
            raise ValueError(
                f"leaf {key!r}: checkpoint global shape {shape} does not "
                f"match the template's {t_shape} — the model/optimizer "
                f"definition changed since the checkpoint was written"
            )
        if info.get("shard_indices") is None:
            raise ValueError(
                f"leaf {key!r}: the checkpoint predates shard-coordinate "
                f"manifests (pre-r5) and its topology differs from the "
                f"template's — restore with the same num_processes/mesh "
                f"that saved it, or re-save under the current format"
            )
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"checkpoint dtype {info['dtype']!r} is not "
                             f"supported")
        out = torch.empty(shape, dtype=_DTYPES[info["dtype"]])
        filled = torch.zeros(shape, dtype=torch.bool) if shape else None
        wrote_any = False
        for p in range(saved_n):
            entry = self._read_shard_file(step, p, files)
            if entry is None:
                raise _CorruptStepError(
                    f"shard file for process {p} vanished during "
                    f"cross-topology restore of step {step}"
                )
            p_manifest, _ = entry
            p_info = p_manifest.get(key)
            if p_info is None:
                raise ValueError(
                    f"leaf {key!r}: missing from process {p}'s shard file "
                    f"at step {step} — inconsistent checkpoint"
                )
            pieces = self._leaf_pieces(step, p, key, p_info, files)
            for i, index in enumerate(p_info["shard_indices"]):
                region = tuple(slice(a, b) for a, b in index)
                out[region] = pieces[i]
                wrote_any = True
                if filled is not None:
                    filled[region] = True
            # Replicated leaves are saved full-span by every process:
            # stop at full coverage.
            if wrote_any and (filled is None or bool(filled.all())):
                break
        if filled is not None and not bool(filled.all()):
            raise ValueError(
                f"leaf {key!r}: the union of all processes' shards does "
                f"not cover the global array at step {step} — torn or "
                f"inconsistent checkpoint"
            )
        return out

    # -- gc -----------------------------------------------------------------
    def _gc(self, entries=None, complete=None) -> None:
        """Process 0 prunes old steps — complete ones beyond ``max_to_keep``
        AND torn/incomplete dirs older than the oldest kept complete step —
        EXCEPT donor steps a kept differential step still reads bytes
        from. ``entries``/``complete`` let the persist stage share its one
        listing pass."""
        if self.process_id != 0 or not self.max_to_keep:
            return
        if entries is None:
            entries = self._store.step_entries()
        if complete is None:
            complete = self._complete_steps(entries)
        kept = set(complete[-self.max_to_keep:])
        protected = layout.referenced_steps(
            self._store, kept, self.num_processes
        )
        threshold = min(kept) if kept else None
        now = self._now_reference(entries)
        for n, (_, newest) in entries.items():
            if n in kept or n in protected:
                continue
            stale_complete = n in set(complete)
            torn_and_old = (
                n not in complete
                and threshold is not None
                and n < threshold
                and self._quiescent(newest, now)
            )
            if stale_complete or torn_and_old:
                self._store.delete_step(n)

    def _now_reference(
        self, entries: dict[int, tuple[set[str], float | None]]
    ) -> float | None:
        """The clock the quiescence check reads ages against. An object
        store's ``updated`` stamps are the server's time, so "now" is the
        newest stamp of the same listing (server-clock deltas: client clock
        skew cannot eat into or inflate the grace window); filesystem
        mtimes come from the local clock, so ``time.time()``. None: no
        usable stamp, so nothing is quiescent."""
        if isinstance(self._store, _ObjectCheckpointStore):
            stamps = [t for _, t in entries.values() if t is not None]
            return max(stamps) if stamps else None
        return time.time()

    def _quiescent(self, newest: float | None, now: float | None) -> bool:
        """True when nothing under the step was modified within the grace
        window; an unknown age (None) reads as active."""
        if newest is None or now is None:
            return False
        return (now - newest) > self.torn_gc_grace_s
