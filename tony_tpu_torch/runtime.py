"""Runtime helpers for training scripts that the orchestrator launches with
``--framework pytorch``: the port's counterpart of ``tony_tpu.runtime``.

The executor's PyTorch runtime injects ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` and ``CLUSTER_SPEC`` (and no local rank), so
a script needs one call before touching the card::

    import tony_tpu_torch.runtime as rt
    ctx = rt.initialize()       # ctx.device: this process's card
    mesh = rt.build_job_mesh(device=ctx.device)   # None alone

Outside a job, or in a job of one process, ``initialize`` only picks the
device and ``build_job_mesh`` returns None (``make_train_step(cfg, None)``
is the single-device step). ``sharded_reader`` hands the script a record
reader over its own byte range of the corpus.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from datetime import timedelta

import torch

from tony_tpu_torch import constants
from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.parallel.mesh import build_mesh


@dataclass(frozen=True)
class TaskContext:
    job_name: str
    task_index: int
    task_num: int
    session_id: str
    process_id: int
    num_processes: int
    coordinator_address: str | None
    # The torch device ``initialize`` chose ("" before it ran).
    device: str = ""

    @property
    def is_distributed(self) -> bool:
        return self.coordinator_address is not None and self.num_processes > 1


def task_context() -> TaskContext:
    """The task's identity from the injected env: ``process_id`` and
    ``num_processes`` are ``RANK`` and ``WORLD_SIZE``, the coordinator is
    ``MASTER_ADDR:MASTER_PORT``."""
    env = os.environ
    addr, port = env.get(constants.MASTER_ADDR), env.get(constants.MASTER_PORT)
    return TaskContext(
        job_name=env.get(constants.JOB_NAME, "worker"),
        task_index=int(env.get(constants.TASK_INDEX, "0")),
        task_num=int(env.get(constants.TASK_NUM, "1")),
        session_id=env.get(constants.SESSION_ID, "0"),
        process_id=int(env.get(constants.RANK, "0")),
        num_processes=int(env.get(constants.WORLD_SIZE, "1")),
        coordinator_address=f"{addr}:{port}" if addr and port else None,
    )


def cluster_spec() -> dict[str, list[str]] | None:
    raw = os.environ.get(constants.CLUSTER_SPEC)
    return json.loads(raw) if raw else None


def local_rank(spec: dict[str, list[str]], rank: int,
               chief_name: str = "worker") -> int:
    """This process's index among the tasks on its host. Ranks follow the
    executor's order (the chief job type first, then the others
    alphabetically, indices in order); the host is the part of a task's
    ``host:port`` before the last colon."""
    if chief_name not in spec:
        raise ValueError(f"no {chief_name!r} tasks in cluster spec")
    ordered = sorted(spec, key=lambda j: (j != chief_name, j))
    hosts = [addr.rpartition(":")[0] for job in ordered for addr in spec[job]]
    if not 0 <= rank < len(hosts):
        raise ValueError(f"rank {rank} outside a cluster of {len(hosts)}")
    return hosts[:rank].count(hosts[rank])


def initialize(device="cuda", *, init_method: str | None = None,
               timeout_s: float = 300.0) -> TaskContext:
    """Pick this process's device and, in a world larger than one, join the
    ``torch.distributed`` process group (NCCL on CUDA, gloo on the CPU) at
    ``MASTER_ADDR:MASTER_PORT`` (or ``init_method``, e.g. a ``file://``
    store). On CUDA the device is ``cuda:<local rank>``, the process's index
    among the tasks on its host (from ``CLUSTER_SPEC``; 0 without one),
    unless ``device`` names an index.

    Every collective of the group, the rendezvous included, fails after
    ``timeout_s`` instead of waiting for a peer that died (300 s is
    ``jax.distributed.initialize``'s default, which the JAX package
    relies on).

    First of all it wires the compile cache (``plan.configure_compile_cache``
    from the executor's ``TONY_COMPILE_CACHE_*``): the kernels build into,
    and load from, the configured dir, so a retried or resumed session of
    an unchanged program builds nothing. Last, with
    ``TONY_PROFILE_HBM_INTERVAL_MS`` set and not "0", it starts the HBM gauge
    monitor (``observability.profiling``) at that interval."""
    from tony_tpu_torch.parallel.plan import configure_compile_cache

    configure_compile_cache()
    ctx = task_context()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        spec = cluster_spec()
        index = local_rank(spec, ctx.process_id) if spec else 0
        dev = torch.device("cuda", index)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(dev)
    if ctx.is_distributed:
        torch.distributed.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method or f"tcp://{ctx.coordinator_address}",
            world_size=ctx.num_processes, rank=ctx.process_id,
            timeout=timedelta(seconds=timeout_s),
        )
    # Continuous device-memory telemetry: per-card HBM gauges sampled on a
    # daemon thread into the default registry, so the snapshot that rides
    # heartbeats shows memory pressure BEFORE an out-of-memory error. A
    # no-op on the CPU (CUDA never came up).
    hbm_ms = os.environ.get(constants.TONY_PROFILE_HBM_INTERVAL_MS)
    if hbm_ms and hbm_ms != "0":
        from tony_tpu_torch.observability.profiling import (
            start_device_memory_monitor,
        )

        try:
            start_device_memory_monitor(interval_s=int(hbm_ms) / 1000.0)
        except (ValueError, TypeError):
            pass
    return dataclasses.replace(ctx, device=str(dev))


def tensorboard_port() -> int | None:
    raw = os.environ.get(constants.TB_PORT)
    return int(raw) if raw else None


def sharded_reader(paths: list[str], *, task_index: int | None = None,
                   num_tasks: int | None = None, **kwargs):
    """A ``ShardedRecordReader`` over ``paths`` sharded by this process's
    identity (``RANK`` of ``WORLD_SIZE``), so every record is read exactly
    once across the job::

        reader = rt.sharded_reader(files, fmt="tokens", record_len=2049)
        for batch in reader: ...

    ``task_index`` of ``num_tasks`` reads another sharding, e.g. one shard
    a data row of the job mesh (``parallel.mesh.data_row``), whose ranks
    feed the same rows. All ``ShardedRecordReader`` keyword arguments pass
    through."""
    from tony_tpu_torch.io.reader import ShardedRecordReader

    ctx = task_context()
    return ShardedRecordReader(
        paths,
        task_index=ctx.process_id if task_index is None else task_index,
        num_tasks=ctx.num_processes if num_tasks is None else num_tasks,
        **kwargs,
    )


def slice_topology() -> dict | None:
    """The coordinator's planned slice for this job type (num_slices,
    hosts_per_slice, ...) from ``TONY_SLICE_TOPOLOGY``, or None when the
    job was not planned onto slices."""
    raw = os.environ.get(constants.TONY_SLICE_TOPOLOGY)
    return json.loads(raw) if raw else None


def build_job_mesh(spec=None, device="cuda", *, timeout_s: float = 300.0):
    """This job's mesh (``parallel.build_mesh``) over the process group
    ``initialize`` joined, with the slice count from
    ``TONY_SLICE_TOPOLOGY`` (1 without it): dp is the outer axis, so only
    the gradient mean crosses slices (on GPUs a slice is a node). With no
    ``spec`` the world is factored as the JAX package does (tp first, then
    sp and pp; two processes give tp 2, four tp 2 x sp 2, eight pp 2 x sp
    2 x tp 2), which is what the train and generate CLIs take. Under such
    a mesh the ranks of one data row (``parallel.mesh.data_row``) must
    feed the same rows, and the model must split over tp (its heads, K/V
    heads, d_ff and vocab; ``make_train_step`` refuses it otherwise).
    Returns None without a process group (a job of one process)::

        ctx = rt.initialize()
        mesh = rt.build_job_mesh(device=ctx.device)
        init_fn, step_fn = make_train_step(cfg, mesh, device=ctx.device)
    """
    if not (torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        return None
    plan = slice_topology()
    num_slices = int(plan["num_slices"]) if plan else 1
    return build_mesh(spec, device, num_slices=num_slices,
                      timeout_s=timeout_s)
