"""Runtime helpers for training scripts that the orchestrator launches with
``--framework pytorch``: the port's counterpart of ``tony_tpu.runtime``.

The executor's PyTorch runtime injects ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` and ``CLUSTER_SPEC`` (and no local rank), so
a script needs one call before touching the card::

    import tony_tpu_torch.runtime as rt
    ctx = rt.initialize()       # ctx.device: this process's card

Outside a job, or in a job of one process, ``initialize`` only picks the
device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import torch

from tony_tpu_torch import constants
from tony_tpu_torch.device import resolve_device


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


def initialize(device="cuda") -> TaskContext:
    """Pick this process's device and, in a world larger than one, join the
    ``torch.distributed`` process group (NCCL on CUDA, gloo on the CPU) at
    ``MASTER_ADDR:MASTER_PORT``. On CUDA the device is ``cuda:<local
    rank>``, the process's index among the tasks on its host (from
    ``CLUSTER_SPEC``; 0 without one), unless ``device`` names an index."""
    ctx = task_context()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        spec = cluster_spec()
        index = local_rank(spec, ctx.process_id) if spec else 0
        dev = torch.device("cuda", index)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if ctx.is_distributed:
        torch.distributed.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{ctx.coordinator_address}",
            world_size=ctx.num_processes, rank=ctx.process_id,
        )
    return dataclasses.replace(ctx, device=str(dev))


def tensorboard_port() -> int | None:
    raw = os.environ.get(constants.TB_PORT)
    return int(raw) if raw else None
