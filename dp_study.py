#!/usr/bin/env python3
"""Data-, tensor-, sequence- and pipeline-parallel training of
tony_tpu_torch across the cards of one host.

    python3 dp_study.py             # one rank on each card (at least 2)
    python3 dp_study.py --ranks 4
    python3 dp_study.py --ep 2      # an MoE trunk over dp = ranks/2 x ep 2
    python3 dp_study.py --ranks 2 --tp 2   # the dense trunk over tp 2
    python3 dp_study.py --ranks 4 --tp 2   # dp 2 x tp 2
    python3 dp_study.py --ranks 2 --sp 2   # one [1, 16384] sequence over sp 2
    python3 dp_study.py --ranks 4 --sp 2 --tp 2        # MeshSpec.auto(4)
    python3 dp_study.py --ranks 4 --sp 4 --seq 65536   # [1, 65536] over sp 4
    python3 dp_study.py --ranks 2 --pp 2   # GPipe over 8 microbatches
    python3 dp_study.py --ranks 4 --pp 4 --schedule interleaved --virtual 2
    python3 dp_study.py --ranks 4 --pp 2 --tp 2        # pp 2 x tp 2
    python3 dp_study.py --ranks 4 --pp 2               # dp 2 x pp 2
    python3 dp_study.py --ranks 2 --pp 2 --microbatches 0  # stack over pp
    python3 dp_study.py --ranks 4 --ep 2 --tp 2   # bench_moe over ep 2 x tp 2
    python3 dp_study.py --ranks 4 --ep 2 --sp 2   # bench_moe over ep 2 x sp 2
    python3 dp_study.py --ranks 4 --ep 2 --pp 2 --microbatches 2
    python3 dp_study.py --ranks 2 --moe --tp 2    # bench_moe over tp 2 alone
    python3 dp_study.py --ranks 4 --cli   # the train CLI on the job mesh

Builds the kernels once, then starts one process per card, each in its own
session, on cuda:<rank>: they meet at a TCP store on a free localhost port,
join one NCCL group (process-group timeout
DP_TIMEOUT_S) and build the job mesh (dp = ranks, or with ``--ep E`` dp =
ranks / E x ep = E over an MoE trunk, or with ``--tp T`` dp = ranks / T x
tp = T over the dense trunk, Megatron-split, or with ``--sp S`` dp = ranks
/ (S x T) x sp = S x tp = T, each rank holding a block of the sequence and
the attention a ring over sp, or with ``--pp P`` dp = ranks / (P x T) x pp
= P x tp = T, each rank holding L/P layers of the dense trunk and running
them as a stage of ``--schedule`` over ``--microbatches`` microbatches, or
with ``--microbatches 0`` the trunk whole on every pp rank with the layer
stack gathered over pp); the parent waits on one deadline and kills and
reaps every rank still alive. ``--ep E`` (or ``--moe`` at ep 1) trains
bench_moe's MoE trunk instead of the dense one and composes with ``--tp``,
``--sp`` and ``--pp``: dp = ranks / (E x P x S x T). The ranks of one data
row (its pp, sp and tp ranks) feed the same rows. Each rank:

1. parity — fp32, TF32 off, chip_smoke's PARITY_TRAIN model (2 layers, d
   256, GQA 16/4, seq 256): 3 steps of make_train_step(cfg, mesh), each
   rank fed its slice of a global batch of 2 x ranks rows, from the same
   weights; rank 0 also runs the mesh=None step on the whole global batch
   on its card, before it joins the group (a world above 1 refuses
   mesh=None). The losses must agree to PARITY_LOSS_RTOL and each
   gathered gradient of the first step (averaged over dp and clipped) to
   chip_smoke's TRAIN_GRAD_TOL times its leaf's largest |gradient|. A
   failed check is raised after the rank has left the group, so its peers
   never wait on it. With ``--ep``: chip_smoke's MOE_PARITY model at
   capacity factor E, where nothing drops (each rank's capacity is local,
   one process's global, so with drops the two keep other tokens). With
   ``--pp``: PARITY_TRAIN's widths at 8 layers (which pp x virtual stages
   divide), 8 rows a data row, through the same trunk and schedule as the
   step; an MoE trunk through GPipe over one microbatch (a microbatch's
   router statistics enter the balance loss, which is not linear in them,
   so only one microbatch a data row gives mesh=None's loss; the CPU tests
   and chip_smoke hold more microbatches against their references).
2. step — bench_transformer (bf16, 199.8 M parameters) at chip_smoke's
   batch per rank, [8, 2049], so the global batch is 8 x ranks rows: the
   mesh step's median (10 after 2 warm-ups, CUDA events) beside the
   mesh=None step on the same card alone, timed before the rank joins the
   group and after it leaves; the
   launches of B1-B4 on the mesh path; then one more mesh step, profiled
   on rank 0: device ms of the NCCL kernels and of everything else. With
   ``--ep``: bench_moe (bf16, 502 M parameters, chip_smoke's BENCH_MOE)
   at [4, 2049] per data row, each card holding E / ep of the experts
   (over tp their F / tp columns, over sp a block of the positions, over
   pp its L / pp layers). With
   ``--tp``: [8, 2049] per data row, each card holding its tp block. With
   ``--sp``: bench.py's transformer_16k_hd128 (bench_transformer's widths
   with 8 heads of 128, no remat) at [1, seq + 1] per data row (``--seq``,
   default 16384), each rank training its block of seq / sp positions;
   the mesh=None step on one card alone trains
   the whole sequence, and an out-of-memory error there is recorded, not
   raised. The mesh step is profiled on rank 0 and on the last rank of the
   sp axis, whose causal rings differ: device ms of NCCL, of B1-B3 and of
   the rest. With ``--pp``: bench_transformer at [8, 2049] per data row,
   every rank's step profiled: device ms of NCCL and of its SendRecv
   kernels (the stage-to-stage sends), the busy share (device time outside
   NCCL over the step median) beside ``schedule_info``'s bubble fraction,
   and the ms of one send of a microbatch's activations between the pp
   ranks (the shortest SendRecv kernel of sends made after a barrier),
   from which the SendRecv time spent waiting for the peer is the
   SendRecv ms less the sends times that.
3. decode (``--tp`` above 1 without ``--pp`` only) — chip_smoke's
   flagship serving model (d 1024, 8 layers, GQA 16/4), or with an MoE
   trunk chip_smoke's MOE_DECODE trunk with 4 experts (routed decode;
   over ep each card holds 2 of them), through
   DecodeSession(mesh=): fp32 greedy
   tokens of batch 8 (prompt 32, 16 new) equal to the session without a
   mesh on rank 0's card alone; then bf16 at bench.py's decode shape
   (batch 8, prompt 128), the ms per token the wall difference of 512 and
   256 new tokens over 256, beside the same on rank 0's card alone; then
   one call of 32 new tokens split up: its wall, the host ms inside the
   collective calls, and (rank 0) the device ms of a profiled call, NCCL
   apart, and the host ops with the most self time in a call under a CPU
   profiler.

Each rank logs its phases with the seconds since it started. Prints each
rank's results as a JSON line, the cards' names and power limits, and a
summary JSON line last. Exits non-zero if a rank fails or a check does not
hold.

``--cli`` runs none of that: it runs the train CLI (``python -m
tony_tpu_torch.train``) as a job of ``--ranks`` processes, each with the
environment the executor exports (``RANK``, ``WORLD_SIZE``, ``MASTER_*``,
``CLUSTER_SPEC``), so the CLI builds the job mesh with no spec (four
ranks: tp 2 x sp 2) and reads its corpus by data row, at
bench_transformer's width on a corpus of CLI_RECORDS records of [2049]
tokens from ``--seed``, batch 8 a data row. First fp32, CLI_PARITY_STEPS
steps on the job and on one process: the first step's loss, as the CLI
prints it (4 decimals), must agree within CLI_LOSS_ATOL. Then bf16,
CLI_STEPS steps on the job and on one process: the ms of the steps the
CLI times (steps 5, 10 and the last: one step's wall with its loss
readback), every rank's. Each run's output is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

import chip_smoke

DP_TIMEOUT_S = 60.0
DEADLINE_S = 600.0
# --cli: the records of the corpus (12 batches of 8, one epoch), the timed
# run's steps, the parity runs' steps (the CLI fails a run whose loss does
# not fall, so one step is not enough) and the loss's tolerance (the CLI
# prints 4 decimals).
CLI_RECORDS = 96
CLI_STEPS = 12
CLI_PARITY_STEPS = 2
CLI_LOSS_ATOL = 2e-4
PARITY_STEPS = 3
PARITY_ROWS_PER_RANK = 2
# --pp: the parity model at the step's depth (pp x virtual stages divide
# 8 layers) and 8 rows a data row (the microbatches divide them).
PP_PARITY_LAYERS, PP_PARITY_ROWS = 8, 8
# --pp: sends of one microbatch's activations timed between ready ranks.
P2P_REPEATS = 20
# --sp: bench.py's transformer_16k_hd128 (bench_transformer's widths, 8
# heads of 128, MHA, bf16, no remat) on one sequence a data row.
SP_MODEL = dict(chip_smoke.BENCH_TRANSFORMER, n_heads=8, head_dim=128)
SP_SEQ, SP_BATCH = 16384, 1
# The decode phase of --tp: fp32 parity (batch, prompt, new tokens), then
# bench.py's bench_decode shape in bf16 (batch 8, prompt 128) with the per
# token ms from two horizons (2x and 4x its 128 new tokens).
DECODE_PARITY = dict(batch=8, prompt=32, new=16)
DECODE_BATCH, DECODE_PROMPT = 8, 128
DECODE_LENGTHS = (256, 512)
# New tokens of the one generate call whose host and device time decode
# splits up.
DECODE_WINDOW = 32
# fp32 on the card, TF32 off: the global mean is a mean of the ranks'
# means, summed in another order than one process's mean (the CPU tests
# of the same path read ~1e-7).
PARITY_LOSS_RTOL = 1e-5

_T0 = time.perf_counter()


def _log(rank: int, msg: str) -> None:
    print(f"[rank {rank} {time.perf_counter() - _T0:7.1f} s] {msg}",
          flush=True)


def _gathered(tensors: list, placements: list, mesh) -> list:
    """Each tensor of a mesh state (a parameter, or its gradient), its
    split dimensions gathered."""
    from tony_tpu_torch.parallel import all_gather_tp

    out = []
    for t, pl in zip(tensors, placements):
        t = t.detach()
        for dim, entry in enumerate(pl.spec):
            if entry is not None:
                t = all_gather_tp(t, dim, entry, mesh=mesh)
        out.append(t)
    return out


def trunk(job: dict) -> dict:
    """make_train_step's pipeline arguments of ``job`` (none without
    --pp or with --microbatches 0)."""
    if job["pp"] == 1 or not job["microbatches"]:
        return {}
    return dict(pipeline_microbatches=job["microbatches"],
                pipeline_schedule=job["schedule"],
                pipeline_virtual=job["virtual"])


def parity_trunk(job: dict) -> dict:
    """The parity run's pipeline arguments: the step's, but GPipe over one
    microbatch for an MoE trunk (see the module note)."""
    if job["moe"] and trunk(job):
        return dict(pipeline_microbatches=1)
    return trunk(job)


def parity_rows(job: dict) -> int:
    return PP_PARITY_ROWS if job["pp"] > 1 else PARITY_ROWS_PER_RANK


def _parity_setup(torch, rows: int, seed: int, job: dict):
    from tony_tpu_torch.models import TransformerConfig, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = (dict(chip_smoke.MOE_PARITY,
                  capacity_factor=float(chip_smoke.MOE_PARITY["n_experts"]))
             if job["moe"] else chip_smoke.PARITY_TRAIN)
    if job["pp"] > 1:
        model = dict(model, n_layers=PP_PARITY_LAYERS)
    cfg = TransformerConfig(dtype="float32", remat=False, **model)
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed + 4)
    batches = [torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (parity_rows(job) * rows, cfg.max_seq + 1)))
        for _ in range(PARITY_STEPS)]
    return cfg, params, batches


def _run(torch, step_fn, state, batches) -> tuple:
    """(state, losses, the first step's gradients)."""
    from tony_tpu_torch.models.train import leaves

    losses, grads = [], None
    for tokens in batches:
        state, metrics = step_fn(state, tokens)
        losses.append(metrics["loss"])
        if grads is None:
            grads = [p.grad.clone() for p in leaves(state.params)]
    return state, chip_smoke._loss_list(torch, losses), grads


def parity_reference(torch, rows: int, device, seed: int,
                     job: dict) -> dict:
    """The mesh=None step on the whole global batches of ``rows`` data
    rows (rank 0, before it joins the group)."""
    from tony_tpu_torch.models import make_train_step
    from tony_tpu_torch.models.train import leaves

    cfg, params, batches = _parity_setup(torch, rows, seed, job)
    init_fn, step_fn = make_train_step(cfg, device=device)
    state, losses, grads = _run(torch, step_fn, init_fn(params=params),
                                batches)
    return {"losses": losses, "grads": grads,
            "params": leaves(state.params)}


def parity(torch, mesh, row: int, rows: int, device, seed: int, job: dict,
           ref: dict | None) -> dict:
    """The mesh step on data row ``row``'s slices (of ``rows``); rank 0
    holds the losses and the first step's gathered gradients against
    ``ref`` (``parity_reference``); "ok" says whether they held."""
    from tony_tpu_torch.models import make_train_step
    from tony_tpu_torch.models.train import leaves

    cfg, params, batches = _parity_setup(torch, rows, seed, job)
    n = parity_rows(job)
    init_fn, step_fn = make_train_step(cfg, mesh, device=device,
                                       **parity_trunk(job))
    state, losses, grads = _run(
        torch, step_fn, init_fn(params=params),
        [t[row * n:(row + 1) * n] for t in batches])
    placements = leaves(state.placements)
    grads = _gathered(grads, placements, mesh)
    full = _gathered(leaves(state.params), placements, mesh)
    out = {"losses": losses, "ok": True}
    if ref is not None:
        grad_err = max((a - b).abs().max().item()
                       / b.abs().max().clamp_min(1e-30).item()
                       for a, b in zip(grads, ref["grads"]))
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, ref["losses"]))
        param_err = max((a - b).abs().max().item()
                        for a, b in zip(full, ref["params"]))
        out.update(ref_losses=ref["losses"], loss_rel_err=loss_err,
                   worst_grad_rel_err=grad_err,
                   worst_param_abs_err=param_err,
                   ok=(loss_err <= PARITY_LOSS_RTOL
                       and grad_err <= chip_smoke.TRAIN_GRAD_TOL))
    return out


def step_model(job: dict) -> tuple[dict, int, int]:
    """(model config fields, rows, sequence length) of the timed step of
    ``job`` (its ep, sp and seq)."""
    if job["moe"]:
        return chip_smoke.BENCH_MOE, chip_smoke.MOE_BATCH, chip_smoke.TRAIN_SEQ
    if job["sp"] > 1:
        model = dict(SP_MODEL, max_seq=job["seq"])
        return model, SP_BATCH, job["seq"]
    return chip_smoke.BENCH_TRANSFORMER, chip_smoke.TRAIN_BATCH, \
        chip_smoke.TRAIN_SEQ


def _step_setup(torch, row: int, device, seed: int, job: dict):
    from tony_tpu_torch.models import TransformerConfig

    model, rows, seq = step_model(job)
    cfg = TransformerConfig(dtype="bfloat16", **model)
    rng = np.random.default_rng(seed + 3 + row)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (rows, seq + 1)), device=device)
    return cfg, tokens


def plain_step_ms(torch, row: int, device, seed: int, job: dict) -> dict:
    """The mesh=None step on this card alone (outside the group). With
    --sp, an out-of-memory error is the reading (the whole sequence may
    not fit one card)."""
    from tony_tpu_torch.models import make_train_step

    cfg, tokens = _step_setup(torch, row, device, seed, job)
    init_fn, step_fn = make_train_step(cfg, device=device)
    try:
        _, ms, peak, ws = chip_smoke.timed_steps(torch, step_fn,
                                                 init_fn(seed), tokens)
    except torch.cuda.OutOfMemoryError as exc:
        if job["sp"] == 1:
            raise
        oom = str(exc)[:300]
    else:
        return {"step_ms_median": float(np.median(ms)), "step_ms": ms,
                "working_set_gb": ws / 1e9, "peak_memory_gb": peak / 1e9}
    peak = torch.cuda.max_memory_allocated(device)
    del init_fn, step_fn
    torch.cuda.empty_cache()
    return {"out_of_memory": oom, "peak_memory_gb": peak / 1e9}


def mesh_step_ms(torch, mesh, rank: int, row: int, device, seed: int,
                 job: dict, profiled: bool) -> dict:
    """The mesh step: median, working set, launches of B1-B4, and one more
    step, profiled where ``profiled`` (the others run it unprofiled); with
    --pp the ms of one send between ready pp ranks (``p2p_ms``)."""
    from tony_tpu_torch.models import make_train_step
    from tony_tpu_torch.ops import attention, norms

    cfg, tokens = _step_setup(torch, row, device, seed, job)
    init_fn, step_fn = make_train_step(cfg, mesh, device=device,
                                       **trunk(job))
    state = init_fn(seed)
    norms.launches = 0
    attention.launches = attention.launches_dq = 0
    attention.launches_dkv = 0
    state, ms, peak, ws = chip_smoke.timed_steps(torch, step_fn, state,
                                                 tokens)
    launches = {"rms_norm": norms.launches, "flash_fwd": attention.launches,
                "flash_bwd_dq": attention.launches_dq,
                "flash_bwd_dkv": attention.launches_dkv}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"mesh path")
    summary = None
    if profiled:
        events, wall_ms = chip_smoke.device_events(
            torch, lambda: step_fn(state, tokens))
        summary = _profile_summary(events, wall_ms)
    else:
        step_fn(state, tokens)
        torch.cuda.synchronize(device)
    out = {"step_ms_median": float(np.median(ms)), "step_ms": ms,
           "working_set_gb": ws / 1e9, "peak_memory_gb": peak / 1e9,
           "launches": launches, "profiled_step": summary}
    if job["pp"] > 1 and trunk(job):
        out.update(pipeline_reading(torch, mesh, cfg, tokens, job,
                                    out["step_ms_median"], summary))
    return out


def pipeline_reading(torch, mesh, cfg, tokens, job: dict, step_ms: float,
                     summary: dict) -> dict:
    """The schedule's ticks and bubble fraction (``schedule_info``); the
    busy share: the profiled step's device time outside NCCL over the
    step median (the profiler stretches the profiled step's own wall);
    and the ms of one send of a microbatch's activations [rows / m, T, d]
    between the pp ranks: the shortest SendRecv kernel of P2P_REPEATS
    sends made after a barrier, under the profiler (a kernel's own device
    time, without the host's gaps between sends). The SendRecv ms of a
    step beyond sends x that is time spent waiting for the peer."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tony_tpu_torch.parallel import ppermute, schedule_info

    m, pp = job["microbatches"], job["pp"]
    info = schedule_info(job["schedule"], m, pp, cfg.n_layers,
                         job["virtual"])
    x = torch.zeros((tokens.shape[0] // m, tokens.shape[1] - 1, cfg.d_model),
                    dtype=cfg.compute_dtype, device=tokens.device)
    ppermute((x,), "pp", mesh=mesh)
    dist.barrier()
    torch.cuda.synchronize()
    # One profiled run on every rank, never retried: a rank that sent
    # again alone would wait for peers that do not.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(P2P_REPEATS):
            ppermute((x,), "pp", mesh=mesh)
        torch.cuda.synchronize()
    kernels = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "sendrecv" in e.name.lower())
    p2p_ms = kernels[0] if kernels else None
    # A send after every tick but the last, forward and backward.
    sends = 2 * (info.ticks - 1)
    return {"ticks": info.ticks, "bubble_fraction": info.bubble_fraction,
            "busy_share": (summary["device_ms"] - summary["nccl_ms"])
            / step_ms,
            "sends_per_step": sends, "send_mb": x.numel()
            * x.element_size() / 1e6, "p2p_ms": p2p_ms,
            "p2p_median_ms": kernels[len(kernels) // 2] if kernels else None,
            "sendrecv_wait_ms": (summary["sendrecv_ms"] - sends * p2p_ms
                                 if kernels else None)}


# The decode phase's MoE trunk: chip_smoke's MOE_DECODE (bench.py's
# bench_moe_decode) at its E 4 point, routed.
MOE_DECODE_MODEL = dict(chip_smoke.MOE_DECODE, n_experts=4,
                        moe_decode_mode="routed")


def _decode_setup(torch, device, seed: int, dtype: str, shape: tuple,
                  moe: bool = False):
    """The flagship serving model (``moe``: MOE_DECODE_MODEL) in ``dtype``
    from ``seed`` on ``device`` and a prompt of ``shape`` (the same on
    every rank)."""
    from tony_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(dtype=dtype, **(
        MOE_DECODE_MODEL if moe else chip_smoke.FLAGSHIP))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 9)
    params = init_params(cfg, gen, device=device)
    prompt = torch.as_tensor(np.random.default_rng(seed + 10).integers(
        0, cfg.vocab_size, shape), device=device)
    return cfg, params, prompt


def decode_ms(torch, session, prompt) -> dict:
    """ms per token of ``session.generate``: the wall difference of the
    two DECODE_LENGTHS horizons over their difference in tokens (after one
    warm-up call of each)."""
    def wall(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.generate(prompt, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    short, long = DECODE_LENGTHS
    wall(short)
    wall(long)
    walls = {n: wall(n) for n in DECODE_LENGTHS}
    return {"ms_per_token": (walls[long] - walls[short]) * 1e3
            / (long - short), "wall_s": walls}


def decode_reference(torch, device, seed: int, moe: bool) -> dict:
    """Rank 0 alone, before it joins the group: the fp32 greedy tokens of
    the session without a mesh, and its bf16 ms per token."""
    from tony_tpu_torch.models import DecodeSession

    p = DECODE_PARITY
    cfg, params, prompt = _decode_setup(torch, device, seed, "float32",
                                        (p["batch"], p["prompt"]), moe)
    tokens = DecodeSession(params, cfg, device=device).generate(
        prompt, p["new"]).cpu()
    del params
    cfg, params, prompt = _decode_setup(torch, device, seed, "bfloat16",
                                        (DECODE_BATCH, DECODE_PROMPT), moe)
    session = DecodeSession(params, cfg, device=device)
    timing = decode_ms(torch, session, prompt)
    return {"tokens": tokens, "bf16": timing,
            "anatomy": decode_anatomy(torch, session, prompt, 0)}


def mesh_decode(torch, mesh, device, seed: int, ref: dict | None,
                moe: bool) -> dict:
    """DecodeSession(mesh=): fp32 greedy tokens (held against ``ref`` on
    rank 0), then the bf16 ms per token and the anatomy of one call."""
    import torch.distributed as dist

    from tony_tpu_torch.models import DecodeSession

    p = DECODE_PARITY
    cfg, params, prompt = _decode_setup(torch, device, seed, "float32",
                                        (p["batch"], p["prompt"]), moe)
    tokens = DecodeSession(params, cfg, device=device, mesh=mesh).generate(
        prompt, p["new"]).cpu()
    del params
    cfg, params, prompt = _decode_setup(torch, device, seed, "bfloat16",
                                        (DECODE_BATCH, DECODE_PROMPT), moe)
    session = DecodeSession(params, cfg, device=device, mesh=mesh)
    out = {"bf16": decode_ms(torch, session, prompt),
           "anatomy": decode_anatomy(torch, session, prompt,
                                     dist.get_rank()),
           "ok": True}
    if ref is not None:
        out["tokens_equal"] = bool(torch.equal(tokens, ref["tokens"]))
        out["plain_bf16"] = ref["bf16"]
        out["plain_anatomy"] = ref["anatomy"]
        out["ok"] = out["tokens_equal"]
    return out


def _profile_summary(events, wall_ms: float) -> dict:
    """Device ms in all, in NCCL kernels, in B1-B3 (the flash kernels)
    and in the rest, and the 12 kernels that took the most."""
    nccl = sum(us for name, us in events if "nccl" in name.lower())
    sendrecv = [us for name, us in events
                if "nccl" in name.lower() and "sendrecv" in name.lower()]
    flash = sum(us for name, us in events if "flash_" in name)
    total = sum(us for _, us in events)
    by_name: dict[str, list[float]] = {}
    for name, us in events:
        by_name.setdefault(name, []).append(us)
    top = sorted(((sum(v), k, len(v)) for k, v in by_name.items()),
                 reverse=True)[:12]
    return {"wall_ms": wall_ms, "device_ms": total / 1e3,
            "nccl_ms": nccl / 1e3, "attention_ms": flash / 1e3,
            "sendrecv_ms": sum(sendrecv) / 1e3,
            "sendrecv_kernels": len(sendrecv),
            "other_ms": (total - nccl) / 1e3,
            "top": [{"kernel": k[:90], "device_ms": us / 1e3, "count": c}
                    for us, k, c in top]}


def decode_anatomy(torch, session, prompt, rank: int) -> dict:
    """One generate of DECODE_WINDOW new tokens: its wall, the host ms
    spent inside the collective calls (every rank), and on rank 0 the
    device ms of a second, profiled call (NCCL and the rest)."""
    import torch.distributed as dist

    host = {"calls": 0, "ms": 0.0}
    real = {name: getattr(dist, name)
            for name in ("all_reduce", "all_gather_into_tensor")}

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            host["calls"] += 1
            host["ms"] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, fn in real.items():
        setattr(dist, name, timed(fn))
    try:
        session.generate(prompt, DECODE_WINDOW)
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    out = {"new_tokens": DECODE_WINDOW,
           "wall_ms": (time.perf_counter() - t0) * 1e3,
           "host_ms_in_collectives": host["ms"],
           "collective_calls": host["calls"]}
    if rank == 0:
        events, wall_ms = chip_smoke.device_events(
            torch, lambda: session.generate(prompt, DECODE_WINDOW))
        out["profiled"] = _profile_summary(events, wall_ms)
        out["host_top"] = host_profile(torch, lambda: session.generate(
            prompt, DECODE_WINDOW))
    else:
        for _ in range(2):
            session.generate(prompt, DECODE_WINDOW)
            torch.cuda.synchronize()
    return out


def host_profile(torch, fn) -> list[dict]:
    """The 15 host ops (and CUDA runtime calls) with the most self time
    in one run of ``fn`` under a CPU-only profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:15]
    return [{"op": e.key[:80], "self_ms": e.self_cpu_time_total / 1e3,
             "count": e.count} for e in rows]


def run_rank(rank: int, world: int, store: str, outdir: str,
             seed: int, job: dict) -> None:
    """One rank: the mesh=None runs outside the process group (a world
    above 1 refuses mesh=None), the mesh runs inside it."""
    import torch
    import torch.distributed as dist

    import tony_tpu_torch.runtime as rt
    from tony_tpu_torch.parallel import MeshSpec
    from tony_tpu_torch.parallel.mesh import data_row

    ep, pp, sp, tp = job["ep"], job["pp"], job["sp"], job["tp"]
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    # The data row is the rank's (dp, ep) coordinate. The last rank of the
    # first row's sp axis runs the ring with the most chunks; over pp every
    # stage is profiled.
    spec = MeshSpec(dp=world // (pp * ep * sp * tp), pp=pp, ep=ep, sp=sp,
                    tp=tp)
    row, rows = data_row(spec, rank)
    profiled = pp > 1 or rank in (0, (sp - 1) * tp)
    out = {"rank": rank, "world": world, "row": row,
           "card": torch.cuda.get_device_name(device)}
    _log(rank, "started")
    ref = (parity_reference(torch, rows, device, seed, job) if rank == 0
           else None)
    # Decode is a tp reading: a pp mesh replicates the session over pp.
    decode = tp > 1 and pp == 1
    dec_ref = (decode_reference(torch, device, seed, job["moe"])
               if rank == 0 and decode else None)
    out["plain_before"] = plain_step_ms(torch, row, device, seed, job)
    _log(rank, "mesh=None timed; joining the group")
    dist.init_process_group("nccl", init_method=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=DP_TIMEOUT_S))
    try:
        mesh = rt.build_job_mesh(spec, device="cuda",
                                 timeout_s=DP_TIMEOUT_S)
        _log(rank, "mesh built")
        out["parity"] = parity(torch, mesh, row, rows, device, seed, job,
                               ref)
        _log(rank, f"parity {out['parity']}")
        out["mesh"] = mesh_step_ms(torch, mesh, rank, row, device, seed,
                                   job, profiled)
        _log(rank, "mesh step timed")
        if decode:
            out["decode"] = mesh_decode(torch, mesh, device, seed, dec_ref,
                                        job["moe"])
            _log(rank, f"decode {out['decode']}")
    finally:
        dist.destroy_process_group()
    out["plain_after"] = plain_step_ms(torch, row, device, seed, job)
    Path(outdir, f"rank_{rank}.json").write_text(json.dumps(out))
    if not out["parity"]["ok"]:
        raise AssertionError(f"parity failed: {out['parity']}")
    if not out.get("decode", {"ok": True})["ok"]:
        raise AssertionError(f"decode failed: {out['decode']}")


def launch(world: int, seed: int, job: dict) -> list[dict]:
    """One process per rank, each in its own session; one deadline; every
    rank still alive is killed and reaped at the end."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="tony-dp-") as tmp:
        procs = []
        try:
            for rank in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, "--rank", str(rank),
                     "--ranks", str(world),
                     "--store", f"tcp://127.0.0.1:{port}",
                     "--outdir", tmp, "--seed", str(seed),
                     *(f"--{k}={v}" for k, v in job.items()
                       if k != "moe"), *(["--moe"] if job["moe"] else [])],
                    # The ranks share this host: NCCL's bootstrap stays on
                    # the loopback interface.
                    env={**os.environ, "NCCL_SOCKET_IFNAME": "lo"},
                    start_new_session=True))
            deadline = time.monotonic() + DEADLINE_S
            for proc in procs:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.0))
            failed = [r for r, p in enumerate(procs) if p.returncode != 0]
            if failed:
                raise AssertionError(f"ranks {failed} failed")
            return [json.loads(Path(tmp, f"rank_{r}.json").read_text())
                    for r in range(world)]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def run_cli(world: int, argv: list[str], outdir: Path, tag: str) -> list[str]:
    """The train CLI as a job of ``world`` processes, each in its own
    session with the environment the executor's PyTorch runtime exports
    (all on this host, so rank r's card is cuda:r); one deadline, every
    process still alive killed and reaped at the end. Returns each rank's
    standard output."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cluster = json.dumps({"worker": [f"127.0.0.1:{port + 1 + r}"
                                     for r in range(world)]})
    env = {**os.environ, "NCCL_SOCKET_IFNAME": "lo",
           "PYTHONPATH": str(Path(__file__).resolve().parent),
           "WORLD_SIZE": str(world), "CLUSTER_SPEC": cluster}
    if world > 1:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    procs, logs = [], []
    try:
        for rank in range(world):
            log = outdir / f"{tag}.{rank}.log"
            logs.append(log)
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tony_tpu_torch.train", *argv],
                    env={**env, "RANK": str(rank), "TASK_INDEX": str(rank)},
                    stdout=out, stderr=subprocess.STDOUT,
                    start_new_session=True))
        deadline = time.monotonic() + DEADLINE_S
        for proc in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.0))
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    outs = [log.read_text() for log in logs]
    for rank, out in enumerate(outs):
        print(f"--- {tag}, rank {rank} ---\n{out.rstrip()}", flush=True)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(f"{tag}: ranks {failed} failed")
    return outs


def _cli_reading(out: str, tokens_per_step: int) -> dict:
    """The mesh line, the first step's loss and the timed steps' ms from
    one rank's train CLI output."""
    done = re.search(r"done: loss (\S+) ->", out)
    return {
        "mesh": re.search(r"mesh (.*)$", out, re.M).group(1),
        "first_loss": float(done.group(1)),
        "step_ms": {int(step): tokens_per_step / float(rate) * 1e3
                    for step, rate in re.findall(
                        r"^step (\d+): loss \S+ \((\d+) tokens/s\)",
                        out, re.M)},
    }


def cli_study(world: int, seed: int, *, device: str = "cuda",
              model: dict = chip_smoke.BENCH_TRANSFORMER,
              seq: int = chip_smoke.TRAIN_SEQ,
              batch: int = chip_smoke.TRAIN_BATCH) -> dict:
    """``--cli``: fp32 parity of the first step's loss, then the bf16
    step ms, of the train CLI on ``world`` processes against one."""
    with tempfile.TemporaryDirectory(prefix="tony-cli-") as tmp:
        root = Path(tmp)
        corpus = root / "corpus.tokens"
        chip_smoke.write_corpus(corpus, seed, CLI_RECORDS, seq,
                                model["vocab_size"])
        base = ["--device", device, "--data", str(corpus), "--batch",
                str(batch), "--seq", str(seq), "--lr", "1e-3", "--seed",
                str(seed), "--checkpoint-every", "1000", "--dist-timeout",
                str(DP_TIMEOUT_S)]
        runs = {}
        for dtype, steps in (("float32", CLI_PARITY_STEPS),
                             ("bfloat16", CLI_STEPS)):
            for n in (world, 1):
                tag = f"{dtype}-{n}"
                outs = run_cli(n, base + chip_smoke.model_args(model, dtype)
                               + ["--steps", str(steps), "--ckpt-dir",
                                  str(root / tag)], root, tag)
                runs[tag] = [_cli_reading(out, batch * seq) for out in outs]
    job, one = runs[f"float32-{world}"], runs["float32-1"][0]
    worst = max(abs(r["first_loss"] - one["first_loss"]) for r in job)
    return {
        "world": world, "mesh": job[0]["mesh"],
        "parity": {"first_loss_job": [r["first_loss"] for r in job],
                   "first_loss_one_process": one["first_loss"],
                   "worst_abs": worst, "atol": CLI_LOSS_ATOL,
                   "ok": worst <= CLI_LOSS_ATOL},
        "step_ms_by_rank": [r["step_ms"]
                            for r in runs[f"bfloat16-{world}"]],
        "step_ms_one_process": runs["bfloat16-1"][0]["step_ms"],
        "tokens_per_step_a_data_row": batch * seq,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks, one per card (default: every card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel ranks: train bench_moe's MoE "
                         "trunk over dp = ranks / ep x ep, with --tp, --sp "
                         "and --pp too (default 1: the dense trunk)")
    ap.add_argument("--moe", action="store_true",
                    help="train bench_moe's MoE trunk also at --ep 1")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks: train the dense trunk over "
                         "dp = ranks / tp x tp and serve it over the same "
                         "mesh (default 1)")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel ranks: train one sequence a "
                         "data row, split over sp (with --tp: dp = ranks / "
                         "(sp x tp)), through the ring (default 1)")
    ap.add_argument("--seq", type=int, default=SP_SEQ,
                    help=f"with --sp: the sequence length (default "
                         f"{SP_SEQ})")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel ranks: train the dense trunk "
                         "over dp = ranks / (pp x tp) x pp x tp, each rank "
                         "a stage of L/pp layers (default 1)")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="with --pp: the pipeline's microbatches of the [8, "
                         "2049] rows a data row; 0 trains the trunk whole "
                         "on every pp rank, the layer stack gathered over "
                         "pp (default 8)")
    ap.add_argument("--schedule", default="gpipe",
                    choices=("gpipe", "interleaved"),
                    help="with --pp: the pipeline schedule (default gpipe)")
    ap.add_argument("--virtual", type=int, default=1,
                    help="with --schedule interleaved: virtual stages a rank "
                         "(default 1)")
    ap.add_argument("--cli", action="store_true",
                    help="run the train CLI as a job of --ranks processes "
                         "on the job mesh, beside one process")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    ap.add_argument("--outdir", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    job = {"ep": args.ep, "moe": args.moe or args.ep > 1, "sp": args.sp,
           "tp": args.tp, "seq": args.seq,
           "pp": args.pp, "microbatches": args.microbatches,
           "schedule": args.schedule, "virtual": args.virtual}
    if args.rank is not None:
        run_rank(args.rank, args.ranks, args.store, args.outdir, args.seed,
                 job)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("dp_study: CUDA is not available; this script runs on the "
              "cards only", file=sys.stderr)
        return 1
    world = args.ranks or torch.cuda.device_count()
    if not 2 <= world <= torch.cuda.device_count():
        print(f"dp_study: needs 2 to {torch.cuda.device_count()} ranks, one "
              f"per card; got {world}", file=sys.stderr)
        return 1
    if args.cli:
        from tony_tpu_torch import kernels

        kernels.build()
        res = cli_study(world, args.seed)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip())
        print(json.dumps(res), flush=True)
        return 0 if res["parity"]["ok"] else 1
    experts = chip_smoke.BENCH_MOE["n_experts"]
    if args.ep < 1 or world % args.ep or experts % args.ep:
        print(f"dp_study: --ep must divide the ranks ({world}) and the "
              f"experts ({experts}); got {args.ep}", file=sys.stderr)
        return 1
    model, _, seq = step_model(job)
    heads = model["n_heads"]
    if args.tp < 1 or world % args.tp or heads % args.tp:
        print(f"dp_study: --tp must divide the ranks ({world}) and the "
              f"heads ({heads}); got {args.tp}", file=sys.stderr)
        return 1
    if args.sp < 1 or world % (args.ep * args.sp * args.tp) or seq % args.sp:
        print(f"dp_study: --ep x --sp x --tp must divide the ranks "
              f"({world}), --sp the sequence ({seq}); got {args.sp}",
              file=sys.stderr)
        return 1
    layers = model["n_layers"]
    if args.pp < 1 or world % (args.ep * args.pp * args.sp * args.tp) or (
            args.pp > 1 and (args.sp > 1 or layers % (
                args.pp * args.virtual))):
        print(f"dp_study: --ep x --pp x --tp must divide the ranks "
              f"({world}), --pp x --virtual the layers ({layers}), and --pp "
              f"takes no --sp; got {args.pp}", file=sys.stderr)
        return 1
    from tony_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build()
    chip_smoke.log(f"build: {time.perf_counter() - t0:.2f} s")
    results = launch(world, args.seed, job)
    for res in results:
        print(json.dumps(res))
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(cards)
    _, rows, seq = step_model(job)
    step_ms = [r["mesh"]["step_ms_median"] for r in results]
    last_sp = (args.sp - 1) * args.tp
    row_cards = args.pp * args.sp * args.tp
    print(json.dumps({
        "world": world, "mesh": {"dp": world // (args.ep * row_cards),
                                 "pp": args.pp, "ep": args.ep, "sp": args.sp,
                                 "tp": args.tp},
        "trunk": trunk(job) or ("the layer stack gathered over pp"
                                if args.pp > 1 else None),
        "seq": seq, "rows_per_data_row": rows,
        "total_s": time.perf_counter() - t0,
        "parity": results[0]["parity"],
        "step_ms_median_by_rank": step_ms,
        # Each data row (pp x sp x tp cards) trains rows x seq tokens a
        # step.
        "tokens_per_s_per_card": rows * seq / row_cards
        / (max(step_ms) / 1e3),
        "peak_memory_gb_by_rank": [r["mesh"]["peak_memory_gb"]
                                   for r in results],
        "plain_by_rank": [
            {when: {k: r[when][k] for k in ("step_ms_median",
                                             "peak_memory_gb",
                                             "out_of_memory") if k in r[when]}
             for when in ("plain_before", "plain_after")} for r in results],
        "launches_rank0": results[0]["mesh"]["launches"],
        "rank0_profiled_step": results[0]["mesh"]["profiled_step"],
        f"launches_rank{last_sp}": results[last_sp]["mesh"]["launches"],
        f"rank{last_sp}_profiled_step":
            results[last_sp]["mesh"]["profiled_step"],
        "decode_rank0": results[0].get("decode"),
        "pipeline_by_rank": [
            {k: r["mesh"].get(k) for k in (
                "ticks", "bubble_fraction", "busy_share", "sends_per_step",
                "send_mb", "p2p_ms", "p2p_median_ms", "sendrecv_wait_ms")}
            | {k: (r["mesh"]["profiled_step"] or {}).get(k) for k in (
                "wall_ms", "device_ms", "nccl_ms", "sendrecv_ms",
                "sendrecv_kernels")}
            for r in results] if args.pp > 1 else None,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
