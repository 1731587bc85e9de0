#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tony_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. build   — compile every CUDA kernel under tony_tpu_torch/csrc with nvcc
             (one process per source, started together), print ptxas's
             report (no function may spill), and count the tensor-core
             instructions (HMMA/HGMMA) of each flash kernel in cuobjdump's
             SASS (forward and backward): every bf16 instance must hold
             HGMMA (B1-B3 run on wgmma; a listing with only mma.sync's
             HMMA is refused), the fp32 (FMA) instances none.
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the main paths' shapes and at edge shapes, in fp32 and bf16:
             B4 (RMSNorm), B1 (flash forward), B2 and B3 (flash backward,
             dq and dk/dv: causal and not, t_q =, < and > t_k, ragged T,
             T at the edges of the bf16 tiles and of their TMA rings,
             rows before the first key, GQA groups 1/2/4/8, head_dim
             64/128, fused strided q/k/v views, an lse cotangent, a
             non-contiguous dO). Then time kernel, plain version and library
             call (device time from the profiler's kernel events) at the
             training shape, B1/B4 at the serving shapes too, and B1-B3
             against SDPA's forward and backward at the hd128 shape
             [8, 2048, 8, 128]; at those two shapes B1-B3 are also held row
             by row (ROW_TOL), B2/B3 launched twice on the same inputs
             must give bit-equal dq, dk and dv, and the whole backward
             call (B2 with delta, then B3) is timed beside B2, B3 and
             SDPA's backward. Each library reading (SDPA, F.rms_norm) is
             taken 3 times; one below half the median of its other
             readings is taken again, and refused (logged, not used) if it
             stays low; the library ms is the median of those kept.
3. serve   — the flagship GQA LM at full width (vocab 32000, d 1024,
             8 layers, 16/4 heads, head_dim 64, d_ff 4096, bf16, random
             weights from --seed) behind ServingEngine + ServingServer:
             concurrent POST /generate requests, /healthz, /shutdown.
4. generate — DecodeSession.generate at batch 8, prompt 128, 128 new tokens.
5. profile — device time by kernel over a few 16-slot decode steps.
6. parity  — fp32 (TF32 off): staggered requests of mixed lengths through
             the engine (more live slots than a prefill batch, a reused
             slot, decode windows 1 and 3) each equal
             DecodeSession.generate token for token.
6b. int8 serve — the int8 KV cache at the flagship's full width:
             ServingEngine(kv_quant="int8"), 16 slots, max_len 2048, behind
             the HTTP server, answering the serve phase's requests: tokens/s,
             TTFT and inter-token p50/p95 beside the float engine's of this
             run, the cache bytes of both modes, the peak device memory and
             one profiled decode window's device ms in both modes. Then fp32
             (TF32 off): the parity phase's requests through the int8 engine
             at decode windows 1 and 3 give equal tokens; the float tokens
             fed back teacher-forced through both caches give int8 logits
             within INT8_LOGIT_TOL of the float ones, and where the int8
             engine's tokens first leave the float ones the float top-2
             margin is below the int8 perturbation there (JAX's bound, an
             agreeing prefix of min(8, n) tokens and n // 2 equal, is
             printed per request); _quantize on the card bit-equal to the
             CPU's; a prefilled slot's exported rows against the float
             engine's: layer 0 equal to the quantized float rows (the
             deeper layers' drift printed); the float rows injected into
             an int8 cache export as their round trip, within amax / 127
             + 1e-6.
7. train   — make_train_step on bench.py's bench_transformer configuration
             (vocab 32000, d 1024, 8 layers, 16 heads of 64, d_ff 4096,
             bf16, 199.8 M parameters) over a fixed batch of 8 x 2048
             tokens: step time, tokens/s, MFU, peak memory, launches per
             step, one profiled step; the loss must be finite and fall.
8. train parity — fp32 (TF32 off), 2 layers, d 256, GQA 16/4: losses of 3
             steps and first-step gradients on the card equal the CPU's
             plain path, with remat off, "full" and "dots".
9. dp      — the data-parallel path on one card: a one-rank NCCL group on
             a HashStore, runtime.build_job_mesh() and the port's
             collectives over it (each must return its input with one
             rank), then make_train_step(cfg, mesh) at bench_transformer's
             width from the train phase's init and batch: 3 steps equal
             the mesh=None path bit for bit (losses and every leaf), then
             the step median (10 after 2 warm-ups, CUDA events) beside
             mesh=None's, timed before and after it, with peak memory
             and each step's working set.
9b. tp     — the tensor-parallel path on one card: MeshSpec(tp=1) on a
             one-rank NCCL group (the conjugate pair copy_to_tp /
             reduce_from_tp is the identity at tp = 1; the vocab-parallel
             loss's max and sum run as one-rank all_reduces; the per-part
             decode split cuts whole blocks). fp32 (TF32 off) losses of 3
             steps and first-step gradients at train parity's widths and
             each remat setting against mesh=None (TRAIN_LOSS_RTOL,
             TRAIN_GRAD_TOL); DecodeSession(mesh=) on the flagship model
             in fp32 gives the greedy tokens of the session without a
             mesh; the bf16 bench_transformer step over the mesh beside
             mesh=None's, timed before and after, and the all_reduce calls
             and bytes one step sends over the tp group.
9c. sp     — sequence parallelism on one card. The ring: the port's ring
             body for every rank of a ring of 2 and of 4 ranks run in one
             process (ring_attention_in_process: each rotation hands out
             the next owner's slice of whole-sequence K/V) at bench.py's
             transformer_16k_hd128 attention shape (q [1, 16384, 8, 128]
             bf16, causal; K/V heads 8 and 2): every B1 and B2/B3 launch
             of the ring (the diagonal block causal, each past block
             unmasked, the merge's lse cotangent into B2/B3) held against
             its plain version on the same inputs; the ring's output
             against the plain forward over the whole sequence, its dq,
             dk, dv against the plain backward fed B1's out and lse, and
             all four against B1-B3 over the whole sequence, whose
             launches are held against their plain versions too (TOL and
             ROW_TOL, as the kernels phase holds them), then in fp32 (TF32
             off) at
             [1, 2048, 8, 128] within SP_FP32_TOL; B1 and B2 launch
             n(n+1)/2 times a ring of n, rank i's body 1 + i times. The
             trunk: MeshSpec(sp=1) on a one-rank NCCL group, fp32 losses
             and first-step gradients at train parity's widths and each
             remat setting against mesh=None, and the bf16
             bench_transformer step over the mesh beside mesh=None's. At
             sp=1 the trunk does not reach the ring's NCCL rotation, the
             loss's sequence slice or the RoPE offset: dp_study.py --sp on
             several cards runs those.
9d. pp     — pipeline parallelism on one card. The schedules: the
             pipelined trunk with every stage in one process
             (pipeline_apply_in_process: each tick runs every stage, then
             a list shift hands stage s's output to stage s + 1) at
             bench_transformer's full width over 8 microbatches of
             [8, 2049], under pp 2 and 4 GPipe and pp 4 interleaved with
             2 virtual stages: loss and every gradient leaf against the
             mesh=None step on the same batch in bf16 (PP_BF16_LOSS_RTOL,
             PP_BF16_GRAD_TOL), every B1 and B2/B3 launch of the schedule
             held against its plain version on the same inputs, and the
             launch count a schedule's ticks give; the same in fp32 (TF32
             off) at train parity's widths and 8 layers, within
             TRAIN_LOSS_RTOL and TRAIN_GRAD_TOL. The trunk: MeshSpec(pp=1)
             on a one-rank NCCL group through make_train_step(...,
             pipeline_microbatches=...) and pipeline_apply: fp32 parity at
             each remat setting against mesh=None, and the bf16
             bench_transformer step beside mesh=None's. pp above 1 over
             NCCL runs in dp_study.py --pp on several cards.
10. job    — the train CLI as a job runs it, at bench_transformer's full
             width: a uint16 .tokens corpus of 32 records x 2049 tokens
             from --seed (4 batches, one epoch = 4 steps) read through
             runtime.sharded_reader and io.device_prefetch; job A trains 8
             steps checkpointing every 2, job B trains 4, exits, and resumes
             from its step-4 checkpoint to 8. Step 8 of A and of B must be
             equal bit for bit in every leaf (params, AdamW moments, count,
             step). Then the serve CLI serves B's checkpoint (fp32, so the
             greedy tokens can be held exactly): 4 POSTs equal
             DecodeSession.generate on the restored params. Then the
             generate CLI on B's checkpoint (fp32, greedy, 3 ragged rows
             left-padded, 16 new tokens) prints, row by row, the serve
             CLI's replies to the padded rows (posted with its 4) and
             DecodeSession.generate's on the restored params. Then, on the
             train phase's in-memory state: the save() wall and the stall
             it adds to the next step, persist (save to commit), restore,
             the bytes, a plain pinned copy of the same bytes and the
             PCIe bound, and the step time with batches from the file
             through the prefetcher. Everything is written under a
             temporary directory, removed at the end (20 GB free needed).
             Each job reads a fresh default registry: its tony_ckpt_* and
             tony_io_* values are printed, its snapshot and persist
             observations must equal its saves and tony_ckpt_committed_step
             its last step, and job B's tony_ckpt_bytes_total (nothing
             overwritten or collected) the shard bytes on disk. Jobs A and
             B must read every span through the native library (one
             native.pread_records call a span) and send readahead hints.
10b. job gs — job C: job A's corpus uploaded into a TONY_GCS_EMULATOR_DIR
             root and trained from gs:// by the train CLI for 6 steps,
             checkpointing every 2 to a gs:// prefix, under a
             TONY_FAULT_PLAN (JOB_C_PLAN): every checkpoint write delayed
             200 ms, both writes of step 6 partial (torn), 100 ms of
             throttle_io on batches 2 and 3, and 150 ms of degrade_task
             after step 3. Its losses must equal job A's bit for bit, step
             6 must not be complete, each committed save's
             tony_ckpt_persist_ms must reach the delay, the throttle must
             have slept twice after the first batch, job C's summed
             data_wait must exceed job A's, the degraded step's wall must
             lie the degrade above the median (less JOB_C_DEGRADE_TOL), and
             every span must have come through the store's get_range and
             none natively. Step 4 restored from gs:// equals job A's step
             4 bit for bit (both restores timed); job C resumes to 8 with no
             plan ("resumed from step 4", losses equal to job A's), and the
             serve CLI serves its gs:// checkpoint (fp32, greedy, equal to
             DecodeSession.generate). Last, a ~1 GiB token file is read
             whole from the page cache through the native library and
             through the preadv path, in turns (tony_io_read_ms, GB/s).

11. moe train — make_train_step on bench.py's bench_moe configuration at
             full width and depth (vocab 32000, d 1024, 8 layers, 16 heads
             of 64, d_ff 4096, 4 experts, top-2, capacity factor 1.25,
             bf16, remat "dots", ~502 M parameters) over a fixed batch of
             4 x 2049 tokens: step median, tokens/s, MFU from the routed
             FLOPs (formula printed), peak memory, the router's drop rate
             and entropy, one profiled step split into routing/dispatch/
             combine, experts, B1-B4 and the rest; the loss must fall.
12. moe parity — fp32 (TF32 off), train parity's widths with 4 experts,
             top-2, capacity factor 1.25 (tokens drop): card vs CPU at each
             remat setting, then the expert-parallel path over a one-rank
             NCCL mesh: 3 steps bit-equal to mesh=None, its all_to_all run.
12b. moe mesh — the MoE trunk over the model axes. The pipeline with
             every stage in one process at bench_moe's full width and
             depth over 4 microbatches of [4, 2049] (pp 2 GPipe, pp 4
             interleaved with 2 virtual stages): loss, router values and
             every gradient against the trunk run one microbatch at a time
             (same rows, same capacity), in bf16 and, at moe parity's
             widths with 8 layers and skewed weights (tokens drop), in
             fp32; every B1 and B2/B3 launch held against its plain
             version. Then MeshSpec(tp=1), (sp=1) and (pp=1, stack
             gathered and through the pipeline) on a one-rank NCCL group,
             fp32 with drops at remat "dots": parity against mesh=None.
13. moe serve — DecodeSession.generate at bench_moe_decode's three points
             (E 4 routed, E 16 routed, E 16 dense; d 512, 4 layers, batch
             8, prompt 16; ms per step by differencing 256 and 896 new
             tokens, bench.py's lengths), a ServingEngine on bench_moe's
             trunk (bf16) answering 4 concurrent POSTs; then, outside the
             counted window, routed == dense tokens in fp32 at E 4 and
             E 16 and fp32 engine/generate parity on bench_moe's trunk.

14. classifier — the image classifiers at bench.py's widths: the MNIST
             CNN (bf16, batch 512, 50 steps a call on distinct batches,
             lr 1e-3): steps/s; ResNet-50 (depth 50, width 64, 1000
             classes, bf16, batch 32 x 224 x 224 x 3) from float and from
             uint8 images: images/s, step ms, peak memory, one profiled
             step's device busy share. These run none of B1-B4: their
             launch counts must all be 0. Then, fp32 (TF32 off): ResNet-50
             logits from uint8 images equal those from prescaled float
             images within 1e-4; the MNIST CNN and a ResNet-18 train 5
             steps on the card equal to the CPU's plain path (losses,
             first-step gradients) and learn.
15. mnist job — tony_tpu_torch/mnist_distributed.py as one --framework
             pytorch worker through the orchestrator's local submitter:
             30 steps with a checkpoint dir, then a rerun to 50 that
             resumes from step 30; the chief's mnist_metrics.json holds a
             finite loss.
16. anatomy — the LM step at bench_transformer's width through the
             instrumented make_train_step: its five tony_step_phase_ms
             gauges sum to its step wall, tony_mfu against the card's
             PEAK_FLOPS entry, the host phase's share, and its wall beside
             the uninstrumented step's (no synchronize added); the
             classifier step's phases and no tony_mfu.
17. tune   — the compile, plan and tune plane, under a temporary compile
             cache: tune_flash_blocks at the training, hd128 and
             generate-prefill shapes (every candidate warmed before the
             first is timed; a point other than Knobs() must beat it by
             more than the spread of their windows); tune_train_step on
             bench_transformer's step over the train knobs and the tile
             points; make_train_step from that record (a lookup hit, the
             winner's blocks pinned) for 10 steps under StepStats'
             calibration, which write the measurement table's entry and
             tony_plan_residual. Then the jit sanitizer armed strict over
             the 12 requests through a ServingEngine on the flagship model
             and 5 bench_transformer steps: no guarded transfer, no
             retrace; an .item() inside a step region must raise (the
             control). Then two processes on one empty
             TONY_COMPILE_CACHE_DIR, each the first init and step of
             bench_transformer: the cold one builds the kernels there and
             misses twice, the warm one hits twice; tony_compile_ms of
             both.
18. telemetry — TONY_PROFILE_HBM_INTERVAL_MS=500 and runtime.initialize()
             (the HBM monitor), a float ServingEngine on the flagship model
             with a private MetricsRegistry under TONY_JIT_SANITIZER=strict,
             a run_capture window of 1000 ms on a thread and, into it, a
             4-token DecodeSession.generate (B1's prefill; the engine's
             prefill attends in plain PyTorch, as JAX's does) and the
             serve phase's 12 requests: the tony_serving_*
             counters equal the engine's tallies and the responses, 12
             TTFT observations, queue and active gauges 0 after the
             drain, the serving_* spans as the dispatch counts decimate,
             the HBM gauges (in use > 0, peak >= in use, limit = the
             card's total_memory), the capture's "cuda" snapshot and B1
             and B4 kernel events in its trace, no guarded transfer and
             no retrace; tokens/s and inter-token p50 beside PERF.md's
             last reading. Then StepProfiler(start=2, num=3) and
             annotate("telemetry_step") over 6 steps of the train cell:
             one trace, holding the three annotations, whose B1-B4
             kernel events launched in steps 3 and 4 equal each step's
             launch counts (step 2 leads in: in a long process the
             profiler can lose a session's first kernels; a window whose
             trace dropped an event is logged and profiled again, up to
             3 windows); profiled and unprofiled step ms, and the
             window's top 12 device ops (the dense step's breakdown).

The launch counters are set to 0 just before each path (phases 3-4, the
serving path; phase 6b's HTTP serving, the int8 serving path; phase 7, the
training path; phase 9, the data-parallel
path; phase 9b's mesh runs, the tp path; phase 9c's rings and mesh
runs, the sp path; phase 9d's schedules and mesh runs, the pp path;
phase 10's jobs and serving, the job path, and its generate CLI, the
generate path; phase 10b's job C, its resume and serving, the job_gs
path; phase 11, the MoE train path; phase 12b's pipelines, the MoE
pipeline path, and its mesh runs, the MoE mesh path; phase 13's bf16
generate and
engine, the MoE serving path; phase 14's timed runs, the classifier path;
phase 16's windows, the anatomy path; phase 17's tuning and the step
built from its record, the tune path; phase 18's serving and profiled
steps, the telemetry path) and read just after; every kernel of
a path must have launched there, but on the classifier path, which runs
none of them by design and must read 0 for each. The last three lines are the kernels
JSON line, the card's name and power limit (nvidia-smi), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

# Peak rates of an H100 SXM (NVIDIA data sheet, dense), used for bound_ms.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

FLAGSHIP = dict(
    vocab_size=32_000, d_model=1024, n_layers=8, n_heads=16, head_dim=64,
    d_ff=4096, max_seq=2048, n_kv_heads=4, remat=False,
)
N_REQUESTS = 12  # concurrent POST /generate requests in the serve phase

# The training configuration of bench.py's bench_transformer: vocab 32000,
# d 1024, 8 layers, 16 heads of 64 (MHA), d_ff 4096, bf16, no remat at
# 8 x 2048 tokens (199.8 M parameters).
BENCH_TRANSFORMER = dict(
    vocab_size=32_000, d_model=1024, n_layers=8, n_heads=16, head_dim=64,
    d_ff=4096, max_seq=2048, n_kv_heads=0, remat=False,
)
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ  # RMSNorm rows per call in training
# The training shape of the attention kernels (causal, bf16).
TRAIN_ATTN = dict(b=TRAIN_BATCH, t=TRAIN_SEQ, h=16, h_kv=16, d=64)

# Train parity: reduced depth and width, GQA 16/4, fp32 with TF32 off; the
# card (B1-B4) against the CPU's plain path for 3 steps, at each remat
# setting.
PARITY_TRAIN = dict(
    vocab_size=1024, d_model=256, n_layers=2, n_heads=16, n_kv_heads=4,
    head_dim=64, d_ff=1024, max_seq=256,
)
PARITY_TRAIN_BATCH, PARITY_TRAIN_STEPS = 2, 3
PARITY_REMAT = [(False, "full"), (True, "full"), (True, "dots")]
# Card against CPU, fp32: the same arithmetic summed in another order
# (kernels vs the plain path, cuBLAS vs the CPU's GEMMs). The H100 read
# 6.5e-8 (loss, relative) and 1.5e-6 (worst leaf, relative to its largest
# |gradient|); the limits leave about 15x and 7x over those readings. The
# gradient limit is what catches a precision slip: fp32 kernels that round
# p and ds to bf16 read 1.8e-3 there, but only 9e-7 on the losses.
TRAIN_LOSS_RTOL = 1e-6
TRAIN_GRAD_TOL = 1e-5

# dp phase: the data-parallel path at world 1 (one card) over NCCL on a
# one-rank group: parity steps against the mesh=None path from the same init
# and batch, then timed steps, mesh=None before and after the mesh path.
DP_PARITY_STEPS = 3
DP_TIMEOUT_S = 60.0
# tp phase: DecodeSession(mesh=) on the flagship serving model in fp32 held
# against the session without a mesh (batch, prompt length, new tokens).
TP_DECODE = dict(batch=4, prompt=32, new=16)
# sp phase: the ring of SP_RINGS ranks in one process at bench.py's
# transformer_16k_hd128 attention shape (batch 1, 16384 positions, 8 heads
# of 128; bf16, causal), with 8 (MHA) and 2 (GQA) K/V heads, each of its
# launches against the plain version on the same inputs, and the ring
# against the plain versions and B1-B3 over the whole sequence; then in
# fp32 (TF32 off) at a shorter sequence, where the ring's chunks and merge
# sum the same terms as one plain or kernel call in another order (~1e-6),
# within SP_FP32_TOL.
SP_ATTN = dict(b=1, t=16384, h=8, d=128)
SP_FP32_ATTN = dict(b=1, t=2048, h=8, d=128)
SP_RINGS = (2, 4)
SP_KV_HEADS = (8, 2)
SP_FP32_TOL = 1e-5
# pp phase: the pipelined trunk with every stage in one process
# (pipeline_apply_in_process) at bench_transformer's full width over
# PP_MICROBATCHES microbatches of [8, 2049], under each (stages, schedule,
# virtual stages) of PP_SCHEDULES, against the mesh=None step on the same
# batch. In bf16 the pipeline rounds each microbatch's products and its
# weight gradients to bf16 on their own (8 partial sums in fp32 where
# mesh=None rounds one): the loss within PP_BF16_LOSS_RTOL and every
# gradient leaf within PP_BF16_GRAD_TOL of its largest |value| (bf16's
# relative step is 2^-8 = 3.9e-3). In fp32 (TF32 off) at train parity's
# widths (8 layers) the same math in another order: within TRAIN_LOSS_RTOL
# and TRAIN_GRAD_TOL. MeshSpec(pp=1)'s parity runs PARITY_TRAIN_BATCH
# microbatches (one row each).
PP_MICROBATCHES = 8
PP_SCHEDULES = ((2, "gpipe", 1), (4, "gpipe", 1), (4, "interleaved", 2))
PP_BF16_LOSS_RTOL = 1e-2
PP_BF16_GRAD_TOL = 5e-2

# Job phase: bench_transformer's widths through the train CLI, a corpus of
# 4 batches (one epoch = 4 steps), job A straight to 8 steps with a
# checkpoint every 2, job B to 4 and then resumed to 8.
JOB_RECORDS = TRAIN_BATCH * 4
JOB_STEPS, JOB_HALF, JOB_EVERY = 8, 4, 2
# 1e-3: the CLI's default 1e-2 is tuned for the small CPU configs; at full
# width the loss of a resumed half must still fall over its 4 steps.
JOB_LR = 1e-3
JOB_MIN_FREE_BYTES = 20e9
JOB_SERVE_REQUESTS = 4
# The job phase's generate.py run: ragged prompt rows (left-padded to the
# longest) and the new tokens of each.
GENERATE_LENGTHS = (24, 40, 32)
GENERATE_NEW = 16
# One PCIe Gen5 x16 direction, the D2H bound of a snapshot.
PCIE_BYTES_PER_S = 64e9

# MoE train: bench.py's bench_moe (vocab 32000, d 1024, 8 layers, 16 heads
# of 64 (MHA), d_ff 4096, 4 experts, top-2, capacity factor 1.25, bf16,
# remat "dots") at full width and depth, batch 4 x 2049 from --seed.
BENCH_MOE = dict(
    vocab_size=32_000, d_model=1024, n_layers=8, n_heads=16, head_dim=64,
    d_ff=4096, max_seq=2048, n_kv_heads=0, n_experts=4, expert_top_k=2,
    capacity_factor=1.25, remat=True, remat_policy="dots",
)
MOE_BATCH = 4
# MoE parity: train parity's widths (GQA 16/4) with 4 experts, top-2 and
# capacity factor 1.25, so tokens drop.
MOE_PARITY = dict(PARITY_TRAIN, n_experts=4, expert_top_k=2,
                  capacity_factor=1.25)
# The MoE parity weights' embedding rows share one seeded offset of this
# scale: routing is skewed and tokens drop (a drop rate of 0.17 on the
# first batch, on the CPU), where the plain random init drops none.
MOE_PARITY_SKEW = 1.0
# MoE decode: bench.py's bench_moe_decode trunk (vocab 32000, d 512, 4
# layers, 8 heads of 64, d_ff 1024, top-2, bf16) at its three points, batch
# 8, prompt 16; the per-token ms is the wall difference of two lengths.
MOE_DECODE = dict(
    vocab_size=32_000, d_model=512, n_layers=4, n_heads=8, head_dim=64,
    d_ff=1024, max_seq=1024, n_kv_heads=0, expert_top_k=2, remat=False,
)
MOE_DECODE_POINTS = [(4, "routed"), (16, "routed"), (16, "dense")]
# MoE over the model axes: the pipeline in one process over
# MOE_PP_MICROBATCHES microbatches under each (stages, schedule, virtual
# stages) of MOE_PP_SCHEDULES, against the trunk run one microbatch at a
# time; the router values held beside the loss.
MOE_PP_MICROBATCHES = 4
MOE_PP_SCHEDULES = ((2, "gpipe", 1), (4, "interleaved", 2))
MOE_AUX = ("moe_balance", "moe_zloss", "moe_drop_rate", "moe_entropy")
MOE_DECODE_BATCH, MOE_DECODE_PROMPT = 8, 16
MOE_DECODE_LENGTHS = (256, 896)
MOE_SERVE_REQUESTS = 4

# Parity phase requests: (prompt length, new tokens, engine step at which it
# is submitted). Six slots, prefill chunks of 32 and prefill batches of 4:
# prompts shorter than a chunk and spanning three, two prefill calls in the
# first round (the second padded by duplicating its row 0), six live rows,
# and two late arrivals that wait for a slot the 7-token prompt frees.
PARITY_SLOTS = 6
PARITY_REQUESTS = [(7, 6, 0), (45, 16, 0), (90, 12, 0), (20, 16, 0),
                   (33, 10, 0), (64, 16, 0), (12, 16, 2), (70, 12, 5)]
# The int8 cache against the float cache on those requests, fp32
# teacher-forced logits of the flagship's random weights (std ~1.0): the
# largest |difference| at a position (0.025-0.039 measured on an H100;
# rounding by truncation would double it).
INT8_LOGIT_TOL = 0.06

# Stated tolerances (max abs error against the plain version on the card).
# fp32: both sides accumulate in fp32 in another order (~1e-6 here).
# bf16: outputs round to bf16 (one ulp is 2**-8 relative) and the flash
# kernel rounds P to bf16 before P.V, as the TPU kernel does.
TOL = {
    ("rms_norm", "torch.float32"): 1e-5,
    # B4 with bf16 x: in bf16 ulps of the plain output, element by element.
    # Both sides compute y in fp32 and differ only in the order of the sum
    # of squares, so a rounding to bf16 can differ by one ulp, which is
    # 0.031 at |y| >= 4 (the training shape's 16.7 M outputs reach that).
    ("rms_norm", "torch.bfloat16"): 1.0,
    ("flash_fwd", "torch.float32"): 5e-5,
    ("flash_fwd", "torch.bfloat16"): 2e-2,
    ("flash_lse", "torch.float32"): 5e-5,
    ("flash_lse", "torch.bfloat16"): 1e-3,
    # B2/B3 against _flash_bwd_plain, as max abs error over the largest
    # |gradient| of the plain version (floored at 1). fp32: both sum T
    # terms in fp32 in another order (~1e-6 relative). bf16: dq/dk/dv
    # round to bf16 (2**-8 relative at the largest entries), and an fp32
    # difference of one ulp can flip the bf16 rounding of a p or ds term.
    ("flash_bwd", "torch.float32"): 5e-5,
    ("flash_bwd", "torch.bfloat16"): 2e-2,
}
# At the training and hd128 shapes (T = 2048) the gradients fall off with
# position (dq at row i, dk/dv at key j about 1/sqrt(position + 1)), so the
# TOL limit, scaled by the largest |gradient|, is as large as a typical
# entry; so do the causal outputs (row i of O averages i + 1 values, its
# norm about 1/sqrt(i + 1) of row 0's), where TOL's absolute 2e-2 cannot
# see one key tile missing from a late row. There the bf16 B1-B3 are also
# held row by row: the worst, over the rows of head_dim values of O (B1) or
# of dq, dk and dv (B2/B3), of ||got_r - want_r|| / max(||want_r||,
# ROW_FLOOR * the RMS row norm). The floor keeps rows whose gradient is zero
# by construction (dq of a query that sees one key) from dividing noise by
# nothing. On an H100 the sound kernels read 0.004-0.006 at both shapes,
# and copies that drop one streamed tile read 0.8-1.7 (flash_bwd_study.py
# controls and fwd-controls, which also hold faults confined to late rows
# against this limit; their readings are in PERF.md).
ROW_TOL = 0.02
ROW_FLOOR = 0.1
PROFILE_TRIES = 3
# Readings of each library yardstick (see library_ms).
LIBRARY_READINGS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def device_events(torch, fn):
    """Run fn() under the profiler; returns ([(name, device_us)] for every
    device-side event (kernels, memcpy, memset) it caused, the wall ms of
    that same call, synchronize included). The profiler now and then hands
    back a trace with no device events at all (seen once in ~20 runs on an
    H100, torch 2.11, mid-script after many good traces): such a call is
    made again, up to PROFILE_TRIES times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # User annotations (an optimizer's step range) span kernels that
        # are listed on their own; counting them would count that time
        # twice.
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        if events:
            return events, wall_ms
        log("the profiler saw no device time; profiling the call again")
    raise AssertionError(f"the profiler saw no device time in "
                         f"{PROFILE_TRIES} tries")


def device_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time per call of fn(): the sum of the durations of the
    device events it caused, over ``iters`` calls."""
    for _ in range(warmup):
        fn()

    def many():
        for _ in range(iters):
            fn()

    events, _ = device_events(torch, many)
    return sum(us for _, us in events) / iters / 1e3


def library_ms(torch, name: str, fn, iters: int, warmup: int = 3) -> float:
    """The device ms of a library yardstick call (SDPA, F.rms_norm),
    guarded against a reading that reads low because the profiler dropped
    events: LIBRARY_READINGS readings of ``device_ms``; one below half the
    median of the other readings is taken again, and if it stays below,
    it is logged as refused and not used. Returns the median of the
    readings kept."""
    readings = [device_ms(torch, fn, iters, warmup)
                for _ in range(LIBRARY_READINGS)]
    kept = []
    for i, reading in enumerate(readings):
        floor = 0.5 * float(np.median(readings[:i] + readings[i + 1:]))
        if reading < floor:
            again = device_ms(torch, fn, iters, warmup=1)
            log(f"{name}: reading {reading:.6g} ms is below half the median "
                f"of its other readings ({2 * floor:.6g} ms); taken again: "
                f"{again:.6g} ms")
            if again < floor:
                log(f"{name}: refused {again:.6g} ms as a library ms")
                continue
            reading = again
        kept.append(reading)
    return float(np.median(kept))


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# A flash kernel's mangled name: its function and head_dim.
_FLASH_KERNEL = re.compile(
    r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel_(?:bf16|fp32))ILi(\d+)E")
BWD_INSTANCES = {f"flash_bwd_{k}_kernel_{dt}{d}" for k in ("dq", "dkv")
                 for dt in ("bf16", "fp32") for d in (64, 128)}
FWD_INSTANCES = {f"flash_fwd_kernel_{dt}{d}" for dt in ("bf16", "fp32")
                 for d in (64, 128)}


def kernel_name(mangled: str) -> str:
    """"flash_<fwd|bwd_dq|bwd_dkv>_kernel_<dtype><head_dim>" for a flash
    kernel's mangled name, else the name as it is."""
    m = _FLASH_KERNEL.search(mangled)
    return f"{m.group(1)}{m.group(2)}" if m else mangled


def ptxas_kernels(report: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes (stores + loads) of each function in a
    ``ptxas -v`` report, keyed by kernel_name of its mangled name."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in report.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = kernel_name(m.group(1))
            out[name] = {"registers": 0, "spill_bytes": 0}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", line)):
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def check_no_spills(reports: dict[str, str]) -> None:
    """Raises unless every library's ptxas report lists its functions and
    none of them spills."""
    for lib, report in reports.items():
        funcs = ptxas_kernels(report)
        if not funcs:
            raise AssertionError(f"ptxas reported no function for {lib}")
        spilled = {n: f["spill_bytes"] for n, f in funcs.items()
                   if f["spill_bytes"]}
        if spilled:
            raise AssertionError(f"ptxas: {lib} spills (bytes): {spilled}")


def sass_listing(kernels, source: str) -> str:
    """cuobjdump's SASS listing of the library built from csrc/<source>."""
    tool = str(Path(kernels.nvcc_path()).with_name("cuobjdump"))
    lib = str(kernels.library_path(source))
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout


# The tensor-core instruction each library's bf16 kernels must hold: B1-B3
# run on wgmma (HGMMA).
MMA_OPS = {"flash_fwd": ("HGMMA", re.compile(r"\bHGMMA\b")),
           "flash_bwd": ("HGMMA", re.compile(r"\bHGMMA\b"))}


def sass_mma_counts(listing: str,
                    instances: set[str] = BWD_INSTANCES) -> dict[str, int]:
    """Tensor-core instructions in each flash kernel function of a SASS
    listing that is one of ``instances`` (keyed
    "flash_<fwd|bwd_dq|bwd_dkv>_kernel_<dtype><head_dim>"; by default the
    8 backward ones): the count of its library's MMA_OPS instruction.
    Raises unless the listing holds exactly those instances, every bf16
    instance has some of that instruction and every fp32 instance no
    tensor-core instruction at all."""
    kind = "flash_fwd" if instances <= FWD_INSTANCES else "flash_bwd"
    op, op_re = MMA_OPS[kind]
    counts: dict[str, int] = {}
    any_mma: dict[str, int] = {}
    name = None
    for line in listing.splitlines():
        if "Function :" in line:
            name = kernel_name(line)
            name = name if name in instances else None
            if name:
                counts[name] = any_mma[name] = 0
        elif name and re.search(r"\bH(G)?MMA\b", line):
            any_mma[name] += 1
            counts[name] += bool(op_re.search(line))
    if not counts:
        raise AssertionError(f"cuobjdump listed no {kind} kernel")
    if set(counts) != instances:
        raise AssertionError(f"cuobjdump listed {sorted(counts)}, not the "
                             f"instances {sorted(instances)}")
    for name, n in counts.items():
        if "_bf16" in name and n == 0:
            raise AssertionError(f"{name}: no {op} instruction "
                                 f"({any_mma[name]} tensor-core instructions "
                                 f"in all; bf16 instances need some)")
        if "_fp32" in name and any_mma[name]:
            raise AssertionError(f"{name}: {any_mma[name]} tensor-core "
                                 f"instructions (bf16 instances need some, "
                                 f"fp32 none)")
    return counts


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_rms_norm(torch, norms, gen) -> dict:
    worst = 0.0
    dev = "cuda"
    # The serving shapes, the training shape, and ragged ones.
    cases = [(rows, 1024) for rows in (1, 4, 8, 16, 128, 1024, TRAIN_ROWS)]
    cases += [(3, 64), (257, 4096)]
    for x_dt in (torch.float32, torch.bfloat16):
        for w_dt in (torch.float32, torch.bfloat16):
            for rows, d in cases:
                x = torch.randn(rows, d, generator=gen, device=dev).to(x_dt)
                w = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
                     ).to(w_dt)
                got = norms._rms_norm_cuda(x, w, 1e-6)
                want = norms._rms_norm_plain(x, w, 1e-6).float()
                diff = (got.float() - want).abs()
                err = diff.max().item()
                measure = err
                if x_dt == torch.bfloat16:
                    # |want| in [2**(e-1), 2**e) has a bf16 ulp of 2**(e-8).
                    _, e = torch.frexp(want)
                    measure = (diff / torch.exp2((e - 8).float())).max().item()
                tol = TOL[("rms_norm", str(x_dt))]
                if not measure <= tol:
                    raise AssertionError(
                        f"rms_norm x={x_dt} w={w_dt} [{rows},{d}]: max abs "
                        f"err {err}, {measure} > {tol}")
                if x_dt == torch.bfloat16:
                    worst = max(worst, err)
            log(f"rms_norm x={x_dt} w={w_dt}: ok "
                f"(tol {TOL[('rms_norm', str(x_dt))]})")
    serve = time_rms_norm(torch, norms, gen, 16, torch.bfloat16)
    train = time_rms_norm(torch, norms, gen, TRAIN_ROWS, torch.float32)
    log(f"rms_norm device ms, decode step x [16, 1024] bf16, w bf16: "
        f"{json.dumps(serve)}; training x [{TRAIN_ROWS}, 1024] bf16, w fp32: "
        f"{json.dumps(train)}")
    return {
        "name": "rms_norm", "route": "cuda",
        "source": "tony_tpu_torch/csrc/rms_norm.cu",
        "replaces": "tony_tpu/ops/norms.py:17",
        "max_abs_err": worst, "ms": train["ms"],
        "plain_ms": train["plain_ms"], "bound_ms": train["bound"][0],
        "bound_by": train["bound"][1], "library_ms": train["library_ms"],
        "shape": f"x [{TRAIN_ROWS}, 1024] bf16, w [1024] fp32",
        "serve_shape": serve,
    }


def time_rms_norm(torch, norms, gen, rows: int, w_dtype) -> dict:
    """B4, its plain version and F.rms_norm on x [rows, 1024] bf16 (device
    time), with the bound. F.rms_norm takes a weight of another dtype than
    x through its unfused path."""
    d = 1024
    x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        w_dtype)
    fns = {
        "ms": lambda: norms._rms_norm_cuda(x, w, 1e-6),
        "plain_ms": lambda: norms._rms_norm_plain(x, w, 1e-6),
    }
    iters = 200 if rows <= 1024 else 50
    res = {k: device_ms(torch, f, iters) for k, f in fns.items()}
    res["library_ms"] = library_ms(
        torch, f"F.rms_norm [{rows}, {d}]",
        lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6), iters)
    nbytes = 2 * rows * d * x.element_size() + d * w.element_size()
    res["bound"] = bound(nbytes, 4 * rows * d, torch.float32)
    return res


def row_error(diff, want) -> float:
    """The row error (see ROW_TOL) of ``diff`` = got - want, both
    [rows, head_dim] fp32: the worst ||diff_r|| / max(||want_r||,
    ROW_FLOOR * the RMS row norm of ``want``). A ``want`` of zeros (a
    pipeline's bubble tick on zero activations, a zero cotangent) takes
    the smallest normal fp32 as its floor: an exact result reads 0, any
    other fails."""
    w_norm = want.norm(dim=1)
    floor = ROW_FLOOR * w_norm.square().mean().sqrt()
    tiny = float(np.finfo(np.float32).tiny)
    return (diff.norm(dim=1) / w_norm.clamp(min=floor).clamp(min=tiny)
            ).max().item()


def fwd_errors(got, want) -> dict[str, float]:
    """B1's (out, lse) against the plain version's: the max abs error of
    out and of lse, and the row error of out (see ROW_TOL)."""
    (out, lse), (want_out, want_lse) = got, want
    if out.shape != want_out.shape or out.dtype != want_out.dtype:
        raise AssertionError(f"flash: out {tuple(out.shape)} {out.dtype} vs "
                             f"{tuple(want_out.shape)} {want_out.dtype}")
    diff = (out.float() - want_out.float()).flatten(0, -2)
    return {"max_abs_err": diff.abs().max().item(),
            "lse_err": (lse - want_lse).abs().max().item(),
            "row_err": row_error(diff, want_out.float().flatten(0, -2))}


def fwd_checks(errs: dict, dtype, rows: bool = False) -> dict[str, bool]:
    """Whether B1's readings (fwd_errors) pass each of its checks: out and
    lse within TOL and, with ``rows``, out row by row within ROW_TOL."""
    checks = {"max_abs": errs["max_abs_err"] <= TOL[("flash_fwd",
                                                     str(dtype))],
              "lse": errs["lse_err"] <= TOL[("flash_lse", str(dtype))]}
    if rows:
        checks["row"] = errs["row_err"] <= ROW_TOL
    return checks


def _check_fwd(tag, got, want, dtype, rows: bool = False,
               quiet: bool = False) -> float:
    """Holds B1's (out, lse) against the plain version's (fwd_checks);
    returns the max abs error of out. ``quiet`` logs nothing on success."""
    errs = fwd_errors(got, want)
    if not all(fwd_checks(errs, dtype, rows).values()):
        raise AssertionError(
            f"flash {tag}: {json.dumps(errs)} (tol "
            f"{TOL[('flash_fwd', str(dtype))]}, lse tol "
            f"{TOL[('flash_lse', str(dtype))]}"
            f"{f', row tol {ROW_TOL}' if rows else ''})")
    if rows and not quiet:
        log(f"flash {tag}: {json.dumps(errs)}: ok")
    elif not quiet:
        log(f"flash {tag}: out err {errs['max_abs_err']:.3g}, lse err "
            f"{errs['lse_err']:.3g}: ok")
    return errs["max_abs_err"]


def _flash_case(torch, attention, gen, *, b, t_q, t_k, h, h_kv, d, causal,
                dtype, fused=False):
    dev = "cuda"
    if fused:
        # q/k/v as views of one fused projection, as the prefill passes them.
        qkv = torch.randn(b, t_q, h + 2 * h_kv, d, generator=gen,
                          device=dev).to(dtype)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + h_kv], qkv[:, :, h + h_kv:]
    else:
        q = torch.randn(b, t_q, h, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, t_k, h_kv, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, t_k, h_kv, d, generator=gen, device=dev).to(dtype)
    scale = d ** -0.5
    out, lse = attention._flash_attention_cuda(q, k, v, causal=causal,
                                               scale=scale)
    want = attention._flash_plain_bthd(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    tag = (f"b={b} tq={t_q} tk={t_k} h={h}/{h_kv} d={d} causal={causal} "
           f"{dtype}{' fused' if fused else ''}")
    err = _check_fwd(tag, (out, lse), want, dtype)
    if causal and t_q > t_k:
        # Rows before the first key are fully masked: O = 0, lse = log(1e-30).
        n_masked = t_q - t_k
        if out[:, :n_masked].abs().max().item() != 0.0:
            raise AssertionError(f"flash {tag}: masked rows not zero")
        lse_m = lse[:, :, :n_masked]
        if (lse_m - np.log(1e-30)).abs().max().item() > 1e-3:
            raise AssertionError(f"flash {tag}: masked-row lse wrong")
    return err


# The bf16 tiles of flash_fwd.cu that the edge cases straddle, in rows, by
# head_dim: B1's work items of query rows (FwdBf16::kM, warpgroups of 64),
# its streamed key tiles (FwdBf16::kN) and the keys its TMA ring holds
# (kStages x kN). A CPU test holds these against the source's constants.
FWD_TILES = {
    64: {"rows": 192, "keys": 128, "ring_keys": 512},
    128: {"rows": 128, "keys": 128, "ring_keys": 384},
}

FLASH_FWD_CASES = [
    # main path: DecodeSession.generate prefill, B*H = 8*16, T 128
    dict(b=8, t_q=128, t_k=128, h=16, h_kv=4, d=64, causal=True, fused=True),
    dict(b=8, t_q=128, t_k=128, h=16, h_kv=4, d=64, causal=True),
    dict(b=2, t_q=100, t_k=100, h=16, h_kv=4, d=64, causal=True),
    dict(b=2, t_q=257, t_k=257, h=4, h_kv=4, d=64, causal=True),
    dict(b=1, t_q=37, t_k=300, h=8, h_kv=2, d=64, causal=True),
    dict(b=2, t_q=257, t_k=257, h=8, h_kv=2, d=128, causal=True),
    dict(b=2, t_q=100, t_k=257, h=8, h_kv=4, d=128, causal=False),
    dict(b=2, t_q=65, t_k=130, h=4, h_kv=1, d=64, causal=False),
    dict(b=1, t_q=80, t_k=50, h=4, h_kv=2, d=64, causal=True),
    # Edges of the bf16 tiles (query tiles of 64 or 128 rows, streamed key
    # tiles of 32 to 128 keys) and of the key double buffer: one below, at
    # and one above one and two tiles.
    dict(b=1, t_q=15, t_k=15, h=4, h_kv=2, d=64, causal=True),
    dict(b=1, t_q=17, t_k=17, h=4, h_kv=2, d=64, causal=False),
    dict(b=1, t_q=31, t_k=31, h=4, h_kv=2, d=64, causal=True),
    dict(b=1, t_q=33, t_k=33, h=4, h_kv=2, d=64, causal=True),
    dict(b=1, t_q=63, t_k=63, h=4, h_kv=2, d=64, causal=True),
    dict(b=1, t_q=64, t_k=64, h=4, h_kv=2, d=64, causal=True),
    dict(b=1, t_q=65, t_k=65, h=4, h_kv=2, d=64, causal=False),
    dict(b=1, t_q=127, t_k=127, h=4, h_kv=4, d=64, causal=True),
    dict(b=1, t_q=128, t_k=128, h=4, h_kv=4, d=64, causal=False),
    dict(b=1, t_q=129, t_k=129, h=4, h_kv=4, d=64, causal=True),
    dict(b=1, t_q=31, t_k=31, h=4, h_kv=2, d=128, causal=True),
    dict(b=1, t_q=33, t_k=33, h=4, h_kv=2, d=128, causal=False),
    dict(b=1, t_q=63, t_k=63, h=4, h_kv=4, d=128, causal=False),
    dict(b=1, t_q=65, t_k=65, h=4, h_kv=4, d=128, causal=True),
    # t_q under one tile, t_k over two
    dict(b=1, t_q=20, t_k=150, h=4, h_kv=2, d=64, causal=True),
    dict(b=1, t_q=20, t_k=150, h=4, h_kv=2, d=128, causal=True),
    dict(b=1, t_q=20, t_k=150, h=4, h_kv=2, d=64, causal=False),
    # a single-tile sequence
    dict(b=2, t_q=16, t_k=16, h=4, h_kv=4, d=64, causal=True),
    dict(b=2, t_q=16, t_k=16, h=4, h_kv=1, d=128, causal=True),
    # GQA group 8 at head_dim 128
    dict(b=1, t_q=160, t_k=160, h=8, h_kv=1, d=128, causal=True),
    dict(b=1, t_q=100, t_k=100, h=8, h_kv=1, d=128, causal=False),
    # causal t_q > t_k: whole query tiles (of 64 and of 128 rows) see no
    # key at all, so their blocks run no key tile
    dict(b=1, t_q=300, t_k=50, h=4, h_kv=2, d=64, causal=True),
    dict(b=1, t_q=150, t_k=20, h=4, h_kv=4, d=128, causal=True),
    # a fused projection's strided views at ragged T and head_dim 128
    dict(b=2, t_q=100, t_k=100, h=8, h_kv=2, d=128, causal=True, fused=True),
    dict(b=1, t_q=65, t_k=65, h=4, h_kv=4, d=64, causal=False, fused=True),
    # Edges of the bf16 tiles and of the TMA ring (see FWD_TILES): one
    # below, at and one above one and two query tiles, one key tile and the
    # ring's depth in keys, at head_dim 64 and 128, causal and not, with
    # the GQA group varying along the list.
    *[dict(b=1, t_q=t, t_k=t, h=4, h_kv=(2, 4, 1)[i % 3], d=d,
           causal=causal)
      for d, tiles in FWD_TILES.items() for i, t in enumerate(sorted(
          {n * tiles["rows"] + step for n in (1, 2) for step in (-1, 0, 1)}
          | {tiles[k] + step for k in ("keys", "ring_keys")
             for step in (-1, 0, 1)}))
      for causal in (True, False)],
]


def fwd_bound(q, k) -> tuple[float, str]:
    """B1's bound (ms, "bytes" | "operations"), causal, at q's and k's
    shapes: q/k/v read once, out and lse written once; two products over
    the visible pairs."""
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    nbytes = b * t * d * q.element_size() * (2 * h + 2 * h_kv) + b * h * t * 4
    pairs = b * h * t * (t + 1) // 2  # causal (query, key) pairs
    return bound(nbytes, 2 * 2 * d * pairs, q.dtype)


def time_fwd(torch, attention, q, k, v, iters: int,
             plain_iters: int) -> dict:
    """Device ms of B1 (causal), its plain version and SDPA's forward on
    the same inputs (SDPA in its [B, H, T, D] layout with the KV heads
    repeated, both outside the timed region), and B1's bound."""
    h, h_kv, d = q.shape[2], k.shape[2], q.shape[3]
    scale = d ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.transpose(1, 2).contiguous()
    ks, vs = (x.repeat_interleave(h // h_kv, dim=2).transpose(1, 2)
              .contiguous() for x in (k, v))
    res = {
        "ms": device_ms(torch, lambda: attention._flash_attention_cuda(
            q, k, v, causal=True, scale=scale), iters),
        "plain_ms": device_ms(torch, lambda: attention._flash_plain_bthd(
            q, k, v, causal=True, scale=scale), plain_iters),
        "library_ms": library_ms(
            torch, f"SDPA forward {list(q.shape)}",
            lambda: sdpa(qs, ks, vs, is_causal=True), iters),
    }
    res["bound"] = fwd_bound(q, k)
    return res


def check_flash(torch, attention, gen) -> dict:
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_FWD_CASES:
            err = _flash_case(torch, attention, gen, dtype=dtype, **case)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    # The generate prefill's shape, bf16, as slice 1 timed it.
    b, t, h, h_kv, d = 8, 128, 16, 4, 64
    q = torch.randn(b, t, h, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn(b, t, h_kv, d, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    prefill = time_fwd(torch, attention, q, k, v, 50, 50)
    log(f"flash [8x16, 128, 64] bf16 causal (generate prefill) device ms: "
        f"{json.dumps(prefill)}")
    return {
        "name": "flash_fwd", "route": "cuda",
        "source": "tony_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "tony_tpu/ops/attention.py:52",
        "max_abs_err": worst, "prefill_shape": prefill,
    }


def _flash_bwd_case(torch, attention, gen, *, b, t_q, t_k, h, h_kv, d,
                    causal, dtype, g_lse=False, strided_do=False):
    """B2 + B3 (``_flash_bwd_cuda``) against ``_flash_bwd_plain`` on the
    same inputs, out and lse from B1. Returns the max abs error of dq
    and of dk/dv."""
    dev = "cuda"
    q = torch.randn(b, t_q, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, t_k, h_kv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, t_k, h_kv, d, generator=gen, device=dev).to(dtype)
    scale = d ** -0.5
    out, lse = attention._flash_attention_cuda(q, k, v, causal=causal,
                                               scale=scale)
    if strided_do:
        # dO as autograd may hand it over: a transposed, non-contiguous view.
        do = torch.randn(b, h, t_q, d, generator=gen,
                         device=dev).to(dtype).transpose(1, 2)
    else:
        do = torch.randn(b, t_q, h, d, generator=gen, device=dev).to(dtype)
    gl = (torch.randn(b, h, t_q, generator=gen, device=dev) if g_lse
          else None)
    got = attention._flash_bwd_cuda(q, k, v, out, lse, do, causal=causal,
                                    scale=scale, g_lse=gl)
    want = attention._flash_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                      scale=scale, g_lse=gl)
    tag = (f"b={b} tq={t_q} tk={t_k} h={h}/{h_kv} d={d} causal={causal} "
           f"{dtype}{' g_lse' if g_lse else ''}"
           f"{' strided dO' if strided_do else ''}")
    errs = _check_bwd(torch, tag, got, want, dtype)
    if causal and t_q > t_k:
        # Rows before the first key see nothing: their dq is exactly 0.
        if got[0][:, :t_q - t_k].abs().max().item() != 0.0:
            raise AssertionError(f"flash bwd {tag}: masked rows' dq not 0")
    return errs


def bwd_errors(torch, got, want) -> dict[str, dict[str, float]]:
    """For each of dq, dk, dv: the max abs error, the largest |gradient| of
    the plain version (max_want) and the row error (see ROW_TOL)."""
    out = {}
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"flash bwd: {name} {tuple(x.shape)} "
                                 f"{x.dtype} vs {tuple(y.shape)} {y.dtype}")
        diff = (x.float() - y.float()).flatten(0, -2)
        w = y.float().flatten(0, -2)
        out[name] = {
            "max_abs_err": diff.abs().max().item(),
            "max_want": w.abs().max().item(),
            "row_err": row_error(diff, w),
        }
    return out


def _check_bwd(torch, tag, got, want, dtype, rows: bool = False,
               quiet: bool = False) -> tuple[float, float]:
    """Holds (dq, dk, dv) from B2 + B3 against the plain version's within
    TOL, and with ``rows`` row by row within ROW_TOL; returns the max abs
    error of B2 (dq) and of B3 (dk and dv). ``quiet`` logs nothing on
    success."""
    tol = TOL[("flash_bwd", str(dtype))]
    errs = bwd_errors(torch, got, want)
    for name, e in errs.items():
        ref = max(1.0, e["max_want"])
        if not e["max_abs_err"] <= tol * ref:
            raise AssertionError(f"flash bwd {tag}: {name} max abs err "
                                 f"{e['max_abs_err']} > {tol} * {ref}")
        if rows and not e["row_err"] <= ROW_TOL:
            raise AssertionError(f"flash bwd {tag}: {name} row err "
                                 f"{e['row_err']} > {ROW_TOL}")
    if rows and not quiet:
        log(f"flash bwd {tag}: " + json.dumps(errs) + ": ok")
    elif not quiet:
        log(f"flash bwd {tag}: dq/dk/dv err " + "/".join(
            f"{e['max_abs_err']:.3g}" for e in errs.values()) + ": ok")
    return errs["dq"]["max_abs_err"], max(errs["dk"]["max_abs_err"],
                                          errs["dv"]["max_abs_err"])


# The bf16 tiles of flash_bwd.cu that the edge cases straddle, in rows, by
# head_dim: B2's blocks of query rows (DqBf16::kM, warpgroups of 64) and its
# streamed key tiles (DqBf16::kN); B3's blocks of keys (DkvBf16::kN) and
# its streamed query tiles (DkvBf16::kM). A CPU test holds these against
# the source's constants.
BWD_TILES = {
    64: {"dq_rows": 192, "dq_keys": 64, "dkv_keys": 192, "dkv_rows": 64},
    128: {"dq_rows": 192, "dq_keys": 64, "dkv_keys": 128, "dkv_rows": 64},
}

FLASH_BWD_CASES = [
    # the training shape's head layout at a shorter T, MHA
    dict(b=2, t_q=256, t_k=256, h=16, h_kv=16, d=64, causal=True),
    dict(b=2, t_q=256, t_k=256, h=16, h_kv=16, d=64, causal=False),
    # T not a multiple of 64, GQA groups 2 and 4
    dict(b=2, t_q=200, t_k=200, h=8, h_kv=4, d=64, causal=True),
    dict(b=1, t_q=131, t_k=131, h=8, h_kv=2, d=64, causal=False),
    # t_q < t_k (queries at the end of the keys)
    dict(b=1, t_q=37, t_k=300, h=8, h_kv=2, d=64, causal=True),
    dict(b=2, t_q=100, t_k=257, h=4, h_kv=1, d=128, causal=False),
    # t_q > t_k: the first t_q - t_k rows are fully masked
    dict(b=1, t_q=150, t_k=70, h=4, h_kv=2, d=64, causal=True),
    dict(b=1, t_q=80, t_k=50, h=4, h_kv=4, d=128, causal=True),
    # head_dim 128, a non-zero lse cotangent, a non-contiguous dO
    dict(b=2, t_q=257, t_k=257, h=8, h_kv=2, d=128, causal=True),
    dict(b=2, t_q=190, t_k=190, h=8, h_kv=4, d=64, causal=True, g_lse=True),
    dict(b=1, t_q=100, t_k=164, h=4, h_kv=4, d=128, causal=False,
         g_lse=True),
    dict(b=2, t_q=129, t_k=129, h=8, h_kv=2, d=64, causal=True,
         strided_do=True),
    # Edges of the bf16 tiles and of their TMA rings: one below, at and one
    # above one and two tiles of each streamed and fixed tile (see
    # BWD_TILES), at head_dim 64 and 128, with the GQA group and the mask
    # varying along the list.
    *[dict(b=1, t_q=t, t_k=t, h=4, h_kv=(2, 4, 1)[i % 3], d=d,
           causal=i % 4 != 1)
      for d, tiles in BWD_TILES.items() for i, t in enumerate(sorted(
          {n * tile + step for tile in set(tiles.values())
           for n in (1, 2) for step in (-1, 0, 1)}))],
    # t_q under one tile, t_k over three streamed tiles
    dict(b=1, t_q=20, t_k=200, h=4, h_kv=2, d=64, causal=True),
    dict(b=1, t_q=20, t_k=200, h=4, h_kv=2, d=128, causal=True),
    dict(b=1, t_q=20, t_k=200, h=4, h_kv=2, d=64, causal=False),
    # a single-tile sequence
    dict(b=2, t_q=16, t_k=16, h=4, h_kv=4, d=64, causal=True),
    dict(b=2, t_q=16, t_k=16, h=4, h_kv=1, d=128, causal=True),
    # GQA group 8 at head_dim 128
    dict(b=1, t_q=160, t_k=160, h=8, h_kv=1, d=128, causal=True),
    dict(b=1, t_q=100, t_k=100, h=8, h_kv=1, d=128, causal=False),
]

def check_flash_bwd(torch, attention, gen) -> tuple[float, float]:
    """B2 and B3 in every listed case, fp32 and bf16; returns the worst
    bf16 max abs error of B2 (dq) and of B3 (dk, dv)."""
    worst_dq = worst_dkv = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_BWD_CASES:
            dq_err, dkv_err = _flash_bwd_case(torch, attention, gen,
                                              dtype=dtype, **case)
            if dtype == torch.bfloat16:
                worst_dq = max(worst_dq, dq_err)
                worst_dkv = max(worst_dkv, dkv_err)
    return worst_dq, worst_dkv


def time_bwd_kernels(torch, attention, q, k, v, out, lse, do):
    """Device ms of B2 and of B3 (causal), split by kernel name from one
    profiled run of five backward calls."""
    scale = q.shape[-1] ** -0.5

    def bwd():
        attention._flash_bwd_cuda(q, k, v, out, lse, do, causal=True,
                                  scale=scale)

    bwd()
    iters = 5
    events, _ = device_events(torch, lambda: [bwd() for _ in range(iters)])
    dq_ms = sum(us for n, us in events if "flash_bwd_dq_kernel" in n)
    dkv_ms = sum(us for n, us in events if "flash_bwd_dkv_kernel" in n)
    if not (dq_ms > 0 and dkv_ms > 0):
        raise AssertionError("the profiler saw no B2/B3 kernel events")
    return dq_ms / iters / 1e3, dkv_ms / iters / 1e3


def check_bwd_deterministic(torch, attention, tag, q, k, v, out, lse, do):
    """B2 and B3 launched twice on the same inputs give bit-equal dq, dk
    and dv: they use no atomics, which the dp phase's bit-equal steps and
    the job phase's exact resume rely on."""
    scale = q.shape[-1] ** -0.5
    first, second = (attention._flash_bwd_cuda(q, k, v, out, lse, do,
                                               causal=True, scale=scale)
                     for _ in range(2))
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        if not torch.equal(x, y):
            raise AssertionError(f"flash bwd {tag}: {name} differs between "
                                 f"two launches on the same inputs")
    log(f"flash bwd {tag}: two launches bit-equal: ok")


def time_bwd_call(torch, attention, q, k, v, out, lse, do) -> float:
    """Device ms of one whole ``_flash_bwd_cuda`` call: B2 with its delta
    prologue, then B3 (every device event the call causes)."""
    scale = q.shape[-1] ** -0.5
    return device_ms(torch, lambda: attention._flash_bwd_cuda(
        q, k, v, out, lse, do, causal=True, scale=scale), 5, warmup=1)


def time_sdpa_bwd(torch, q, k, v, do) -> float:
    """Device ms of SDPA's causal backward (dq, dk, dv) on the same MHA
    inputs in its [B, H, T, D] layout: the library yardstick of B2 + B3."""
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dos = do.transpose(1, 2).contiguous()
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True)
    return library_ms(torch, f"SDPA backward {list(q.shape)}",
                      lambda: torch.autograd.grad(
                          lib_out, (qs, ks, vs), dos, retain_graph=True),
                      5, warmup=1)


def bwd_bounds(q, k):
    """(B2 bound, B3 bound), each (ms, "bytes" | "operations"), of the
    causal backward at q's and k's shapes: each input read once and each
    output written once; 3 (B2) and 4 (B3) products over the visible
    pairs."""
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    tok = b * t * d * q.element_size()
    pairs = b * h * t * (t + 1) // 2  # causal (query, key) pairs
    rows = b * h * t * 4  # one fp32 per query row (lse, delta)
    return (bound(tok * (3 * h + 2 * h_kv) + 2 * rows, 3 * 2 * d * pairs,
                  q.dtype),
            bound(tok * (2 * h + 4 * h_kv) + 2 * rows, 4 * 2 * d * pairs,
                  q.dtype))


def time_attention_hd128(torch, attention, gen) -> dict:
    """B1, B2 and B3 at bench.py's transformer_hd128 attention shape, q/k/v
    [8, 2048, 8, 128] bf16 causal, where their accumulators and fragment
    loops are twice as large: held against the plain versions within TOL
    and row by row within ROW_TOL, B2/B3's determinism, then timed (B2, B3
    and the whole backward call) beside SDPA's forward and backward, with
    the bounds."""
    b, t, h, d = 8, 2048, 8, 128
    dt = torch.bfloat16
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                   .to(dt) for _ in range(4))
    scale = d ** -0.5
    out, lse = attention._flash_attention_cuda(q, k, v, causal=True,
                                               scale=scale)
    fwd_err = _check_fwd("at the hd128 shape", (out, lse),
                         attention._flash_plain_bthd(q, k, v, causal=True,
                                                     scale=scale),
                         dt, rows=True)
    dq_err, dkv_err = _check_bwd(
        torch, "at the hd128 shape",
        attention._flash_bwd_cuda(q, k, v, out, lse, do, causal=True,
                                  scale=scale),
        attention._flash_bwd_plain(q, k, v, out, lse, do, causal=True,
                                   scale=scale), dt, rows=True)
    check_bwd_deterministic(torch, attention, "at the hd128 shape", q, k, v,
                            out, lse, do)
    dq_ms, dkv_ms = time_bwd_kernels(torch, attention, q, k, v, out, lse, do)
    dq_bound, dkv_bound = bwd_bounds(q, k)
    sdpa_bwd_ms = time_sdpa_bwd(torch, q, k, v, do)
    res = {"flash_fwd": dict(max_abs_err=fwd_err,
                             **time_fwd(torch, attention, q, k, v, 10, 3)),
           "flash_bwd_dq": dict(max_abs_err=dq_err, ms=dq_ms,
                                bound=dq_bound),
           "flash_bwd_dkv": dict(max_abs_err=dkv_err, ms=dkv_ms,
                                 bound=dkv_bound),
           "sdpa_bwd_ms": sdpa_bwd_ms,
           "bwd_call_ms": time_bwd_call(torch, attention, q, k, v, out, lse,
                                        do),
           "pair_over_sdpa_bwd": (dq_ms + dkv_ms) / sdpa_bwd_ms}
    log("attention at the hd128 shape q/k/v [8, 2048, 8, 128] bf16 causal, "
        "device ms (flash_fwd's library_ms: SDPA's forward): "
        + json.dumps(res))
    return res


def time_attention(torch, attention, gen) -> dict:
    """B1, B2 and B3 at the training shape: first their outputs against the
    plain versions' on the same inputs (within TOL and row by row within
    ROW_TOL; the max abs errors are returned under "max_abs_err"), then
    B2/B3's determinism (check_bwd_deterministic), the device time of each
    kernel (B2 and B3 split by kernel name from one profiled backward) and
    of the whole backward call, their plain versions, SDPA forward and
    SDPA backward as library yardsticks, and the bounds."""
    b, t, h, h_kv, d = (TRAIN_ATTN[k] for k in ("b", "t", "h", "h_kv", "d"))
    dt = torch.bfloat16
    q = torch.randn(b, t, h, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, t, h_kv, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, t, h_kv, d, generator=gen, device="cuda").to(dt)
    do = torch.randn(b, t, h, d, generator=gen, device="cuda").to(dt)
    scale = d ** -0.5
    out, lse = attention._flash_attention_cuda(q, k, v, causal=True,
                                               scale=scale)
    fwd_err = _check_fwd("at the training shape", (out, lse),
                         attention._flash_plain_bthd(q, k, v, causal=True,
                                                     scale=scale),
                         dt, rows=True)
    dq_err, dkv_err = _check_bwd(
        torch, "at the training shape",
        attention._flash_bwd_cuda(q, k, v, out, lse, do, causal=True,
                                  scale=scale),
        attention._flash_bwd_plain(q, k, v, out, lse, do, causal=True,
                                   scale=scale), dt, rows=True)
    check_bwd_deterministic(torch, attention, "at the training shape", q, k,
                            v, out, lse, do)
    fwd = time_fwd(torch, attention, q, k, v, 10, 3)

    dq_ms, dkv_ms = time_bwd_kernels(torch, attention, q, k, v, out, lse, do)
    call_ms = time_bwd_call(torch, attention, q, k, v, out, lse, do)
    bwd_plain_ms = device_ms(torch, lambda: attention._flash_bwd_plain(
        q, k, v, out, lse, do, causal=True, scale=scale), 3, warmup=1)
    lib_bwd_ms = time_sdpa_bwd(torch, q, k, v, do)
    dq_bound, dkv_bound = bwd_bounds(q, k)
    res = {
        "flash_fwd": dict(max_abs_err=fwd_err, **fwd),
        "flash_bwd_dq": dict(max_abs_err=dq_err, ms=dq_ms,
                             plain_ms=bwd_plain_ms, library_ms=lib_bwd_ms,
                             bound=dq_bound),
        "flash_bwd_dkv": dict(max_abs_err=dkv_err, ms=dkv_ms,
                              plain_ms=bwd_plain_ms, library_ms=lib_bwd_ms,
                              bound=dkv_bound),
        "bwd_call_ms": call_ms,
        "pair_over_sdpa_bwd": (dq_ms + dkv_ms) / lib_bwd_ms,
    }
    log("attention at the training shape q/k/v [8, 2048, 16, 64] bf16 "
        "causal, device ms: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# Phases 3-6: the serving path at full width
# ---------------------------------------------------------------------------

def _post(port: int, path: str, obj: dict, timeout: float = 300.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def make_requests(cfg, session, seed: int, n_requests: int) -> list[dict]:
    """Request bodies: prompt lengths 16-96, budgets 8-64. Half carry an
    EOS id taken from their own greedy continuation (DecodeSession), so
    retirement before the budget is exercised."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(16, 97, n_requests)]
    budgets = [int(n) for n in rng.integers(8, 65, n_requests)]
    bodies = []
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        body = {"prompt": p.tolist(), "max_new_tokens": n}
        if i % 2 == 0:
            ref = session.generate(p[None], n)[0].cpu().numpy()
            body["eos_id"] = int(ref[n // 2])
        bodies.append(body)
    return bodies


def serve_phase(cfg, session, seed: int, bodies: list[dict],
                kv_quant: str = "none") -> dict:
    from tony_tpu_torch.serving import ServingEngine
    from tony_tpu_torch.serving.http import ServingServer

    n_requests = len(bodies)
    engine = ServingEngine(session.params, cfg, device="cuda", slots=16,
                           prefill_chunk=32, seed=seed,
                           kv_quant=kv_quant).start()
    server = ServingServer(engine, port=0, host="127.0.0.1")
    port = server.start()
    try:
        warm = _post(port, "/generate", {"prompt": [1, 2, 3, 4],
                                         "max_new_tokens": 4})
        if warm["length"] != 4:
            raise AssertionError(f"warm-up request: {warm}")
        engine.ttft_ms_samples.clear()
        engine.inter_token_ms_samples.clear()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(n_requests) as pool:
            futures = [pool.submit(_post, port, "/generate", body)
                       for body in bodies]
            results = [f.result() for f in futures]
        wall = time.perf_counter() - t0
        for body, res in zip(bodies, results):
            toks = res["tokens"]
            n, eos = body["max_new_tokens"], body.get("eos_id")
            if res["length"] != len(toks) or not 1 <= len(toks) <= n:
                raise AssertionError(f"bad length {res['length']} for "
                                     f"budget {n}")
            if not all(0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError("token out of range")
            if eos is None and len(toks) != n:
                raise AssertionError(f"no-eos request stopped at "
                                     f"{len(toks)} of {n}")
            if eos is not None and eos in toks[:-1]:
                raise AssertionError("request ran past its eos_id")
            if eos is not None and len(toks) < n and toks[-1] != eos:
                raise AssertionError("request stopped early without eos")
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=30).read())
        if health["slots"] != 16 or health["retired"] < n_requests + 1:
            raise AssertionError(f"healthz: {health}")
        if _post(port, "/shutdown", {}).get("ok") is not True:
            raise AssertionError("shutdown not acknowledged")
        if not server.wait_shutdown(timeout=10):
            raise AssertionError("server did not see /shutdown")
        if not engine.drain(timeout=60):
            raise AssertionError("engine did not drain")
    finally:
        server.stop()
        engine.close()
    n_tokens = sum(r["length"] for r in results)
    n_eos_hit = sum(1 for b, r in zip(bodies, results)
                    if b.get("eos_id") is not None
                    and r["length"] < b["max_new_tokens"])
    out = {
        "requests": n_requests, "generated_tokens": n_tokens,
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "ttft_p50_ms": float(np.percentile(engine.ttft_ms_samples, 50)),
        "ttft_p95_ms": float(np.percentile(engine.ttft_ms_samples, 95)),
        "inter_token_p50_ms": float(
            np.percentile(engine.inter_token_ms_samples, 50)),
        "inter_token_p95_ms": float(
            np.percentile(engine.inter_token_ms_samples, 95)),
        "eos_retired_early": n_eos_hit,
    }
    log(f"serve (kv_quant {kv_quant}): " + json.dumps(out))
    return out


def generate_phase(torch, cfg, session, seed: int) -> dict:
    rng = np.random.default_rng(seed + 1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 128)),
                             device="cuda")
    session.generate(prompt, 8)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = session.generate(prompt, 128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if tuple(out.shape) != (8, 128):
        raise AssertionError(f"generate shape {tuple(out.shape)}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError("generate token out of range")
    res = {"batch": 8, "prompt": 128, "new_tokens": 128, "wall_s": wall,
           "tokens_per_s": 8 * 128 / wall}
    log("generate: " + json.dumps(res))
    return res


def profile_phase(torch, cfg, session, kv_quant: str = "none") -> dict:
    """Device time by kernel over 8 decode steps of a full 16-slot batch at
    position ~100 (cache contents are irrelevant to the timing). The busy
    share divides the profiled call's device time by that same call's wall
    time, which the profiler's host-side recording lengthens; the wall of
    an unprofiled call is reported beside it."""
    from tony_tpu_torch.serving import engine as eng

    k_all, v_all = eng.init_slot_cache(cfg, 16, cfg.max_seq,
                                       kv_quant=kv_quant, device="cuda")
    pos = np.full(16, 100, np.int32)
    toks = np.arange(16, dtype=np.int32)
    temp = np.zeros(16, np.float32)

    def window():
        return eng.decode_window(session.params, k_all, v_all, pos, pos,
                                 toks, temp, 0, 0, cfg=cfg, steps=8)

    window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    unprofiled_wall_ms = (time.perf_counter() - t0) * 1e3
    events, wall_ms = device_events(torch, window)
    by_name: dict[str, list[float]] = {}
    for name, us in events:
        by_name.setdefault(name, []).append(us)
    rows = sorted(((sum(v), k, len(v)) for k, v in by_name.items()),
                  reverse=True)
    total_ms = sum(us for _, us in events) / 1e3
    res = {
        "steps": 8, "wall_ms": wall_ms, "device_ms": total_ms,
        "device_busy_share": total_ms / wall_ms,
        "unprofiled_wall_ms": unprofiled_wall_ms,
        "top": [{"kernel": k[:90], "device_ms": us / 1e3, "count": c}
                for us, k, c in rows[:12]],
    }
    log(f"profile (kv_quant {kv_quant}): " + json.dumps(res))
    return res


def _staggered(engine, prompts) -> tuple[list, int]:
    """PARITY_REQUESTS' prompts submitted at their engine steps and the
    engine stepped until all retire; closes it. Returns the requests and
    the most slots live at once."""
    reqs: list = [None] * len(prompts)
    max_live = 0
    for step in range(400):
        for i, (p, (_, n, at)) in enumerate(zip(prompts, PARITY_REQUESTS)):
            if at == step:
                reqs[i] = engine.submit(p, n)
        engine.step()
        max_live = max(max_live, engine.stats()["active_slots"])
        if all(r is not None and r.done() for r in reqs):
            break
    engine.close()
    return reqs, max_live


def parity_phase(torch, params, seed: int, cfg_kw: dict = FLAGSHIP,
                 tag: str = "parity") -> dict:
    """fp32, TF32 off: staggered requests of mixed lengths through the
    engine (chunked prefill + slot decode, several slots live at once)
    each equal DecodeSession.generate (flash prefill + cache decode) token
    for token, at decode windows 1 and 3. ``cfg_kw``: the model (FLAGSHIP,
    or an MoE trunk, which both sides evaluate as the dense mixture)."""
    from tony_tpu_torch.models import DecodeSession, TransformerConfig
    from tony_tpu_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(dtype="float32", **cfg_kw)
    session = DecodeSession(params, cfg, device="cuda")
    rng = np.random.default_rng(seed + 2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _, _ in PARITY_REQUESTS]
    wants = [session.generate(p[None], n)[0].cpu().numpy()
             for p, (_, n, _) in zip(prompts, PARITY_REQUESTS)]
    n_tokens = 0
    for window in (1, 3):
        engine = ServingEngine(session.params, cfg, device="cuda",
                               slots=PARITY_SLOTS, prefill_chunk=32,
                               prefill_batch=4, decode_window=window,
                               max_len=256, seed=seed)
        reqs, max_live = _staggered(engine, prompts)
        for i, (req, want) in enumerate(zip(reqs, wants)):
            got = np.asarray(req.result(timeout=1)["tokens"])
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"{tag}: engine/generate parity broken (window {window}, "
                    f"request {i}, prompt {prompts[i].size}):\n  engine   "
                    f"{got.tolist()}\n  generate {want.tolist()}")
            n_tokens += int(got.size)
        if max_live <= engine.prefill_batch:
            raise AssertionError(f"only {max_live} slots were live at once")
        log(f"{tag} fp32, decode window {window}: {len(reqs)} requests "
            f"equal, up to {max_live} slots live at once, "
            f"{engine.stats()['retired']} retired")
    return {"requests": len(prompts), "tokens": n_tokens}


def cache_bytes(k, v) -> int:
    """Bytes of a slot cache pair, an int8 one's scale planes included."""
    return sum(t.numel() * t.element_size() for buf in (k, v)
               for t in (tuple(buf) if isinstance(buf, tuple) else (buf,)))


def _teacher_forced(params, cfg, prompt, cont, kv_quant: str):
    """fp32 logits [n, V] (float64 on the host) at each position of
    ``prompt`` + ``cont``'s first n tokens (row j: the prompt and cont[:j])
    through one prefill_chunks call on a cache of ``kv_quant``, a slot a
    row."""
    from tony_tpu_torch.serving import engine as eng

    n = len(cont)
    seq = np.concatenate([prompt, cont[:-1]]).astype(np.int32)
    tokens = np.zeros((n, len(seq)), np.int32)
    for j in range(n):
        tokens[j, :len(prompt) + j] = seq[:len(prompt) + j]
    k, v = eng.init_slot_cache(cfg, n, 256, kv_quant=kv_quant,
                               device="cuda")
    _, _, _, logits = eng.prefill_chunks(
        params, k, v, tokens, np.arange(n, dtype=np.int32),
        np.zeros(n, np.int32),
        np.arange(len(prompt), len(prompt) + n, dtype=np.int32),
        np.zeros(n, np.float32), 0, 0, cfg=cfg)
    return logits.double().cpu()


def int8_parity(torch, params, seed: int) -> dict:
    """fp32, TF32 off, the flagship model: the int8 engine against itself
    and against the float cache. PARITY_REQUESTS through the int8 engine
    at decode windows 1 and 3 give equal tokens. Against the float
    engine's tokens (DecodeSession.generate's, which parity_phase holds
    equal to them), fed back teacher-forced through prefill_chunks on a
    float and on an int8 cache: the float logits' argmax is the float
    token at every position, the int8 logits lie within INT8_LOGIT_TOL of
    the float logits, and where the int8 engine's free-running tokens
    first leave the float ones, the float logits' top-2 margin there is
    below the int8 perturbation (a near-tie the quantization may flip)
    and the engine took the int8 logits' argmax. JAX's per-request bound
    (an agreeing prefix of min(8, n), n // 2 equal) is printed as a
    reading: on this random-weight model a near-tie can end a prefix
    early. _quantize on the card is bit-equal to _quantize on the CPU for
    the same fp32 rows. A slot's exported rows after a prefill, against
    the float engine's for the same prompt: layer 0 equal to
    _materialize(_quantize(.)) of the float rows (both engines store the
    same rows there); past layer 0 they differ by what attention over the
    int8 cache changed, which is printed in units of JAX's round-trip
    bound. The float rows of every layer injected into an int8 cache
    export as _materialize(_quantize(.)) of themselves, within JAX's
    round-trip bound amax / 127 + 1e-6."""
    from tony_tpu_torch.models import DecodeSession, TransformerConfig
    from tony_tpu_torch.serving import ServingEngine
    from tony_tpu_torch.serving import engine as eng

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(dtype="float32", **FLAGSHIP)
    session = DecodeSession(params, cfg, device="cuda")
    rng = np.random.default_rng(seed + 2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _, _ in PARITY_REQUESTS]
    wants = [session.generate(p[None], n)[0].cpu().numpy()
             for p, (_, n, _) in zip(prompts, PARITY_REQUESTS)]
    by_window = {}
    for window in (1, 3):
        engine = ServingEngine(session.params, cfg, device="cuda",
                               slots=PARITY_SLOTS, prefill_chunk=32,
                               prefill_batch=4, decode_window=window,
                               max_len=256, seed=seed, kv_quant="int8")
        reqs, max_live = _staggered(engine, prompts)
        if max_live <= engine.prefill_batch:
            raise AssertionError(f"only {max_live} slots were live at once")
        by_window[window] = [req.result(timeout=1)["tokens"] for req in reqs]
    if by_window[1] != by_window[3]:
        raise AssertionError(f"int8 engine: decode windows 1 and 3 differ:"
                             f"\n  {by_window[1]}\n  {by_window[3]}")
    agreement = []
    for i, (got, want, prompt) in enumerate(zip(by_window[1], wants,
                                                prompts)):
        lf, lq = (_teacher_forced(session.params, cfg, prompt, want, mode)
                  for mode in ("none", "int8"))
        top2 = lf.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).numpy()
        delta = (lq - lf).abs().amax(-1).numpy()
        af, aq = lf.argmax(-1).numpy(), lq.argmax(-1).numpy()
        want = want.tolist()
        prefix = next((j for j, (a, b) in enumerate(zip(got, want))
                       if a != b), len(want))
        equal = sum(int(a == b) for a, b in zip(got, want))
        flips = np.flatnonzero(af != aq).tolist()
        agreement.append({
            "n": len(want), "prefix": prefix, "equal": equal,
            "jax_bound": (prefix >= min(8, len(want))
                          and equal >= len(want) // 2),
            "max_logit_delta": float(delta.max()),
            "teacher_forced_flips": flips,
            "margin_at_flips": [float(margin[j]) for j in flips]})
        if af.tolist() != want:
            raise AssertionError(f"request {i}: the float cache's prefill "
                                 f"argmax {af.tolist()} != its greedy "
                                 f"tokens {want}")
        if delta.max() > INT8_LOGIT_TOL:
            raise AssertionError(f"request {i}: int8 logits {delta.max()} "
                                 f"from the float ones > {INT8_LOGIT_TOL}")
        if len(got) != len(want):
            raise AssertionError(f"request {i}: {len(got)} int8 tokens of "
                                 f"{len(want)}")
        if prefix < len(want) and not (margin[prefix] <= delta[prefix]
                                       and aq[prefix] == got[prefix]):
            raise AssertionError(
                f"int8 engine: request {i} leaves the float tokens at "
                f"{prefix} (float top-2 margin {margin[prefix]}, int8 "
                f"perturbation {delta[prefix]}, int8 argmax {aq[prefix]}):"
                f"\n  int8  {got}\n  float {want}")

    gen = torch.Generator().manual_seed(seed)
    rows = (torch.randn(16, 2048, cfg.kv_heads, cfg.head_dim, generator=gen)
            * torch.rand(16, 2048, cfg.kv_heads, 1, generator=gen) * 8)
    on_cpu, on_card = eng._quantize(rows), eng._quantize(rows.cuda())
    if not (torch.equal(on_card.data.cpu(), on_cpu.data)
            and torch.equal(on_card.scale.cpu(), on_cpu.scale)):
        raise AssertionError("_quantize on the card differs from the CPU")

    prompt = prompts[2]
    exported = {}
    for mode in ("none", "int8"):
        engine = ServingEngine(session.params, cfg, device="cuda", slots=2,
                               max_len=256, seed=seed, kv_quant=mode)
        req = engine.prefill_only(prompt, 4)
        for _ in range(100):
            if req.done():
                break
            engine.step()
        engine.close()
        req.result(timeout=1)
        exported[mode] = req.kv
    drift = []
    for i, name in enumerate(("k", "v")):
        ref = torch.from_numpy(exported["none"][i])
        got = torch.from_numpy(exported["int8"][i])
        want = eng._materialize(eng._quantize(ref), torch.float32)
        # Layer 0 quantizes the very rows the float engine stores.
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"int8 export of {name}, layer 0: not "
                                 f"the quantized float rows")
        # The exchange: the float rows injected into an int8 cache come
        # back as their round trip, within amax / 127 + 1e-6 of them.
        cache, _ = eng.init_slot_cache(cfg, 2, 256, kv_quant="int8",
                                       device="cuda")
        eng.cache_inject_rows(cache, 1, ref)
        back = eng.cache_export_rows(cache, 1, ref.shape[1]).cpu()
        bound = float(ref.abs().max()) / 127 + 1e-6
        if not (torch.equal(back, want)
                and float((back - ref).abs().max()) <= bound):
            raise AssertionError(f"int8 exchange of {name}: the injected "
                                 f"rows do not come back as their round "
                                 f"trip within {bound}")
        # Past layer 0 the prefilled rows differ by what attention over the
        # int8 cache changed: a reading, in round-trip bounds.
        drift += [float((got[layer] - ref[layer]).abs().max())
                  / (float(ref[layer].abs().max()) / 127 + 1e-6)
                  for layer in range(cfg.n_layers)]
    res = {"requests": len(prompts), "agreement": agreement,
           "quantize_card_equals_cpu": True,
           "prefill_export_over_round_trip_bound": max(drift)}
    log("int8 parity fp32: " + json.dumps(res))
    return res


def int8_serve_phase(torch, attention, norms, cfg, session, params,
                     seed: int, bodies: list[dict], float_serve: dict,
                     float_profile: dict) -> dict:
    """The int8 KV cache at the flagship's full width: ServingEngine(
    kv_quant="int8"), 16 slots, max_len cfg.max_seq, behind the HTTP
    server, answering the serve phase's requests (launch counters from 0
    around it: the serve_int8 path), beside the float engine's readings
    of this run; the cache bytes of both modes, the peak device memory,
    one profiled decode window in both modes; then int8_parity in fp32."""
    from tony_tpu_torch.serving import engine as eng

    sizes = {mode: cache_bytes(*eng.init_slot_cache(
        cfg, 16, cfg.max_seq, kv_quant=mode, device="cuda"))
        for mode in ("none", "int8")}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(attention, norms)
    served = serve_phase(cfg, session, seed, bodies, kv_quant="int8")
    launches = _launches(attention, norms)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches["rms_norm"] <= 0:
        raise AssertionError("kernel rms_norm never launched on the int8 "
                             "serving path")
    profile = profile_phase(torch, cfg, session, kv_quant="int8")
    keys = ("tokens_per_s", "ttft_p50_ms", "ttft_p95_ms",
            "inter_token_p50_ms", "inter_token_p95_ms")
    res = {
        "int8": {k: served[k] for k in keys}
        | {"peak_memory_gb": peak,
           "window_device_ms": profile["device_ms"],
           "cache_mb": sizes["int8"] / 1e6},
        "float": {k: float_serve[k] for k in keys}
        | {"peak_memory_gb": float_serve["peak_memory_gb"],
           "window_device_ms": float_profile["device_ms"],
           "cache_mb": sizes["none"] / 1e6},
        "cache_ratio": sizes["int8"] / sizes["none"],
        "launches": launches,
    }
    log("int8 serve: " + json.dumps(res))
    res["parity"] = int8_parity(torch, params, seed)
    return res


def _loss_list(torch, losses) -> list[float]:
    return [float(x) for x in torch.stack(losses).cpu()]


def train_phase(torch, attention, norms, seed: int) -> dict:
    """make_train_step on the bench_transformer configuration, one fixed
    batch of synthetic tokens [8, 2049] from ``seed`` (2048 positions per
    row). Step time is the median over TRAIN_STEPS steps after
    TRAIN_WARMUP warm-ups, between CUDA events recorded at the step
    boundaries (no host sync inside the loop); then one profiled step,
    its device ms split into B1-B4 and the rest. The launch counters are
    set to 0 just before and read just after."""
    from tony_tpu_torch.models import TransformerConfig, make_train_step
    from tony_tpu_torch.models.train import leaves

    cfg = TransformerConfig(dtype="bfloat16", **BENCH_TRANSFORMER)
    init_fn, step_fn = make_train_step(cfg, device="cuda")
    state = init_fn(seed)
    n_params = sum(p.numel() for p in leaves(state.params))
    rng = np.random.default_rng(seed + 3)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)),
        device="cuda")
    norms.launches = 0
    attention.launches = attention.launches_dq = attention.launches_dkv = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, metrics = step_fn(state, tokens)
        losses.append(metrics["loss"])
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TRAIN_STEPS + 1)]
    marks[0].record()
    for i in range(TRAIN_STEPS):
        state, metrics = step_fn(state, tokens)
        losses.append(metrics["loss"])
        marks[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    peak = torch.cuda.max_memory_allocated()

    def one_step():
        nonlocal state
        state, metrics = step_fn(state, tokens)
        losses.append(metrics["loss"])

    events, wall_ms = device_events(torch, one_step)
    n_steps = len(losses)  # one loss a step, a profiling retry's included
    launches = {"rms_norm": norms.launches, "flash_fwd": attention.launches,
                "flash_bwd_dq": attention.launches_dq,
                "flash_bwd_dkv": attention.launches_dkv}
    loss_values = _loss_list(torch, losses)
    if not all(np.isfinite(loss_values)):
        raise AssertionError(f"train: non-finite loss {loss_values}")
    if not loss_values[-1] < loss_values[0]:
        raise AssertionError(f"train: loss did not descend {loss_values}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched in the "
                                 f"train phase")
    median_ms = float(np.median(step_ms))
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    # bench.py's model FLOPs: 6 N T plus the causal attention term.
    flops = (6.0 * n_params * tokens_per_step
             + 6.0 * cfg.n_layers * TRAIN_BATCH * TRAIN_SEQ * TRAIN_SEQ
             * cfg.n_heads * cfg.head_dim)
    by_name: dict[str, list[float]] = {}
    by_part: dict[str, float] = {}
    for name, us in events:
        by_name.setdefault(name, []).append(us)
        part = next((c for pat, c in _KERNEL_CATEGORIES if pat in name),
                    "rest")
        by_part[part] = by_part.get(part, 0.0) + us / 1e3
    rows = sorted(((sum(v), k, len(v)) for k, v in by_name.items()),
                  reverse=True)
    device_total = sum(us for _, us in events) / 1e3
    res = {
        "params_m": n_params / 1e6, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "step_ms_median": median_ms, "step_ms": step_ms,
        "tokens_per_s": tokens_per_step / (median_ms / 1e3),
        "model_flops_per_step": flops,
        "mfu": flops / (median_ms / 1e3) / PEAK_FLOPS["torch.bfloat16"],
        "peak_memory_gb": peak / 1e9,
        "losses": loss_values,
        "launches": launches,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "profiled_step": {
            "wall_ms": wall_ms, "device_ms": device_total,
            "device_busy_share": device_total / wall_ms,
            "by_part_ms": by_part,
            "top": [{"kernel": k[:90], "device_ms": us / 1e3, "count": c}
                    for us, k, c in rows[:12]],
        },
    }
    log("train: " + json.dumps(res))
    return res, (cfg, init_fn, step_fn, state, tokens)


def parity_params(torch, cfg, seed: int, skew: float = 0.0) -> dict:
    """fp32 weights on the CPU from ``seed``; with ``skew``, every
    embedding row plus one shared random offset of that scale."""
    from tony_tpu_torch.models import init_params

    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    if skew:
        offset = torch.randn(cfg.d_model,
                             generator=torch.Generator().manual_seed(seed + 1))
        params["embed"] += skew * offset
    return params


def train_parity_phase(torch, seed: int, cfg_kw: dict = PARITY_TRAIN,
                       tag: str = "train parity", skew: float = 0.0) -> dict:
    """fp32, TF32 off: the same weights and batches through make_train_step
    on the card and on the CPU (the plain path, which the CPU tests pin to
    the JAX package), with remat off, "full" and "dots": the losses of
    PARITY_TRAIN_STEPS steps and every gradient leaf of the first step
    agree within the stated tolerances. ``cfg_kw``: the model (the dense
    PARITY_TRAIN, or MOE_PARITY, whose steps must drop tokens);
    ``skew``: see parity_params."""
    from tony_tpu_torch.models import (TransformerConfig, lm_loss,
                                       make_train_step)
    from tony_tpu_torch.models.train import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 4)
    out = {}
    for remat, policy in PARITY_REMAT:
        cfg = TransformerConfig(dtype="float32", remat=remat,
                                remat_policy=policy, **cfg_kw)
        params = parity_params(torch, cfg, seed, skew)
        batches = [torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (PARITY_TRAIN_BATCH, cfg.max_seq + 1)))
            for _ in range(PARITY_TRAIN_STEPS)]
        grads, losses = {}, {}
        for dev in ("cuda", "cpu"):
            init_fn, step_fn = make_train_step(cfg, device=dev)
            state = init_fn(params=params)
            g = torch.autograd.grad(lm_loss(state.params, batches[0], cfg),
                                    leaves(state.params))
            grads[dev] = [x.cpu() for x in g]
            run = []
            for toks in batches:
                state, metrics = step_fn(state, toks)
                run.append(metrics["loss"])
                drop = metrics.get("moe_drop_rate")
            losses[dev] = _loss_list(torch, run)
        key = f"remat={remat}/{policy}"
        if cfg.n_experts and not float(drop) > 0:
            raise AssertionError(f"{tag} {key}: no token dropped")
        if not np.allclose(losses["cuda"], losses["cpu"], rtol=TRAIN_LOSS_RTOL,
                           atol=0):
            raise AssertionError(f"{tag} {key}: losses card "
                                 f"{losses['cuda']} vs cpu {losses['cpu']}")
        worst = 0.0
        for i, (a, b) in enumerate(zip(grads["cuda"], grads["cpu"])):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            if not err <= TRAIN_GRAD_TOL * scale:
                raise AssertionError(f"{tag} {key}: gradient leaf {i} "
                                     f"err {err} > {TRAIN_GRAD_TOL} * {scale}")
            worst = max(worst, err / scale if scale else err)
        out[key] = {"losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
                    "worst_grad_rel_err": worst}
        log(f"{tag} fp32 {key}: losses card {losses['cuda']} / cpu "
            f"{losses['cpu']}, worst gradient err {worst:.3g} of the leaf "
            f"max: ok")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the data-parallel train step on a one-rank NCCL mesh
# ---------------------------------------------------------------------------

def timed_steps(torch, step_fn, state, tokens) -> tuple:
    """TRAIN_WARMUP warm-ups, then TRAIN_STEPS steps between CUDA events at
    the step boundaries (no host sync inside): (state, step ms, peak bytes
    allocated since the warm-ups began, and of those above what was
    allocated when they began: the step's own working set)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    for _ in range(TRAIN_WARMUP):
        state, _ = step_fn(state, tokens)
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TRAIN_STEPS + 1)]
    marks[0].record()
    for i in range(TRAIN_STEPS):
        state, _ = step_fn(state, tokens)
        marks[i + 1].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return (state, [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
            peak, peak - resident)


def check_world1_collectives(torch, mesh) -> None:
    """The port's collectives on CUDA tensors over the one-rank NCCL mesh:
    with one rank each returns its input (the reduce-scatter and the
    gradient mean sum one value, the gathers and the all-to-all keep one
    block), and the gather's backward hands back the cotangent."""
    from tony_tpu_torch.parallel import collectives as coll

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    x = torch.randn(4, 6, 8, device="cuda", generator=gen)
    outs = {
        "all_gather_tp": coll.all_gather_tp(x, 1, "dp", mesh=mesh),
        "reduce_scatter_tp": coll.reduce_scatter_tp(x, 2, "dp", mesh=mesh),
        "all_to_all_ep": coll.all_to_all_ep(x, 0, 1, "ep", mesh=mesh),
        "pmean_gradients": coll.pmean_gradients([x.clone()], mesh)[0],
    }
    outs["ppermute"] = coll.ppermute((x,), "sp", mesh=mesh)[0]
    prev, nxt = coll.ring_halo_exchange(x, "sp", 2, axis=1, mesh=mesh)
    outs["ring_halo_exchange"] = torch.cat([nxt, x[:, 2:-2], prev], dim=1)
    leaf = x.clone().requires_grad_()
    full = coll.all_gather_with_scatter_grad(leaf, 1, "dp", mesh=mesh)
    full.backward(2 * x)
    outs["gather backward"] = leaf.grad / 2
    for name, got in outs.items():
        if not torch.equal(got, x):
            raise AssertionError(f"dp: {name} over one NCCL rank changed "
                                 f"its input")


def dp_phase(torch, attention, norms, seed: int) -> dict:
    """Slice 3's path on one card: a one-rank NCCL group on a HashStore
    (no TCP rendezvous), ``runtime.build_job_mesh()`` and
    ``make_train_step(cfg, mesh)`` at bench_transformer's width. From the
    init and batch of the train phase, DP_PARITY_STEPS steps of the mesh
    path must equal the mesh=None path bit for bit (losses and every
    parameter). Then the step median of each, timed mesh=None, mesh,
    mesh=None. The launch counters are set to 0 just before the mesh path
    and read just after."""
    from datetime import timedelta

    import torch.distributed as dist

    import tony_tpu_torch.runtime as rt
    from tony_tpu_torch.models import TransformerConfig, make_train_step
    from tony_tpu_torch.models.train import leaves

    cfg = TransformerConfig(dtype="bfloat16", **BENCH_TRANSFORMER)
    rng = np.random.default_rng(seed + 3)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)),
        device="cuda")
    init_fn, step_fn = make_train_step(cfg, device="cuda")
    plain = init_fn(seed)
    plain_losses = []
    for _ in range(DP_PARITY_STEPS):
        plain, metrics = step_fn(plain, tokens)
        plain_losses.append(metrics["loss"])
    # Copies: the timed steps below update the state in place.
    plain_bits = {k: v.clone() for k, v in state_bits(torch, plain).items()}
    plain, before_ms, _, plain_ws = timed_steps(torch, step_fn, plain,
                                                tokens)

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=timedelta(seconds=DP_TIMEOUT_S))
    try:
        mesh = rt.build_job_mesh(device="cuda", timeout_s=DP_TIMEOUT_S)
        check_world1_collectives(torch, mesh)
        mesh_s = time.perf_counter() - t0
        d_init, d_step = make_train_step(cfg, mesh, device="cuda")
        norms.launches = 0
        attention.launches = attention.launches_dq = 0
        attention.launches_dkv = 0
        state = d_init(seed)
        losses = []
        for _ in range(DP_PARITY_STEPS):
            state, metrics = d_step(state, tokens)
            losses.append(metrics["loss"])
        losses, plain_losses = (_loss_list(torch, x)
                                for x in (losses, plain_losses))
        if losses != plain_losses:
            raise AssertionError(f"dp: losses {losses} != mesh=None "
                                 f"{plain_losses}")
        bits = state_bits(torch, state)
        if set(bits) != set(plain_bits):
            raise AssertionError("dp: the states hold other leaves")
        unequal = [p for p in bits
                   if not torch.equal(bits[p], plain_bits[p])]
        if unequal:
            raise AssertionError(f"dp: {len(unequal)} of {len(bits)} "
                                 f"leaves differ from mesh=None: "
                                 f"{unequal[:6]}")
        n_leaves = len(bits)
        del bits, plain_bits
        state, mesh_ms, mesh_peak, mesh_ws = timed_steps(torch, d_step,
                                                         state, tokens)
        launches = {"rms_norm": norms.launches,
                    "flash_fwd": attention.launches,
                    "flash_bwd_dq": attention.launches_dq,
                    "flash_bwd_dkv": attention.launches_dkv}
    finally:
        dist.destroy_process_group()
    plain, after_ms, _, _ = timed_steps(torch, step_fn, plain, tokens)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the dp "
                                 f"path")
    n_params = sum(p.numel() for p in leaves(state.params))
    res = {
        "params_m": n_params / 1e6, "world": 1, "backend": "nccl",
        "mesh_setup_s": mesh_s, "parity_steps": DP_PARITY_STEPS,
        "losses": losses, "leaves_equal": n_leaves,
        "step_ms_median": float(np.median(mesh_ms)), "step_ms": mesh_ms,
        "plain_step_ms_median_before": float(np.median(before_ms)),
        "plain_step_ms_median_after": float(np.median(after_ms)),
        "plain_step_ms": before_ms + after_ms,
        # Both states are resident during the mesh steps: the working set
        # (peak above what was allocated when the timing began) compares
        # the two steps.
        "peak_memory_gb": mesh_peak / 1e9,
        "working_set_gb": mesh_ws / 1e9,
        "plain_working_set_gb": plain_ws / 1e9,
        "launches": launches,
    }
    log("dp: " + json.dumps(res))
    log(f"dp: mesh step median {res['step_ms_median']:.3f} ms beside "
        f"mesh=None {res['plain_step_ms_median_before']:.3f} / "
        f"{res['plain_step_ms_median_after']:.3f} ms (before / after), on "
        f"{card_line()}")
    return res


# ---------------------------------------------------------------------------
# Phase 9b: the tensor-parallel path on a one-rank NCCL mesh
# ---------------------------------------------------------------------------

def _tp_parity_run(torch, cfg, params, batches, mesh, **trunk) -> tuple:
    """PARITY_TRAIN_STEPS steps of make_train_step(cfg, mesh, **trunk) on
    the card from ``params``: (losses, the first step's clipped
    gradients)."""
    from tony_tpu_torch.models import make_train_step
    from tony_tpu_torch.models.train import leaves

    init_fn, step_fn = make_train_step(cfg, mesh, device="cuda", **trunk)
    state = init_fn(params=params)
    losses, grads = [], None
    for toks in batches:
        state, metrics = step_fn(state, toks)
        losses.append(metrics["loss"])
        if grads is None:
            grads = [p.grad.detach().cpu() for p in leaves(state.params)]
    return _loss_list(torch, losses), grads


def _parity_references(torch, rng, seed: int) -> dict:
    """The mesh=None runs of ``_tp_parity_run`` in fp32 at PARITY_TRAIN's
    widths and each remat setting, weights from ``seed``, batches from
    ``rng``: {setting: (cfg, batches, (losses, first-step gradients))}."""
    from tony_tpu_torch.models import TransformerConfig

    refs = {}
    for remat, policy in PARITY_REMAT:
        pcfg = TransformerConfig(dtype="float32", remat=remat,
                                 remat_policy=policy, **PARITY_TRAIN)
        batches = [torch.as_tensor(rng.integers(
            0, pcfg.vocab_size, (PARITY_TRAIN_BATCH, pcfg.max_seq + 1)),
            device="cuda") for _ in range(PARITY_TRAIN_STEPS)]
        refs[f"remat={remat}/{policy}"] = (
            pcfg, batches, _tp_parity_run(torch, pcfg, parity_params(
                torch, pcfg, seed), batches, None))
    return refs


def _check_mesh_parity(torch, tag: str, refs: dict, mesh, seed: int,
                       skew: float = 0.0, **trunk) -> dict:
    """The runs of ``refs`` (``_parity_references``; weights from
    ``parity_params`` with ``skew``) again over ``mesh`` (make_train_step's
    ``trunk`` arguments): the losses within
    TRAIN_LOSS_RTOL and every first-step gradient within TRAIN_GRAD_TOL of
    its leaf's largest. Returns {setting: {"losses", "worst_grad_rel_err",
    "bit_equal"}}."""
    checked = {}
    for key, (pcfg, batches, (want_losses, want_grads)) in refs.items():
        losses, grads = _tp_parity_run(torch, pcfg, parity_params(
            torch, pcfg, seed, skew), batches, mesh, **trunk)
        if not np.allclose(losses, want_losses, rtol=TRAIN_LOSS_RTOL,
                           atol=0):
            raise AssertionError(f"{tag} {key}: losses {losses} vs "
                                 f"mesh=None {want_losses}")
        worst = 0.0
        for i, (a, b) in enumerate(zip(grads, want_grads)):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            if not err <= TRAIN_GRAD_TOL * scale:
                raise AssertionError(f"{tag} {key}: gradient leaf {i} err "
                                     f"{err} > {TRAIN_GRAD_TOL} * {scale}")
            worst = max(worst, err / scale if scale else err)
        checked[key] = {"losses": losses, "worst_grad_rel_err": worst,
                        "bit_equal": losses == want_losses and all(
                            torch.equal(a, b)
                            for a, b in zip(grads, want_grads))}
    return checked


def tp_phase(torch, attention, norms, seed: int) -> dict:
    """Slice 4's tp path on one card: ``MeshSpec(tp=1)`` over a one-rank
    NCCL group on a HashStore. The conjugate pair (``copy_to_tp`` /
    ``reduce_from_tp``) runs as the identity it is at tp = 1, the
    vocab-parallel cross-entropy's max and sum as one-rank all_reduces,
    and the per-part decode split cuts whole blocks. Held against
    mesh=None: fp32 (TF32 off) at PARITY_TRAIN's widths and each remat
    setting, the losses of PARITY_TRAIN_STEPS steps within TRAIN_LOSS_RTOL
    and every first-step gradient within TRAIN_GRAD_TOL of its leaf's
    largest; DecodeSession(mesh=) on the flagship serving model in fp32
    (TP_DECODE) gives the greedy tokens of the session without a mesh.
    Then bench_transformer's bf16 step over the mesh, its median beside
    mesh=None's (timed before and after), and the all_reduce calls and
    bytes one step sends over the tp group. The launch counters are set to
    0 just before the mesh path and read just after."""
    from datetime import timedelta

    import torch.distributed as dist

    from tony_tpu_torch.models import (DecodeSession, TransformerConfig,
                                       init_params, make_train_step)
    from tony_tpu_torch.parallel import MeshSpec, build_mesh
    from tony_tpu_torch.parallel.collectives import axis_group

    rng = np.random.default_rng(seed + 8)
    parity = _parity_references(torch, rng, seed)
    dcfg = TransformerConfig(dtype="float32", **FLAGSHIP)
    dgen = torch.Generator(device="cuda")
    dgen.manual_seed(seed + 9)
    dparams = init_params(dcfg, dgen, device="cuda")
    prompt = torch.as_tensor(rng.integers(
        0, dcfg.vocab_size, (TP_DECODE["batch"], TP_DECODE["prompt"])),
        device="cuda")
    want_tokens = DecodeSession(dparams, dcfg, device="cuda").generate(
        prompt, TP_DECODE["new"])

    cfg = TransformerConfig(dtype="bfloat16", **BENCH_TRANSFORMER)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)),
        device="cuda")
    init_fn, step_fn = make_train_step(cfg, device="cuda")
    plain, before_ms, _, _ = timed_steps(torch, step_fn, init_fn(seed),
                                         tokens)
    del plain
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=timedelta(seconds=DP_TIMEOUT_S))
    real = dist.all_reduce
    try:
        mesh = build_mesh(MeshSpec(tp=1), "cuda", timeout_s=DP_TIMEOUT_S)
        tp_group = axis_group(mesh, "tp")[0]
        _reset_launches(attention, norms)
        m_init, m_step = make_train_step(cfg, mesh, device="cuda")
        state = m_init(seed)
        state, mesh_ms, mesh_peak, mesh_ws = timed_steps(torch, m_step,
                                                         state, tokens)
        sent = {"calls": 0, "bytes": 0}

        def counted(tensor, *args, **kwargs):
            if kwargs.get("group") is tp_group:
                sent["calls"] += 1
                sent["bytes"] += tensor.numel() * tensor.element_size()
            return real(tensor, *args, **kwargs)

        dist.all_reduce = counted
        state, _ = m_step(state, tokens)
        dist.all_reduce = real
        torch.cuda.synchronize()
        del state
        checked = _check_mesh_parity(torch, "tp", parity, mesh, seed)
        session = DecodeSession(dparams, dcfg, device="cuda", mesh=mesh)
        tokens_out = session.generate(prompt, TP_DECODE["new"])
        torch.cuda.synchronize()
        launches = _launches(attention, norms)
    finally:
        dist.all_reduce = real
        dist.destroy_process_group()
    if not torch.equal(tokens_out, want_tokens):
        raise AssertionError("tp: DecodeSession(mesh=) greedy tokens differ "
                             "from the session without a mesh")
    plain, after_ms, _, _ = timed_steps(torch, step_fn, init_fn(seed),
                                        tokens)
    del plain, session, dparams
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the tp "
                                 f"path")
    res = {
        "mesh": [1, 1, 1, 1, 1], "backend": "nccl", "parity": checked,
        "decode_tokens_equal": list(tokens_out.shape),
        "step_ms_median": float(np.median(mesh_ms)), "step_ms": mesh_ms,
        "plain_step_ms_median_before": float(np.median(before_ms)),
        "plain_step_ms_median_after": float(np.median(after_ms)),
        "peak_memory_gb": mesh_peak / 1e9,
        "working_set_gb": mesh_ws / 1e9,
        "tp_all_reduce_per_step": sent,
        "launches": launches,
    }
    log("tp: " + json.dumps(res))
    log(f"tp: mesh step median {res['step_ms_median']:.3f} ms beside "
        f"mesh=None {res['plain_step_ms_median_before']:.3f} / "
        f"{res['plain_step_ms_median_after']:.3f} ms (before / after); "
        f"{sent['calls']} all_reduces over tp a step, "
        f"{sent['bytes'] / 1e6:.1f} MB, on {card_line()}")
    return res


# ---------------------------------------------------------------------------
# Phase 9c: sequence parallelism: the ring in one process, the sp trunk
# ---------------------------------------------------------------------------

def _attention_grads(torch, fn, q, k, v, do) -> tuple:
    """(out, dq, dk, dv) of ``fn(q, k, v)`` for the output cotangent
    ``do``."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(do)
    torch.cuda.synchronize()
    return out.detach(), q.grad, k.grad, v.grad


@contextlib.contextmanager
def _held_to_plain(torch, attention, tag: str, worst: dict):
    """Inside, every B1 launch and every B2/B3 launch is held against its
    plain version on the same inputs, at the shapes and masks its caller
    gives it (for the ring: the diagonal block causal, each past block
    unmasked, and in the backward the lse cotangent of the merge), as the
    kernels phase holds them, row by row (``_check_fwd``, ``_check_bwd``).
    The plain calls launch no kernel, so no launch is added to the counts.
    ``worst`` gathers the largest errors and the number of launches held."""
    fwd, bwd = attention._flash_attention_cuda, attention._flash_bwd_cuda

    def note(key, value):
        worst[key] = max(worst.get(key, 0.0), value)

    def count(key):
        worst[key] = worst.get(key, 0) + 1

    def held_fwd(q, k, v, *, causal, scale, block_q=None):
        got = fwd(q, k, v, causal=causal, scale=scale, block_q=block_q)
        want = attention._flash_plain_bthd(q, k, v, causal=causal,
                                           scale=scale)
        errs = fwd_errors(got, want)
        _check_fwd(f"{tag} B1 tq={q.shape[1]} tk={k.shape[1]} "
                   f"causal={causal}", got, want, q.dtype, rows=True,
                   quiet=True)
        count("b1_launches")
        note("b1_row_err", errs["row_err"])
        note("b1_lse_err", errs["lse_err"])
        return got

    def held_bwd(q, k, v, out, lse, do, *, causal, scale, g_lse=None,
                 block_q=None, block_k=None):
        got = bwd(q, k, v, out, lse, do, causal=causal, scale=scale,
                  g_lse=g_lse, block_q=block_q, block_k=block_k)
        want = attention._flash_bwd_plain(q, k, v, out, lse, do,
                                          causal=causal, scale=scale,
                                          g_lse=g_lse)
        errs = bwd_errors(torch, got, want)
        _check_bwd(torch, f"{tag} B2/B3 tq={q.shape[1]} tk={k.shape[1]} "
                   f"causal={causal} g_lse={g_lse is not None}", got, want,
                   q.dtype, rows=True, quiet=True)
        count("b2_b3_launches")
        if g_lse is not None:
            count("b2_b3_with_g_lse")
        note("b2_row_err", errs["dq"]["row_err"])
        note("b3_row_err", max(errs["dk"]["row_err"], errs["dv"]["row_err"]))
        return got

    attention._flash_attention_cuda = held_fwd
    attention._flash_bwd_cuda = held_bwd
    try:
        yield
    finally:
        attention._flash_attention_cuda = fwd
        attention._flash_bwd_cuda = bwd


def _whole_sequence(torch, attention, tag: str, q, k, v, do) -> tuple:
    """B1-B3 over the whole sequence, each held against its plain version
    on the same inputs (``_held_to_plain``), and the plain reference for
    the ring: (kernels' (out, dq, dk, dv), plain (out, dq, dk, dv), their
    worst errors). The plain out is ``_flash_plain_bthd``'s; the plain
    gradients are ``_flash_bwd_plain``'s from B1's out and lse, the inputs
    B2/B3 take. A whole chain's bf16 gradients (each from its own
    bf16-rounded out) differ from one another at the first rows by more
    than ROW_TOL, plain and kernels alike (``attention_chain_study.py``
    measures it), so each kernel is held on its own inputs."""
    worst = {}
    with _held_to_plain(torch, attention, f"sp whole {tag}", worst):
        kernels = _attention_grads(torch, lambda q, k, v: (
            attention.flash_attention(q, k, v, causal=True)), q, k, v, do)
    scale = q.shape[-1] ** -0.5
    out, lse = attention._flash_attention_cuda(q, k, v, causal=True,
                                               scale=scale)
    plain_out, _ = attention._flash_plain_bthd(q, k, v, causal=True,
                                               scale=scale)
    plain = (plain_out, *attention._flash_bwd_plain(
        q, k, v, out, lse, do, causal=True, scale=scale))
    torch.cuda.synchronize()
    log(f"sp whole-sequence B1-B3 {tag} against the plain versions: "
        f"{json.dumps(worst)}: ok")
    return kernels, plain, worst


def _check_ring(torch, tag: str, got: tuple, want: tuple, dtype) -> dict:
    """The ring's (out, dq, dk, dv) against ``want``: bf16 out within
    TOL and row by row within ROW_TOL, the gradients as the kernels phase
    holds B2/B3 (``_check_bwd`` with rows); fp32 every one within
    SP_FP32_TOL of max(1, its largest |value|)."""
    out_diff = (got[0].float() - want[0].float()).flatten(0, -2)
    errs = {"out": {"max_abs_err": out_diff.abs().max().item(),
                    "row_err": row_error(out_diff,
                                         want[0].float().flatten(0, -2))}}
    if dtype == torch.float32:
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            err = (a - b).abs().max().item()
            largest = b.abs().max().item()
            limit = SP_FP32_TOL * max(1.0, largest)
            errs[name] = {"max_abs_err": err, "max_want": largest}
            if not err <= limit:
                raise AssertionError(f"sp ring {tag}: {name} err {err} > "
                                     f"{limit}")
    else:
        e = errs["out"]
        if not (e["max_abs_err"] <= TOL[("flash_fwd", str(dtype))]
                and e["row_err"] <= ROW_TOL):
            raise AssertionError(f"sp ring {tag}: out {json.dumps(e)} (tol "
                                 f"{TOL[('flash_fwd', str(dtype))]}, row "
                                 f"tol {ROW_TOL})")
        dq_err, dkv_err = _check_bwd(torch, f"sp ring {tag}", got[1:],
                                     want[1:], dtype, rows=True)
        errs.update(dq={"max_abs_err": dq_err},
                    dkv={"max_abs_err": dkv_err})
    log(f"sp ring {tag}: {json.dumps(errs)}: ok")
    return errs


def sp_phase(torch, attention, norms, seed: int) -> dict:
    """Sequence parallelism on one card, in two parts.

    The ring: ``ring_attention_in_process`` runs the port's ring body for
    every rank of a ring of SP_RINGS ranks, one after another, each
    rotation handing out the next owner's slice of whole-sequence K/V.
    At transformer_16k_hd128's attention shape (SP_ATTN, bf16, causal),
    MHA and GQA 8/2 (SP_KV_HEADS), every B1 and B2/B3 launch of the ring is
    held against its plain version on the same inputs (``_held_to_plain``);
    the ring's output and dq, dk, dv are held against the plain versions
    over the whole sequence and against B1-B3 over the whole sequence,
    whose launches are held against the plain versions first
    (``_whole_sequence``, ``_check_ring``); and all of it again in fp32 at
    SP_FP32_ATTN within SP_FP32_TOL. Rank i of a causal ring launches B1
    1 + i times (its diagonal block and the past blocks), the ring
    n(n+1)/2 times, and B2/B3 as often in the backward.

    The trunk: ``MeshSpec(sp=1)`` on a one-rank NCCL group (the ring is
    its step 0, the flash call): fp32 losses and first-step gradients at
    PARITY_TRAIN's widths and each remat setting against mesh=None, and
    bench_transformer's bf16 step over the mesh beside mesh=None's, timed
    before and after. At sp=1 the trunk's attention is the flash call and
    ``ppermute`` the identity, so this phase does not run the sp > 1 trunk
    (``ring_attention`` over NCCL, the loss's sequence slice, the RoPE
    offset): ``dp_study.py --sp`` on several cards is its witness on the
    card.

    The references (the plain versions, the whole-sequence kernels,
    mesh=None) run outside the counted window; the launch counters are set
    to 0 just before the ring runs and read just after the mesh steps."""
    from datetime import timedelta

    import torch.distributed as dist

    from tony_tpu_torch.models import TransformerConfig, make_train_step
    from tony_tpu_torch.parallel import MeshSpec, build_mesh, ring

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 11)
    cases, whole_errs = [], {}
    for dtype, shape in ((torch.bfloat16, SP_ATTN),
                         (torch.float32, SP_FP32_ATTN)):
        for h_kv in SP_KV_HEADS:
            b, t, h, d = (shape[n] for n in "bthd")
            q, do = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn(b, t, h_kv, d, generator=gen, device="cuda")
                    .to(dtype) for _ in range(2))
            tag = f"[{b}, {t}, {h}/{h_kv}, {d}] {dtype}"
            whole, plain, whole_errs[tag] = _whole_sequence(
                torch, attention, tag, q, k, v, do)
            cases.append((tag, (q, k, v, do), plain, whole))
    rng = np.random.default_rng(seed + 12)
    parity = _parity_references(torch, rng, seed)
    cfg = TransformerConfig(dtype="bfloat16", **BENCH_TRANSFORMER)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)),
        device="cuda")
    init_fn, step_fn = make_train_step(cfg, device="cuda")
    plain, before_ms, _, _ = timed_steps(torch, step_fn, init_fn(seed),
                                         tokens)
    del plain

    _reset_launches(attention, norms)
    ring_errs, by_rank = {}, {}
    for tag, inputs, plain, whole in cases:
        for sp in SP_RINGS:
            fwd, dq = attention.launches, attention.launches_dq
            held = {}
            with _held_to_plain(torch, attention, f"sp ring {tag} sp {sp}",
                                held):
                got = _attention_grads(torch, lambda q, k, v: (
                    ring.ring_attention_in_process(q, k, v, sp,
                                                   causal=True)), *inputs)
            log(f"sp ring {tag} sp {sp}: each launch against its plain "
                f"version: {json.dumps(held)}: ok")
            n_chunks = sp * (sp + 1) // 2
            if (attention.launches - fwd, attention.launches_dq - dq) != (
                    n_chunks, n_chunks):
                raise AssertionError(
                    f"sp ring {tag} sp {sp}: B1/B2 launched "
                    f"{attention.launches - fwd}/"
                    f"{attention.launches_dq - dq} times, not {n_chunks}")
            ring_errs[f"{tag} sp {sp}"] = {
                "launches_vs_plain": held,
                "vs_plain": _check_ring(torch, f"{tag} sp {sp} vs plain",
                                        got, plain, inputs[0].dtype),
                "vs_whole_kernels": _check_ring(
                    torch, f"{tag} sp {sp} vs whole-sequence B1-B3", got,
                    whole, inputs[0].dtype)}
            del got
    q, k, v, _ = cases[0][1]
    t_k = k.shape[1]
    for sp in SP_RINGS:
        by_rank[sp] = []
        with torch.no_grad():
            for idx in range(sp):
                own = slice(idx * t_k // sp, (idx + 1) * t_k // sp)
                before = attention.launches
                ring.ring_body(q[:, own], k[:, own], v[:, own],
                               ring._slice_rotation(k, v, sp, idx),
                               axis_size=sp, axis_index=idx, causal=True,
                               scale=q.shape[-1] ** -0.5)
                by_rank[sp].append(attention.launches - before)
        if by_rank[sp] != [1 + i for i in range(sp)]:
            raise AssertionError(f"sp ring sp {sp}: B1 launches by rank "
                                 f"{by_rank[sp]}, not 1 + the rank")
    del cases, q, k, v

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=timedelta(seconds=DP_TIMEOUT_S))
    try:
        mesh = build_mesh(MeshSpec(sp=1), "cuda", timeout_s=DP_TIMEOUT_S)
        m_init, m_step = make_train_step(cfg, mesh, device="cuda")
        state, mesh_ms, mesh_peak, _ = timed_steps(torch, m_step,
                                                   m_init(seed), tokens)
        del state
        checked = _check_mesh_parity(torch, "sp", parity, mesh, seed)
        torch.cuda.synchronize()
        launches = _launches(attention, norms)
    finally:
        dist.destroy_process_group()
    plain, after_ms, _, _ = timed_steps(torch, step_fn, init_fn(seed),
                                        tokens)
    del plain
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the sp "
                                 f"path")
    res = {
        "ring": ring_errs, "whole_sequence_kernels": whole_errs,
        "ring_b1_launches_by_rank": by_rank,
        "mesh": [1, 1, 1, 1, 1], "backend": "nccl", "parity": checked,
        "step_ms_median": float(np.median(mesh_ms)), "step_ms": mesh_ms,
        "plain_step_ms_median_before": float(np.median(before_ms)),
        "plain_step_ms_median_after": float(np.median(after_ms)),
        "peak_memory_gb": mesh_peak / 1e9,
        "launches": launches,
        "phase_wall_s": time.perf_counter() - t_phase,
    }
    log("sp: " + json.dumps(res))
    log(f"sp: mesh step median {res['step_ms_median']:.3f} ms beside "
        f"mesh=None {res['plain_step_ms_median_before']:.3f} / "
        f"{res['plain_step_ms_median_after']:.3f} ms (before / after), on "
        f"{card_line()}")
    return res


# ---------------------------------------------------------------------------
# Phase 9d: pipeline parallelism: the schedules in one process, the pp trunk
# ---------------------------------------------------------------------------

def _trunk_grads(torch, cfg, params: dict, tokens, **pipe) -> tuple:
    """(loss, every leaf's gradient in ``leaves`` order) of lm_loss
    without a mesh on fresh trainable copies of ``params``; with ``pipe``
    (lm_loss's pipeline arguments and ``pipeline_stages``) through the
    pipeline run in this process."""
    from tony_tpu_torch.models import lm_loss
    from tony_tpu_torch.models.train import leaves

    def trainable(tree):
        return {k: (trainable(v) if isinstance(v, dict) else
                    v.detach().to("cuda", copy=True).requires_grad_())
                for k, v in tree.items()}

    params = trainable(params)
    loss = lm_loss(params, tokens, cfg, None, **pipe)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), [p.grad for p in leaves(params)]


def _compare_grads(tag: str, loss: float, grads: list, want: tuple,
                   loss_rtol: float, grad_tol: float) -> dict:
    """``loss`` within ``loss_rtol`` of ``want``'s and every leaf of
    ``grads`` within ``grad_tol`` of its leaf's largest |value|."""
    want_loss, want_grads = want
    loss_err = abs(loss - want_loss) / abs(want_loss)
    worst = 0.0
    for i, (a, b) in enumerate(zip(grads, want_grads)):
        scale = b.abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        if not err <= grad_tol * scale:
            raise AssertionError(f"pp {tag}: gradient leaf {i} err {err} > "
                                 f"{grad_tol} * {scale}")
        worst = max(worst, err / scale if scale else err)
    if not loss_err <= loss_rtol:
        raise AssertionError(f"pp {tag}: loss {loss} vs mesh=None "
                             f"{want_loss} (rtol {loss_rtol})")
    out = {"loss": loss, "want_loss": want_loss, "loss_rel_err": loss_err,
           "worst_grad_rel_err": worst}
    log(f"pp {tag}: {json.dumps(out)}: ok")
    return out


def pp_phase(torch, attention, norms, seed: int) -> dict:
    """Pipeline parallelism on one card, in two parts.

    The schedules: ``forward_pipeline`` with every stage run in this
    process (``pipeline_apply_in_process``: each tick runs every stage,
    then hands stage s's output to stage s + 1 by a list shift) drives
    bench_transformer's full-width trunk over PP_MICROBATCHES microbatches
    of [8, 2049] under each of PP_SCHEDULES (pp 2 and 4 GPipe, pp 4
    interleaved with 2 virtual stages): the loss and every gradient leaf
    against the mesh=None step's on the same batch and weights in bf16
    (PP_BF16_LOSS_RTOL, PP_BF16_GRAD_TOL), and every B1 and B2/B3 launch
    inside the schedule held against its plain version on the same inputs
    (``_held_to_plain``); B1, B2 and B3 launch once a layer a computed
    tick of every stage (the backward runs every tick, as across ranks).
    Then in fp32 (TF32 off) at PARITY_TRAIN's widths and 8 layers over 8
    rows: within TRAIN_LOSS_RTOL and TRAIN_GRAD_TOL of mesh=None.

    The trunk: ``MeshSpec(pp=1)`` on a one-rank NCCL group runs
    ``make_train_step(..., pipeline_microbatches=...)`` through
    ``pipeline_apply``'s own code (``ppermute`` and the masked sum over pp
    the identity at pp = 1, ``select`` picking the injected microbatch):
    fp32 parity against mesh=None at each remat setting, and
    bench_transformer's bf16 step over PP_MICROBATCHES microbatches beside
    mesh=None's, timed before and after. pp above 1 over NCCL (the sends
    between ranks, the masked sum, the chunk exchange) runs only in
    ``dp_study.py --pp`` on several cards.

    The references (mesh=None, the plain versions) run outside the counted
    window; the launch counters are set to 0 just before the schedules
    run and read just after the mesh steps."""
    from datetime import timedelta

    import torch.distributed as dist

    from tony_tpu_torch.models import (TransformerConfig, init_params,
                                       make_train_step)
    from tony_tpu_torch.parallel import MeshSpec, build_mesh, schedule_info

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 13)
    cfg = TransformerConfig(dtype="bfloat16", **BENCH_TRANSFORMER)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 13)
    params = init_params(cfg, gen, device="cuda")
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)),
        device="cuda")
    want = _trunk_grads(torch, cfg, params, tokens)
    # Train parity's widths at the full trunk's depth, which pp x virtual
    # stages divide.
    pcfg = TransformerConfig(dtype="float32", remat=False,
                             **dict(PARITY_TRAIN, n_layers=cfg.n_layers))
    pparams = parity_params(torch, pcfg, seed)
    ptokens = torch.as_tensor(rng.integers(
        0, pcfg.vocab_size, (PP_MICROBATCHES, pcfg.max_seq + 1)),
        device="cuda")
    pwant = _trunk_grads(torch, pcfg, pparams, ptokens)
    parity = _parity_references(torch, rng, seed)
    init_fn, step_fn = make_train_step(cfg, device="cuda")
    plain, before_ms, _, _ = timed_steps(torch, step_fn, init_fn(seed),
                                         tokens)
    del plain

    _reset_launches(attention, norms)
    schedules = {}
    for stages, schedule, virtual in PP_SCHEDULES:
        tag = f"pp {stages} {schedule} v {virtual}"
        pipe = dict(pipeline_microbatches=PP_MICROBATCHES,
                    pipeline_schedule=schedule, pipeline_virtual=virtual,
                    pipeline_stages=stages)
        info = schedule_info(schedule, PP_MICROBATCHES, stages,
                             cfg.n_layers, virtual)
        # Every stage computes every tick but the interleaved schedule's
        # last (a record only), one B1 a layer of the tick.
        computed = info.ticks - (schedule == "interleaved")
        res = {"ticks": info.ticks, "bubble_fraction": info.bubble_fraction}
        for dtype, model, inputs, ref, loss_rtol, grad_tol in (
                ("bf16", cfg, (params, tokens), want, PP_BF16_LOSS_RTOL,
                 PP_BF16_GRAD_TOL),
                ("fp32", pcfg, (pparams, ptokens), pwant, TRAIN_LOSS_RTOL,
                 TRAIN_GRAD_TOL)):
            held = {}
            fwd, dq, dkv = (attention.launches, attention.launches_dq,
                            attention.launches_dkv)
            with _held_to_plain(torch, attention, f"pp {tag} {dtype}", held):
                loss, grads = _trunk_grads(torch, model, *inputs, **pipe)
            n = computed * model.n_layers // virtual
            got = (attention.launches - fwd, attention.launches_dq - dq,
                   attention.launches_dkv - dkv)
            if got != (n, n, n):
                raise AssertionError(f"pp {tag} {dtype}: B1/B2/B3 launched "
                                     f"{got} times, not {n} each")
            log(f"pp {tag} {dtype}: each launch against its plain version: "
                f"{json.dumps(held)}: ok")
            res[dtype] = {"b1_launches": n, "launches_vs_plain": held,
                          "vs_mesh_none": _compare_grads(
                              f"{tag} {dtype}", loss, grads, ref, loss_rtol,
                              grad_tol)}
            del grads
        schedules[tag] = res

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=timedelta(seconds=DP_TIMEOUT_S))
    try:
        mesh = build_mesh(MeshSpec(pp=1), "cuda", timeout_s=DP_TIMEOUT_S)
        m_init, m_step = make_train_step(
            cfg, mesh, device="cuda", pipeline_microbatches=PP_MICROBATCHES)
        state, mesh_ms, mesh_peak, _ = timed_steps(torch, m_step,
                                                   m_init(seed), tokens)
        del state
        checked = _check_mesh_parity(
            torch, "pp", parity, mesh, seed,
            pipeline_microbatches=PARITY_TRAIN_BATCH)
        torch.cuda.synchronize()
        launches = _launches(attention, norms)
    finally:
        dist.destroy_process_group()
    plain, after_ms, _, _ = timed_steps(torch, step_fn, init_fn(seed),
                                        tokens)
    del plain
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the pp "
                                 f"path")
    res = {
        "schedules": schedules,
        "mesh": [1, 1, 1, 1, 1], "backend": "nccl", "parity": checked,
        "step_microbatches": PP_MICROBATCHES,
        "step_ms_median": float(np.median(mesh_ms)), "step_ms": mesh_ms,
        "plain_step_ms_median_before": float(np.median(before_ms)),
        "plain_step_ms_median_after": float(np.median(after_ms)),
        "peak_memory_gb": mesh_peak / 1e9,
        "launches": launches,
        "phase_wall_s": time.perf_counter() - t_phase,
    }
    log("pp: " + json.dumps(res))
    log(f"pp: MeshSpec(pp=1) step over {PP_MICROBATCHES} microbatches, "
        f"median {res['step_ms_median']:.3f} ms beside mesh=None "
        f"{res['plain_step_ms_median_before']:.3f} / "
        f"{res['plain_step_ms_median_after']:.3f} ms (before / after), on "
        f"{card_line()}; pp above 1 over NCCL runs only in dp_study.py "
        f"--pp")
    return res


# ---------------------------------------------------------------------------
# Phase 10: a job that reads its data shard, checkpoints, resumes and serves
# ---------------------------------------------------------------------------

def write_corpus(path: Path, seed: int, n_records: int, seq: int,
                 vocab: int) -> None:
    """n_records uint16 records of seq + 1 tokens from ``seed``: each
    record repeats one of 8 shared 8-token motifs with 15 % noise tokens,
    so every batch teaches the same structure and the loss falls step
    after step."""
    rng = np.random.default_rng(seed)
    motifs = rng.integers(1, vocab, (8, 8))
    reps = -(-(seq + 1) // 8)
    rows = np.tile(motifs[rng.integers(0, 8, n_records)], reps)[:, :seq + 1]
    noise = rng.integers(1, vocab, rows.shape)
    rows = np.where(rng.random(rows.shape) < 0.15, noise, rows)
    rows.astype(np.uint16).tofile(path)


def model_args(cfg: dict, dtype: str) -> list[str]:
    """train.py / serve.py model flags for a config dict (head_dim must be
    d_model // n_heads and d_ff 4 * d_model, as the CLIs derive them)."""
    kv = cfg["n_kv_heads"] or cfg["n_heads"]
    assert cfg["head_dim"] == cfg["d_model"] // cfg["n_heads"]
    assert cfg["d_ff"] == 4 * cfg["d_model"]
    return ["--d-model", str(cfg["d_model"]), "--n-layers",
            str(cfg["n_layers"]), "--n-heads", str(cfg["n_heads"]),
            "--n-kv-heads", str(kv), "--vocab", str(cfg["vocab_size"]),
            "--dtype", dtype]


def run_cli(main, argv: list[str]) -> str:
    """main(argv) with its standard output captured (and logged); raises
    unless it returns 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    log(out.rstrip())
    if rc != 0:
        raise AssertionError(f"{main.__module__}.main exited {rc}")
    return out


def state_bits(torch, state) -> dict:
    """{path: tensor} of every leaf of a TrainState, floats viewed as the
    integers of their width, so torch.equal compares bits."""
    from tony_tpu_torch.interop import train_state_leaves

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for path, v in train_state_leaves(state):
        t = torch.as_tensor(v).detach()
        if t.is_floating_point():
            t = t.view(ints[t.element_size()])
        out[path] = t
    return out


def serve_checkpoint(torch, ckpt: Path, root: Path, cfg_kw: dict,
                     params: dict, seed: int, extra: list[dict]) -> dict:
    """serve.py --ckpt in a thread (fp32, TF32 off); JOB_SERVE_REQUESTS
    greedy POSTs must equal DecodeSession.generate on ``params`` (the
    restored masters) token for token. The ``extra`` request bodies are
    posted too; their replies are returned ("extra_tokens")."""
    from tony_tpu_torch import serve as serve_cli
    from tony_tpu_torch.models import DecodeSession, TransformerConfig

    cfg = TransformerConfig(dtype="float32", **{**cfg_kw, "max_seq": 256})
    addr = root / "serve.addr"
    addr.unlink(missing_ok=True)  # an earlier server's address
    argv = (["--device", "cuda", "--ckpt", str(ckpt), "--max-seq", "256",
             "--slots", "4", "--port", "0", "--addr-file", str(addr),
             "--max-requests", str(JOB_SERVE_REQUESTS + len(extra))]
            + model_args(cfg_kw, "float32"))
    result: dict = {}

    def serve():
        try:
            result["out"] = run_cli(serve_cli.main, argv)
        except BaseException as exc:  # re-raised below, on the main thread
            result["exc"] = exc

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    deadline = time.monotonic() + 600
    while not addr.exists():
        if not thread.is_alive() or time.monotonic() > deadline:
            thread.join(timeout=1)
            raise AssertionError(f"serve.py did not start: "
                                 f"{result.get('exc')!r}")
        time.sleep(0.1)
    port = int(addr.read_text().strip().rpartition(":")[2])
    rng = np.random.default_rng(seed + 5)
    bodies = [{"prompt": rng.integers(0, cfg.vocab_size, int(n)).tolist(),
               "max_new_tokens": 16}
              for n in rng.integers(16, 65, JOB_SERVE_REQUESTS)]
    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
        replies = list(pool.map(lambda b: _post(port, "/generate", b),
                                bodies + extra))
    replies, extra_replies = replies[:len(bodies)], replies[len(bodies):]
    thread.join(timeout=120)
    if thread.is_alive() or "exc" in result:
        raise AssertionError(f"serve.py did not exit cleanly: "
                             f"{result.get('exc')!r}")
    if f"restored step {JOB_STEPS}" not in result["out"]:
        raise AssertionError("serve.py did not restore the last step")
    session = DecodeSession(params, cfg, device="cuda")
    for body, reply in zip(bodies, replies):
        want = session.generate(np.asarray(body["prompt"], np.int32)[None],
                                body["max_new_tokens"])[0].cpu().tolist()
        if reply["tokens"] != want:
            raise AssertionError(f"served tokens {reply['tokens']} != "
                                 f"generate {want}")
    log(f"serve --ckpt: {len(replies)} greedy replies equal "
        f"DecodeSession.generate on the restored params")
    return {"requests": len(replies),
            "tokens": sum(r["length"] for r in replies),
            "extra_tokens": [r["tokens"] for r in extra_replies]}


def generate_checkpoint(torch, attention, norms, ckpt: Path, cfg_kw: dict,
                        params: dict, prompt: str, served: list) -> dict:
    """generate.py --ckpt (fp32, greedy, GENERATE_NEW tokens) with the
    launch counters from 0 around it (the generate path): each printed row
    equals serve.py's reply to the same padded prompt (``served``) and
    DecodeSession.generate on ``params`` (the restored masters) over the
    whole padded batch."""
    from tony_tpu_torch import generate as gen_cli
    from tony_tpu_torch.models import DecodeSession, TransformerConfig

    _reset_launches(attention, norms)
    out = run_cli(gen_cli.main,
                  ["--device", "cuda", "--ckpt", str(ckpt), "--prompt",
                   prompt, "--max-new", str(GENERATE_NEW), "--max-seq",
                   "256"] + model_args(cfg_kw, "float32"))
    launches = _launches(attention, norms)
    if f"restored step {JOB_STEPS}" not in out:
        raise AssertionError("generate.py did not restore the last step")
    got = [[int(t) for t in line.split(": ")[1].split(",")]
           for line in re.findall(r"^generated\[\d+\]: .*$", out, re.M)]
    cfg = TransformerConfig(dtype="float32", **{**cfg_kw, "max_seq": 256})
    rows = gen_cli.prompt_rows(prompt)
    want = DecodeSession(params, cfg, device="cuda").generate(
        rows, GENERATE_NEW).cpu().tolist()
    if got != want or got != served:
        raise AssertionError(f"generate.py printed {got}; serve.py replied "
                             f"{served}; DecodeSession.generate {want}")
    for name in ("rms_norm", "flash_fwd"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"generate path")
    log(f"generate --ckpt: {len(got)} rows equal serve.py's replies and "
        f"DecodeSession.generate; launches {launches}")
    return {"rows": len(got), "launches": launches}


def check_ckpt_metrics(reg, tag: str, saves: int,
                       shard_bytes: int | None = None) -> dict:
    """The tony_ckpt_* and tony_io_* values a train CLI job left in the
    default registry ``reg`` (logged): as many snapshot and persist
    observations as the job saved, the committed step at JOB_STEPS, and,
    where ``shard_bytes`` is given, tony_ckpt_bytes_total equal to it."""
    snap = reg.snapshot()
    prefixes = ("tony_ckpt_", "tony_io_")
    out = {k: v for kind in ("counters", "gauges")
           for k, v in snap[kind].items() if k.startswith(prefixes)}
    out.update({k: {"count": h["count"], "sum_ms": h["sum"],
                    "mean_ms": h["sum"] / max(h["count"], 1)}
                for k, h in snap["histograms"].items()
                if k.startswith(prefixes)})
    log(f"{tag} metrics: {json.dumps(out)}")
    counts = [out.get(k, {}).get("count") for k in (
        "tony_ckpt_snapshot_ms", "tony_ckpt_persist_ms")]
    if counts != [saves, saves]:
        raise AssertionError(f"{tag}: snapshot and persist observations "
                             f"{counts} for {saves} saves")
    if out.get("tony_ckpt_committed_step") != JOB_STEPS:
        raise AssertionError(f"{tag}: tony_ckpt_committed_step "
                             f"{out.get('tony_ckpt_committed_step')}, "
                             f"last step saved {JOB_STEPS}")
    counted = sum(v for k, v in out.items()
                  if k.startswith("tony_ckpt_bytes_total"))
    if shard_bytes is not None and counted != shard_bytes:
        raise AssertionError(f"{tag}: tony_ckpt_bytes_total {counted}, "
                             f"{shard_bytes} shard bytes on disk")
    if not out.get("tony_io_bytes_read_total"):
        raise AssertionError(f"{tag}: the reader counted no bytes read")
    return out


def job_phase(torch, attention, norms, seed: int, root: Path) -> dict:
    """Jobs A and B and serving from B's checkpoint at full width, with
    the launch counters set to 0 just before and read just after."""
    from tony_tpu_torch import train as train_cli
    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.interop import train_state_leaves
    from tony_tpu_torch.models import TransformerConfig, make_train_step

    corpus = root / "corpus.tokens"
    write_corpus(corpus, seed, JOB_RECORDS, TRAIN_SEQ,
                 BENCH_TRANSFORMER["vocab_size"])
    base = (["--device", "cuda", "--data", str(corpus), "--batch",
             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(JOB_LR),
             "--seed", str(seed)]
            + model_args(BENCH_TRANSFORMER, "bfloat16"))
    dir_a, dir_b = root / "job_a", root / "job_b"
    norms.launches = 0
    attention.launches = attention.launches_dq = attention.launches_dkv = 0
    t0 = time.perf_counter()
    reg = _fresh_registry()
    with io_counts() as counts, \
            step_records(TRAIN_BATCH, TRAIN_SEQ) as records_a:
        run_cli(train_cli.main, base + ["--steps", str(JOB_STEPS),
                                        "--checkpoint-every", str(JOB_EVERY),
                                        "--ckpt-dir", str(dir_a)])
        reads = {"a": counts()}
    t_a = time.perf_counter() - t0
    check_native_reads("job A", reads["a"])
    # Job A: interval saves at every JOB_EVERY steps, then the final one.
    metrics = {"a": check_ckpt_metrics(reg, "job A",
                                       JOB_STEPS // JOB_EVERY + 1)}
    reg = _fresh_registry()
    with io_counts() as counts:
        run_cli(train_cli.main, base + ["--steps", str(JOB_HALF),
                                        "--ckpt-dir", str(dir_b)])
        out = run_cli(train_cli.main, base + ["--steps", str(JOB_STEPS),
                                              "--ckpt-dir", str(dir_b)])
        reads["b"] = counts()
    check_native_reads("job B", reads["b"])
    if f"resumed from step {JOB_HALF}" not in out:
        raise AssertionError(f"job B did not resume from step {JOB_HALF}")
    t_b = time.perf_counter() - t0 - t_a
    # Job B: one final save a run, nothing overwritten or collected, so
    # the shard bytes it counted are the shard bytes on disk.
    metrics["b"] = check_ckpt_metrics(
        reg, "job B", 2, shard_bytes=sum(
            p.stat().st_size for p in dir_b.glob("step_*/process_*.npz")))

    cfg = TransformerConfig(dtype="bfloat16", **BENCH_TRANSFORMER)
    init_fn, _ = make_train_step(cfg, device="cuda")
    states = {}
    for name, d in (("a", dir_a), ("b", dir_b)):
        states[name] = CheckpointManager(d).restore(init_fn(seed + 7),
                                                    step=JOB_STEPS)
        if states[name] is None:
            raise AssertionError(f"job {name}: no step {JOB_STEPS}")
    bits_a, bits_b = (state_bits(torch, states[k]) for k in ("a", "b"))
    if set(bits_a) != set(bits_b):
        raise AssertionError("jobs A and B saved other leaves")
    unequal = [p for p in bits_a if not torch.equal(bits_a[p], bits_b[p])]
    if unequal:
        a, b = (dict(train_state_leaves(states[k])) for k in ("a", "b"))
        worst = max((torch.as_tensor(a[p]).float()
                     - torch.as_tensor(b[p]).float()).abs().max().item()
                    for p in unequal)
        raise AssertionError(
            f"resumed job B differs from job A in {len(unequal)} of "
            f"{len(bits_a)} leaves (worst abs diff {worst}): {unequal[:6]}")
    n_leaves = len(bits_a)
    log(f"job: A ({JOB_STEPS} steps) and B ({JOB_HALF} + resume to "
        f"{JOB_STEPS}) equal bit for bit in all {n_leaves} leaves")
    del states["a"], bits_a, bits_b

    params = states.pop("b").params
    # The generate CLI's ragged rows, left-padded as it pads them, are
    # served too, so both CLIs answer the same prompts.
    from tony_tpu_torch.generate import prompt_rows

    rng = np.random.default_rng(seed + 6)
    prompt = ":".join(",".join(str(t) for t in rng.integers(
        0, BENCH_TRANSFORMER["vocab_size"], n)) for n in GENERATE_LENGTHS)
    extra = [{"prompt": row.tolist(), "max_new_tokens": GENERATE_NEW}
             for row in prompt_rows(prompt)]
    served = serve_checkpoint(torch, dir_b, root, BENCH_TRANSFORMER,
                              params, seed, extra)
    launches = _launches(attention, norms)
    log(f"launches on the job path: {launches}; job A {t_a:.2f} s, job B "
        f"(both runs) {t_b:.2f} s, serving {served}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the job "
                                 f"path")
    generated = generate_checkpoint(torch, attention, norms, dir_b,
                                    BENCH_TRANSFORMER, params, prompt,
                                    served.pop("extra_tokens"))
    log(f"job reads (spans, native preads and readahead hints): "
        f"{json.dumps(reads)}")
    return {"launches": launches, "job_a_s": t_a, "job_b_s": t_b,
            "leaves_equal": n_leaves, "served": served, "metrics": metrics,
            "generate_launches": generated["launches"],
            "train_args": base, "records_a": records_a, "dir_a": dir_a,
            "reads": reads}


def job_timing(torch, train_cli_args: list[str], train: tuple, root: Path,
               train_median_ms: float) -> dict:
    """Checkpoint and input costs on the train phase's in-memory state
    (bench_transformer, fixed batch): three saves, each with the save()
    wall, the next step's time against the median of the 5 steps just
    before it, and persist (save() to commit); restore into a fresh
    template; the bytes of one step; a plain pinned copy_ of the same
    leaves; and the step time with batches from the corpus through the
    sharded reader and device_prefetch."""
    from tony_tpu_torch import train as train_cli
    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.interop import train_state_leaves
    from tony_tpu_torch.io import device_prefetch

    cfg, init_fn, step_fn, state, tokens = train
    leaves = [torch.as_tensor(v) for _, v in train_state_leaves(state)]
    nbytes = sum(t.numel() * t.element_size() for t in leaves)

    def timed_steps(n, batches=None):
        nonlocal state
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        marks[0].record()
        for i in range(n):
            state, _ = step_fn(state, tokens if batches is None
                               else next(batches))
            marks[i + 1].record()
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    mgr = CheckpointManager(root / "timing", max_to_keep=1)
    saves = []
    for _ in range(3):
        base_ms = float(np.median(timed_steps(5)))
        step = int(state.step)
        t0 = time.perf_counter()
        mgr.save(step, state)
        save_ms = (time.perf_counter() - t0) * 1e3
        next_ms = timed_steps(1)[0]
        mgr.wait()
        persist_ms = (time.perf_counter() - t0) * 1e3
        saves.append({"step": step, "save_ms": save_ms,
                      "next_step_ms": next_ms, "median_ms": base_ms,
                      "stall_ms": next_ms - base_ms,
                      "persist_ms": persist_ms})
    step_dir = root / "timing" / f"step_{saves[-1]['step']}"
    written = sum(f.stat().st_size for f in step_dir.iterdir())

    template = init_fn(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = mgr.restore(template)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if restored is None or int(restored.step) != saves[-1]["step"]:
        raise AssertionError("timing restore did not return the last save")
    del template, restored
    mgr.close()  # its save threads and pinned sets would outlive the phase

    block = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    views, off = [], 0
    for t in leaves:
        n = t.numel() * t.element_size()
        views.append(block[off:off + n].view(t.dtype).view(t.shape))
        off += n
    copy_ms = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        for v, t in zip(views, leaves):
            v.copy_(t, non_blocking=True)
        b.record()
        torch.cuda.synchronize()
        copy_ms.append(a.elapsed_time(b))
    del block, views

    args = train_cli.parse_args(train_cli_args)
    # One process: data row 0 of 1, the whole corpus.
    with device_prefetch(train_cli.corpus_batches(args, 0, 1),
                         "cuda") as batches:
        timed_steps(2, batches)
        file_ms = timed_steps(10, batches)
    res = {
        "state_bytes": nbytes, "bytes_written": written,
        "d2h_bound_ms": nbytes / PCIE_BYTES_PER_S * 1e3,
        "pinned_copy_ms": copy_ms, "saves": saves,
        "restore_ms": restore_ms,
        "file_step_ms_median": float(np.median(file_ms)),
        "file_step_ms": file_ms, "fixed_step_ms_median": train_median_ms,
    }
    log("job timing: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# Phase 10b: the job path over gs://, the native data plane and a fault plan
# ---------------------------------------------------------------------------

# Job C: job A's corpus and arguments, read from a gs:// object of a
# TONY_GCS_EMULATOR_DIR root, checkpointing to a gs:// prefix for
# JOB_C_STEPS steps under JOB_C_PLAN, then resumed to JOB_STEPS with no plan.
JOB_C_STEPS = JOB_STEPS - JOB_EVERY
# The last complete step the torn save leaves (job C resumes from it).
JOB_C_RESUME = JOB_STEPS - 2 * JOB_EVERY
JOB_C_BUCKET = "gs://tony-smoke"
JOB_C_DELAY_MS, JOB_C_THROTTLE_MS, JOB_C_DEGRADE_MS = 200, 100, 150
JOB_C_THROTTLE_AFTER, JOB_C_THROTTLE_COUNT, JOB_C_DEGRADE_AFTER = 1, 2, 2
# The degraded step's wall must lie the degrade above the median of the
# other steps, less this share of the degrade: the step-to-step jitter of
# the steps' own work.
JOB_C_DEGRADE_TOL = 0.1
# The partial write holds for 2 writes of JOB_C_STEPS: the CLI's interval
# save there and its final blocking save of the same step.
JOB_C_PLAN = {"seed": 19, "faults": [
    {"action": "delay_checkpoint_write", "ms": JOB_C_DELAY_MS, "count": 100},
    {"action": "fail_checkpoint_write", "step": JOB_C_STEPS,
     "mode": "partial", "count": 2},
    {"action": "throttle_io", "ms": JOB_C_THROTTLE_MS,
     "after_batches": JOB_C_THROTTLE_AFTER, "count": JOB_C_THROTTLE_COUNT},
    {"action": "degrade_task", "target": "worker:0", "ms": JOB_C_DEGRADE_MS,
     "after_steps": JOB_C_DEGRADE_AFTER},
]}
# The native-against-preadv read: a token file of ~1 GiB of bench_transformer
# records, read whole from the page cache (warmed by one read first).
NATIVE_READ_BYTES = 1 << 30
NATIVE_READ_ROUNDS = 2


@contextlib.contextmanager
def io_counts():
    """Counts, while in the block, of the reader's span reads by storage
    (``local_spans``, ``gs_spans``), of ``native.pread_records`` and
    ``native.readahead``, and of the default object store's ``get_range``.
    Each wrapper holds one re-entrant lock across its call, so a span and
    the read inside it are counted together and ``snapshot()`` never sees
    one without the other (the span reads of the run are serialized)."""
    from tony_tpu_torch.cloud.gcs import (FileObjectStorage, GcsStorage,
                                          is_gs_uri)
    from tony_tpu_torch.io import native
    from tony_tpu_torch.io.reader import ShardedRecordReader

    counts = {k: 0 for k in ("local_spans", "gs_spans", "pread",
                             "readahead", "get_range")}
    lock = threading.RLock()

    def counted(owner, attr, key):
        real = getattr(owner, attr)

        def wrapper(*args, **kwargs):
            with lock:
                counts[key(*args)] += 1
                return real(*args, **kwargs)

        return owner, attr, real, wrapper

    patches = [
        counted(ShardedRecordReader, "_read_span",
                lambda self, path, *a: ("gs_spans" if is_gs_uri(path)
                                        else "local_spans")),
        counted(native, "pread_records", lambda *a: "pread"),
        counted(native, "readahead", lambda *a: "readahead"),
        counted(FileObjectStorage, "get_range", lambda *a: "get_range"),
        counted(GcsStorage, "get_range", lambda *a: "get_range"),
    ]
    for owner, attr, _, wrapper in patches:
        setattr(owner, attr, wrapper)

    def snapshot() -> dict:
        with lock:
            return dict(counts)

    try:
        yield snapshot
    finally:
        for owner, attr, real, _ in patches:
            setattr(owner, attr, real)


def check_native_reads(tag: str, counts: dict) -> None:
    """A local-corpus job read every span through native.pread_records,
    sent readahead hints, and touched no object store."""
    if not counts["local_spans"]:
        raise AssertionError(f"{tag}: the reader read no local span")
    if counts["pread"] != counts["local_spans"]:
        raise AssertionError(
            f"{tag}: {counts['pread']} native pread_records calls for "
            f"{counts['local_spans']} local spans: {counts}")
    if not counts["readahead"]:
        raise AssertionError(f"{tag}: no native readahead hint: {counts}")
    if counts["gs_spans"] or counts["get_range"]:
        raise AssertionError(f"{tag}: gs:// reads on a local job: {counts}")


def check_gs_reads(tag: str, counts: dict) -> None:
    """A gs:// job read every span through the store's get_range and none
    natively."""
    if not counts["gs_spans"]:
        raise AssertionError(f"{tag}: the reader read no gs:// span")
    if counts["get_range"] != counts["gs_spans"]:
        raise AssertionError(
            f"{tag}: {counts['get_range']} get_range calls for "
            f"{counts['gs_spans']} gs:// spans: {counts}")
    if counts["local_spans"] or counts["pread"] or counts["readahead"]:
        raise AssertionError(f"{tag}: native reads on a gs:// job: {counts}")


@contextlib.contextmanager
def step_records(batch: int, seq: int):
    """Per step of the train CLI runs in the block: the loss and the fenced
    step wall it reports (``observability.report``; the wall from its
    tokens/s, so it holds the degrade sleep and not the batch wait), and
    the step anatomy's phases where StepStats published them (from the
    third dispatch on). Yields the list of records."""
    from tony_tpu_torch import observability
    from tony_tpu_torch.observability.stepstats import StepStats

    records: list[dict] = []
    real_report, real_publish = observability.report, StepStats._publish

    def report(**kw):
        records.append({"step": kw["step"], "loss": kw["loss"],
                        "wall_s": batch * seq / kw["tokens_per_sec"]})
        return real_report(**kw)

    def publish(self, wall_ms, phases):
        if records:
            records[-1].setdefault("phases_ms", []).append(dict(phases))
        return real_publish(self, wall_ms, phases)

    observability.report, StepStats._publish = report, publish
    try:
        yield records
    finally:
        observability.report, StepStats._publish = real_report, real_publish


def data_wait_ms(records: list[dict]) -> float:
    return sum(p["data_wait"] for r in records
               for p in r.get("phases_ms", []))


def check_job_c(records_a: list[dict], records_c: list[dict], slept: dict,
                persist_ms: list[float], torn: dict) -> dict:
    """Job C against job A and its fault plan: the losses until the first
    restore bit for bit (same corpus, seed and steps; sleeps change no
    number), the torn step not complete, every persisted save's
    tony_ckpt_persist_ms at least the delay, the throttle exactly
    JOB_C_THROTTLE_COUNT sleeps after JOB_C_THROTTLE_AFTER batches, more
    data_wait than job A, and the degraded step's wall the degrade above
    the median step's (less JOB_C_DEGRADE_TOL of it). Returns the numbers
    it read."""
    losses_a = [r["loss"] for r in records_a[:JOB_C_STEPS]]
    losses_c = [r["loss"] for r in records_c]
    if losses_c != losses_a:
        raise AssertionError(f"job C losses {losses_c} != job A's "
                             f"{losses_a}")
    if torn["complete"] or not torn["shard"] or torn["marker"]:
        raise AssertionError(f"the torn step {JOB_C_STEPS} is not torn: "
                             f"{torn}")
    if torn["latest"] != JOB_C_RESUME:
        raise AssertionError(f"latest complete step {torn['latest']}, not "
                             f"{JOB_C_RESUME}")
    # Saves before the torn step commit and observe their persist time.
    saves = JOB_C_STEPS // JOB_EVERY - 1
    if len(persist_ms) != saves or min(persist_ms) < JOB_C_DELAY_MS:
        raise AssertionError(f"persist ms {persist_ms}: want {saves} saves "
                             f">= {JOB_C_DELAY_MS} ms")
    want_io = [(JOB_C_THROTTLE_AFTER + 1 + i, JOB_C_THROTTLE_MS / 1e3)
               for i in range(JOB_C_THROTTLE_COUNT)]
    if slept["throttle"] != want_io:
        raise AssertionError(f"throttle_io slept {slept['throttle']} "
                             f"(batches served, s), want {want_io}")
    wait_a, wait_c = data_wait_ms(records_a), data_wait_ms(records_c)
    if not wait_c > wait_a:
        raise AssertionError(f"job C data_wait {wait_c} ms is not above "
                             f"job A's {wait_a} ms")
    if slept["degrade"] != [JOB_C_DEGRADE_MS / 1e3]:
        raise AssertionError(f"degrade_task slept {slept['degrade']}")
    walls = [r["wall_s"] for r in records_c]
    degraded = walls[JOB_C_DEGRADE_AFTER]
    # The median of the other steps but the first (its one-off costs).
    median = float(np.median([w for i, w in enumerate(walls)
                              if i and i != JOB_C_DEGRADE_AFTER]))
    want = JOB_C_DEGRADE_MS / 1e3 * (1 - JOB_C_DEGRADE_TOL)
    if degraded - median < want:
        raise AssertionError(f"degraded step wall {degraded} s is not "
                             f"{want * 1e3:.1f} ms above the median "
                             f"{median} s of the other steps: {walls}")
    return {"losses_equal": len(losses_c), "persist_ms": persist_ms,
            "data_wait_ms": {"a": wait_a, "c": wait_c},
            "data_wait_by_step_ms": [[p["data_wait"] for p in
                                      r.get("phases_ms", [])]
                                     for r in records_c],
            "walls_s": walls, "degraded_s": degraded, "median_s": median}


def _bits_equal(torch, a, b, tag: str) -> int:
    bits_a, bits_b = state_bits(torch, a), state_bits(torch, b)
    if set(bits_a) != set(bits_b):
        raise AssertionError(f"{tag}: other leaves")
    unequal = [p for p in bits_a if not torch.equal(bits_a[p], bits_b[p])]
    if unequal:
        raise AssertionError(f"{tag}: {len(unequal)} of {len(bits_a)} "
                             f"leaves differ: {unequal[:6]}")
    return len(bits_a)


def native_read_timing(root: Path) -> dict:
    """One whole read of a ~1 GiB token file from the page cache through
    the reader, with the native library and with the preadv path, in turns
    (native, preadv, ...); each read's wall, tony_io_read_ms (sum over
    spans and count) and bytes/s over the wall."""
    from tony_tpu_torch.io import ShardedRecordReader, native

    block = 1024
    n = NATIVE_READ_BYTES // (2 * (TRAIN_SEQ + 1)) // block * block
    path = root / "native.tokens"
    rows = (np.arange(block * (TRAIN_SEQ + 1)) % 65521).astype(np.uint16)
    with open(path, "wb") as f:
        for _ in range(n // block):
            rows.tofile(f)

    def read(native_on: bool) -> dict:
        reg = _fresh_registry()
        with contextlib.ExitStack() as stack:
            if not native_on:
                real = native.available
                native.available = lambda: False
                stack.callback(setattr, native, "available", real)
            t0 = time.perf_counter()
            with ShardedRecordReader([str(path)], fmt="tokens",
                                     record_len=TRAIN_SEQ + 1,
                                     dtype=np.uint16,
                                     batch_size=1024) as reader:
                got = sum(len(b) for b in reader)
            wall = time.perf_counter() - t0
        if got != n:
            raise AssertionError(f"read {got} of {n} records")
        snap = reg.snapshot()
        hist = snap["histograms"]["tony_io_read_ms"]
        nbytes = snap["counters"]["tony_io_bytes_read_total"]
        return {"wall_s": wall, "read_ms_sum": hist["sum"],
                "spans": hist["count"], "bytes": nbytes,
                "gb_per_s": nbytes / wall / 1e9}

    read(True)  # page cache
    out: dict = {"native": [], "preadv": []}
    for _ in range(NATIVE_READ_ROUNDS):
        for name, on in (("native", True), ("preadv", False)):
            out[name].append(read(on))
    path.unlink()
    log("native read timing: " + json.dumps(out))
    return out


def job_gs_phase(torch, attention, norms, seed: int, root: Path,
                 job: dict) -> dict:
    """Job C over gs:// under JOB_C_PLAN at full width, its resume past the
    torn step, serving from its gs:// checkpoint, and the native read
    timing, with the launch counters set to 0 just before and read just
    after job C, its resume and the serving."""
    import os

    from tony_tpu_torch import cloud
    from tony_tpu_torch import train as train_cli
    from tony_tpu_torch.checkpoint import CheckpointManager, layout
    from tony_tpu_torch.checkpoint import manager as manager_mod
    from tony_tpu_torch.models import TransformerConfig, make_train_step
    from tony_tpu_torch.resilience import faults

    # Job B's checkpoints are served and done with: their disk goes to
    # job C's.
    shutil.rmtree(root / "job_b")
    os.environ["TONY_GCS_EMULATOR_DIR"] = str(root / "gcs")
    cloud.set_default_storage(None)
    store = cloud.default_storage()
    corpus = f"{JOB_C_BUCKET}/corpus/corpus.tokens"
    ck = f"{JOB_C_BUCKET}/job_c"
    store.upload_file(root / "corpus.tokens", corpus)
    args = list(job["train_args"])
    args[args.index("--data") + 1] = corpus
    args += ["--checkpoint-every", str(JOB_EVERY), "--ckpt-dir", ck]
    fault_env = {"TONY_FAULT_PLAN": json.dumps(JOB_C_PLAN),
                 "JOB_NAME": "worker", "TASK_INDEX": "0"}
    os.environ.update(fault_env)
    faults._reset_singletons()
    slept: dict = {"throttle": [], "degrade": []}
    persist_ms: list[float] = []
    real_observe = manager_mod._observe_ms

    def observe(name, value_ms):
        if name == manager_mod.CKPT_PERSIST_HISTOGRAM:
            persist_ms.append(value_ms)
        return real_observe(name, value_ms)

    try:
        io_faults, step_faults = (faults.io_faults_from_env(),
                                  faults.step_faults_from_env())
        io_faults._sleep = lambda s: (
            slept["throttle"].append((io_faults._served, s)), time.sleep(s))
        step_faults._sleep = lambda s: (slept["degrade"].append(s),
                                        time.sleep(s))
        manager_mod._observe_ms = observe
        _reset_launches(attention, norms)
        t0 = time.perf_counter()
        with io_counts() as counts, \
                step_records(TRAIN_BATCH, TRAIN_SEQ) as records_c:
            run_cli(train_cli.main, args + ["--steps", str(JOB_C_STEPS)])
            counts_c = counts()
        t_c = time.perf_counter() - t0
    finally:
        manager_mod._observe_ms = real_observe
        for key in fault_env:
            os.environ.pop(key)
        faults._reset_singletons()
    check_gs_reads("job C", counts_c)
    mgr = CheckpointManager(ck)
    torn = {"latest": mgr.latest_step(),
            "complete": JOB_C_STEPS in layout.complete_steps(mgr._store, 1),
            "shard": store.exists(f"{ck}/step_{JOB_C_STEPS}/process_0.npz"),
            "marker": store.exists(f"{ck}/step_{JOB_C_STEPS}/metadata.json")}
    checked = check_job_c(job["records_a"], records_c, slept, persist_ms,
                          torn)
    log(f"job C: {t_c:.2f} s, {json.dumps(checked)}, reads {counts_c}, "
        f"torn step {torn}")

    # The last complete step, restored from gs://, against job A's.
    cfg = TransformerConfig(dtype="bfloat16", **BENCH_TRANSFORMER)
    init_fn, _ = make_train_step(cfg, device="cuda")
    restored = {}
    for name, where in (("gs", ck), ("local", job["dir_a"])):
        template = init_fn(seed + 7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = CheckpointManager(where).restore(template,
                                                 step=JOB_C_RESUME)
        torch.cuda.synchronize()
        if state is None:
            raise AssertionError(f"{name}: no step {JOB_C_RESUME}")
        restored[name] = (state, (time.perf_counter() - t0) * 1e3)
    n_leaves = _bits_equal(torch, restored["gs"][0], restored["local"][0],
                           f"job C's step {JOB_C_RESUME} from gs:// "
                           f"against job A's")
    restore_ms = {k: v[1] for k, v in restored.items()}
    del restored

    t0 = time.perf_counter()
    with step_records(TRAIN_BATCH, TRAIN_SEQ) as records_r:
        out = run_cli(train_cli.main, args + ["--steps", str(JOB_STEPS)])
    t_resume = time.perf_counter() - t0
    if f"resumed from step {JOB_C_RESUME}\n" not in out:
        raise AssertionError(f"job C did not resume from step "
                             f"{JOB_C_RESUME}")
    losses_a = [r["loss"] for r in job["records_a"][JOB_C_RESUME:]]
    if [r["loss"] for r in records_r] != losses_a:
        raise AssertionError(f"resumed job C losses "
                             f"{[r['loss'] for r in records_r]} != job "
                             f"A's {losses_a}")
    state = CheckpointManager(ck).restore(init_fn(seed + 7), step=JOB_STEPS)
    if state is None:
        raise AssertionError(f"job C has no step {JOB_STEPS} on gs://")
    params = state.params
    del state
    served = serve_checkpoint(torch, ck, root, BENCH_TRANSFORMER, params,
                              seed, [])
    launches = _launches(attention, norms)
    check_path_launches({"job_gs": launches})
    log(f"launches on the job_gs path: {launches}; job C {t_c:.2f} s, "
        f"resume {t_resume:.2f} s, restore ms {restore_ms}, served "
        f"{served}")
    del params
    torch.cuda.empty_cache()
    timing = native_read_timing(root)
    cloud.set_default_storage(None)
    os.environ.pop("TONY_GCS_EMULATOR_DIR")
    shutil.rmtree(root / "gcs")
    return {"launches": launches, "job_c_s": t_c, "resume_s": t_resume,
            "checked": checked, "reads": counts_c, "leaves_equal": n_leaves,
            "restore_ms": restore_ms, "served": served,
            "native_read": timing}


# ---------------------------------------------------------------------------
# Phases 11-13: the MoE model family
# ---------------------------------------------------------------------------

_KERNEL_CATEGORIES = (("flash_fwd_kernel", "B1"), ("flash_bwd_dq_kernel", "B2"),
                      ("flash_bwd_dkv_kernel", "B3"), ("rms_norm", "B4"))
_MOE_CATEGORIES = {"moe.route": "routing/dispatch/combine",
                   "moe.dispatch": "routing/dispatch/combine",
                   "moe.combine": "routing/dispatch/combine",
                   "moe.experts": "experts"}


def step_breakdown(torch, fn) -> dict:
    """Device ms of one profiled call of fn() (a train step) by part:
    B1-B4 by kernel name; the MoE layer's routing, dispatch and combine,
    and its experts (the bmm products and the SwiGLU between them), by
    the ``moe.*`` profiler range of the op that launched the kernel, or,
    in the backward, of the forward op whose autograd node it runs (the
    node carries the forward op's sequence number); everything else is
    "rest" (the total less the parts). A kernel the profiler tied to no
    op counts as "rest" too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        if kernels:
            break
        log("the profiler saw no device time; profiling the call again")
    else:
        raise AssertionError(f"the profiler saw no device time in "
                             f"{PROFILE_TRIES} tries")

    def enclosing(e):
        """The innermost moe.* / remat.recompute range, or the backward
        node, around a CPU event."""
        while e is not None:
            if e.name.startswith(("moe.", "remat.recompute",
                                  "autograd::engine::evaluate_function")):
                return e
            e = e.cpu_parent
        return None

    def kernel_part(name: str):
        return next((c for pat, c in _KERNEL_CATEGORIES if pat in name),
                    None)

    parts: dict[str, float] = {}
    tops: dict[str, dict[str, float]] = {}

    def add(part: str, name: str, us: float) -> None:
        parts[part] = parts.get(part, 0.0) + us
        top = tops.setdefault(part, {})
        top[name[:80]] = top.get(name[:80], 0.0) + us

    for k in kernels:
        part = kernel_part(k.name)
        if part is not None:
            add(part, k.name, k.time_range.elapsed_us())
    total = sum(k.time_range.elapsed_us() for k in kernels)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    forward_part = {}
    for e in cpu:
        outer = enclosing(e)
        if e.sequence_nr >= 0 and outer is not None and \
                outer.name in _MOE_CATEGORIES:
            forward_part[e.sequence_nr] = _MOE_CATEGORIES[outer.name]
    # The profiler hands each op the kernels it launched (the ctypes
    # launches of B1-B4 belong to no op; they are counted by name above).
    for e in cpu:
        launched = [k for k in getattr(e, "kernels", [])
                    if kernel_part(k.name) is None]
        if not launched:
            continue
        outer = enclosing(e)
        name = outer.name if outer is not None else ""
        part = (_MOE_CATEGORIES.get(name)
                or (forward_part.get(outer.sequence_nr)
                    if name.startswith("autograd::") else None))
        if part is not None:
            for k in launched:
                add(part, k.name, k.duration)
    parts["rest"] = total - sum(parts.values())
    by_part = {k: v / 1e3 for k, v in sorted(parts.items(),
                                             key=lambda kv: -kv[1])}
    top_kernels = {
        part: [{"kernel": n, "device_ms": us / 1e3} for n, us in
               sorted(top.items(), key=lambda kv: -kv[1])[:6]]
        for part, top in tops.items() if part in _MOE_CATEGORIES.values()}
    return {"wall_ms": wall_ms, "device_ms": total / 1e3,
            "device_busy_share": total / 1e3 / wall_ms, "by_part_ms": by_part,
            "top_kernels_by_part": top_kernels}


def moe_step_flops(cfg, batch: int, seq: int) -> tuple[float, str]:
    """The routed model FLOPs of one train step and the formula: 3 times
    the forward's matrix products, counting all E*C capacity rows of the
    experts whether filled or not."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    e, f, v = cfg.n_experts, cfg.d_ff, cfg.vocab_size
    tok = batch * seq
    cap = max(1, int(cfg.capacity_factor * tok * cfg.expert_top_k / e))
    layer = (2 * tok * d * (2 * h + 2 * hkv) * dh
             + 2 * batch * h * dh * seq * (seq + 1)
             + 2 * tok * d * e
             + 2 * e * cap * 3 * d * f)
    flops = 3 * (cfg.n_layers * layer + 2 * tok * d * v)
    formula = ("3 * (L * (2*B*T*d*(2H+2Hkv)*Dh [q,k,v,o] + 2*B*H*Dh*T*(T+1) "
               "[causal QK^T, PV] + 2*B*T*d*E [router] + 2*E*C*3*d*F "
               "[experts, C = int(cf*B*T*k/E) rows each]) + 2*B*T*d*V "
               f"[unembed]), C = {cap}")
    return float(flops), formula


def _reset_launches(attention, norms) -> None:
    norms.launches = 0
    attention.launches = attention.launches_dq = attention.launches_dkv = 0


def _launches(attention, norms) -> dict:
    return {"rms_norm": norms.launches, "flash_fwd": attention.launches,
            "flash_bwd_dq": attention.launches_dq,
            "flash_bwd_dkv": attention.launches_dkv}


def moe_train_phase(torch, attention, norms, seed: int) -> dict:
    """make_train_step on bench_moe's configuration at full width and depth
    (BENCH_MOE), one fixed batch [4, 2049] from ``seed``: the step median
    (TRAIN_STEPS after TRAIN_WARMUP warm-ups, CUDA events at the step
    boundaries), tokens/s, peak memory, MFU from the routed FLOPs
    (moe_step_flops), the router's drop rate and entropy, and one profiled
    step split by part (step_breakdown). The loss must be finite and
    fall; the launch counters are set to 0 just before and read just
    after, and B1-B4 must each have launched. Then the step median and
    peak memory of the same step with remat "full" and with no remat,
    each from a fresh init (timed_steps)."""
    from tony_tpu_torch.models import TransformerConfig, make_train_step
    from tony_tpu_torch.models.train import leaves

    cfg = TransformerConfig(dtype="bfloat16", **BENCH_MOE)
    init_fn, step_fn = make_train_step(cfg, device="cuda")
    state = init_fn(seed)
    n_params = sum(p.numel() for p in leaves(state.params))
    rng = np.random.default_rng(seed + 5)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (MOE_BATCH, TRAIN_SEQ + 1)),
        device="cuda")
    _reset_launches(attention, norms)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, first = step_fn(state, tokens)
    losses, metrics = [first["loss"]], first
    for _ in range(TRAIN_WARMUP - 1):
        state, metrics = step_fn(state, tokens)
        losses.append(metrics["loss"])
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TRAIN_STEPS + 1)]
    marks[0].record()
    for i in range(TRAIN_STEPS):
        state, metrics = step_fn(state, tokens)
        losses.append(metrics["loss"])
        marks[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    peak = torch.cuda.max_memory_allocated()
    router = {when: {k: float(m[k]) for k in ("moe_drop_rate", "moe_entropy",
                                              "moe_balance", "moe_zloss")}
              for when, m in (("first_step", first), ("last_step", metrics))}

    def one_step():
        nonlocal state
        state, out = step_fn(state, tokens)
        losses.append(out["loss"])

    profiled = step_breakdown(torch, one_step)
    launches = _launches(attention, norms)
    n_steps = len(losses)
    loss_values = _loss_list(torch, losses)
    if not all(np.isfinite(loss_values)):
        raise AssertionError(f"moe train: non-finite loss {loss_values}")
    if not loss_values[-1] < loss_values[0]:
        raise AssertionError(f"moe train: loss did not descend "
                             f"{loss_values}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the MoE "
                                 f"train path")
    median_ms = float(np.median(step_ms))
    flops, formula = moe_step_flops(cfg, MOE_BATCH, TRAIN_SEQ)
    del state
    # The same step at the other remat settings, for comparison ("dots"
    # runs under a dispatch mode that sees every op on the host).
    other_remat = {}
    for remat, policy in ((True, "full"), (False, "full")):
        other = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        o_init, o_step = make_train_step(other, device="cuda")
        _, o_ms, o_peak, _ = timed_steps(torch, o_step, o_init(seed), tokens)
        other_remat["none" if not remat else policy] = {
            "step_ms_median": float(np.median(o_ms)),
            "peak_memory_gb": o_peak / 1e9}
        torch.cuda.empty_cache()
    res = {
        "params_m": n_params / 1e6, "batch": MOE_BATCH, "seq": TRAIN_SEQ,
        "step_ms_median": median_ms, "step_ms": step_ms,
        "tokens_per_s": MOE_BATCH * TRAIN_SEQ / (median_ms / 1e3),
        "model_flops_per_step": flops, "flops_formula": formula,
        "mfu": flops / (median_ms / 1e3) / PEAK_FLOPS["torch.bfloat16"],
        "peak_memory_gb": peak / 1e9, "router": router,
        "losses": loss_values, "launches": launches,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "profiled_step": profiled, "other_remat": other_remat,
    }
    log("moe train: " + json.dumps(res))
    return res


def moe_parity_phase(torch, seed: int) -> dict:
    """fp32, TF32 off, MOE_PARITY with skewed weights (MOE_PARITY_SKEW:
    tokens drop): the card against the CPU's plain path at each remat
    setting (train_parity_phase), then the
    expert-parallel path on a one-rank NCCL mesh (a group on a HashStore):
    DP_PARITY_STEPS steps of make_train_step(cfg, mesh) at remat "dots"
    equal mesh=None's bit for bit (losses, router metrics, every leaf),
    and its all_to_all ran."""
    from datetime import timedelta

    import torch.distributed as dist

    from tony_tpu_torch.models import TransformerConfig, make_train_step
    from tony_tpu_torch.parallel import MeshSpec, build_mesh

    out = {"remat": train_parity_phase(torch, seed, MOE_PARITY,
                                       "moe parity", MOE_PARITY_SKEW)}
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(dtype="float32", remat=True,
                            remat_policy="dots", **MOE_PARITY)
    params = parity_params(torch, cfg, seed, MOE_PARITY_SKEW)
    rng = np.random.default_rng(seed + 6)
    batches = [torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (PARITY_TRAIN_BATCH, cfg.max_seq + 1)),
        device="cuda") for _ in range(DP_PARITY_STEPS)]
    init_fn, step_fn = make_train_step(cfg, device="cuda")
    plain = init_fn(params=params)
    plain_metrics = [step_fn(plain, b)[1] for b in batches]
    calls = [0]
    real = dist.all_to_all_single

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=timedelta(seconds=DP_TIMEOUT_S))
    dist.all_to_all_single = counted
    try:
        mesh = build_mesh(MeshSpec(), "cuda", timeout_s=DP_TIMEOUT_S)
        m_init, m_step = make_train_step(cfg, mesh, device="cuda")
        state = m_init(params=params)
        metrics = [m_step(state, b)[1] for b in batches]
        torch.cuda.synchronize()
    finally:
        dist.all_to_all_single = real
        dist.destroy_process_group()
    for i, (got, want) in enumerate(zip(metrics, plain_metrics)):
        unequal = [k for k in want if not torch.equal(got[k], want[k])]
        if unequal or set(got) != set(want):
            raise AssertionError(f"moe ep: step {i} metrics {unequal} "
                                 f"differ from mesh=None")
    drop = float(plain_metrics[0]["moe_drop_rate"])
    if not drop > 0:
        raise AssertionError(f"moe ep: no token dropped (rate {drop})")
    bits, plain_bits = state_bits(torch, state), state_bits(torch, plain)
    unequal = [p for p in plain_bits if not torch.equal(bits[p],
                                                        plain_bits[p])]
    if unequal or set(bits) != set(plain_bits):
        raise AssertionError(f"moe ep: {len(unequal)} leaves differ from "
                             f"mesh=None: {unequal[:6]}")
    if calls[0] <= 0:
        raise AssertionError("moe ep: the all_to_all never ran")
    out["ep_world1"] = {"steps": DP_PARITY_STEPS, "leaves_equal":
                        len(bits), "all_to_all_calls": calls[0],
                        "drop_rate": drop}
    log("moe parity, ep over one NCCL rank: " + json.dumps(out["ep_world1"]))
    return out


# ---------------------------------------------------------------------------
# Phase 12b: the MoE trunk's model axes: the pipeline in one process, and
# tp, sp and pp on a one-rank NCCL mesh
# ---------------------------------------------------------------------------

def _moe_run(torch, cfg, params: dict, tokens, **pipe) -> tuple:
    """(loss, the four router values, every leaf's gradient in ``leaves``
    order) of lm_loss without a mesh on fresh trainable copies of
    ``params``: through the pipeline run in this process with ``pipe``
    (lm_loss's pipeline arguments and ``pipeline_stages``); without it,
    the trunk one microbatch of ``MOE_PP_MICROBATCHES`` rows at a time,
    the losses and router values averaged over the microbatches and the
    gradients taken of that mean (the pipeline's math: each microbatch
    routed alone with a capacity counted from its rows)."""
    from tony_tpu_torch.models import lm_loss
    from tony_tpu_torch.models.train import leaves

    def trainable(tree):
        return {k: (trainable(v) if isinstance(v, dict) else
                    v.detach().to("cuda", copy=True).requires_grad_())
                for k, v in tree.items()}

    params = trainable(params)
    if pipe:
        loss, metrics = lm_loss(params, tokens, cfg, None,
                                return_metrics=True, **pipe)
        loss.backward()
        sums = {k: v.detach() for k, v in {"loss": loss, **metrics}.items()}
        m = 1
    else:
        m = MOE_PP_MICROBATCHES
        sums = {}
        for part in tokens.chunk(m):
            loss, metrics = lm_loss(params, part, cfg, None,
                                    return_metrics=True)
            (loss / m).backward()
            for k, v in {"loss": loss, **metrics}.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
    torch.cuda.synchronize()
    values = {k: float(v) / m for k, v in sums.items()
              if k in MOE_AUX or k == "loss"}
    return values.pop("loss"), values, [p.grad for p in leaves(params)]


def _check_moe_pipeline(tag: str, got: tuple, want: tuple, loss_rtol: float,
                        grad_tol: float) -> dict:
    """The pipeline's loss and router values within ``loss_rtol`` of the
    microbatch-by-microbatch reference's, every gradient leaf within
    ``grad_tol`` of its leaf's largest |value|."""
    out = _compare_grads(f"moe {tag}", got[0], got[2], (want[0], want[2]),
                         loss_rtol, grad_tol)
    for k in MOE_AUX:
        a, b = got[1][k], want[1][k]
        if not abs(a - b) <= loss_rtol * abs(b):
            raise AssertionError(f"moe pp {tag}: {k} {a} vs the reference "
                                 f"{b} (rtol {loss_rtol})")
    out["aux"], out["want_aux"] = got[1], want[1]
    return out


def moe_mesh_phase(torch, attention, norms, seed: int) -> dict:
    """The MoE trunk over the model axes on one card, in two parts.

    The pipeline (path "moe_pp"): ``forward_pipeline`` with every stage in
    this process at bench_moe's full width and depth (BENCH_MOE: 8
    layers, remat "dots", bf16) over MOE_PP_MICROBATCHES microbatches of
    the [4, 2049] batch, under each of MOE_PP_SCHEDULES (pp 2 GPipe, pp 4
    interleaved with 2 virtual stages): the loss, the four router values
    and every gradient leaf against the same trunk run one microbatch at a
    time (``_moe_run``), which routes the same rows with the same capacity,
    in bf16 within PP_BF16_LOSS_RTOL and PP_BF16_GRAD_TOL, and every B1
    and B2/B3 launch held against its plain version on the same inputs
    (``_held_to_plain``); then the same at MOE_PARITY's widths and 8
    layers in fp32 (TF32 off), with MOE_PARITY_SKEW's weights so that
    tokens drop, within TRAIN_LOSS_RTOL and TRAIN_GRAD_TOL.

    The mesh paths (path "moe_mesh"): MeshSpec(tp=1), (sp=1) and (pp=1) on
    a one-rank NCCL group under MOE_PARITY in fp32 with drops and remat
    "dots": DP_PARITY_STEPS steps' losses and the first step's gradients
    against mesh=None (``_check_mesh_parity``'s limits), the pp mesh both
    with the layer stack gathered and through the pipeline over one
    microbatch. At size 1 copy_to_tp and reduce_from_tp are the identity,
    the statistics' pmean and the all_to_all one-rank collectives, and
    the trunk reaches neither the ring's rotation nor the sends between
    stages: dp_study.py --ep with --tp, --sp or --pp runs those.

    The references run outside the counted windows; the launch counters
    are set to 0 just before each path and read just after."""
    from datetime import timedelta

    import torch.distributed as dist

    from tony_tpu_torch.models import TransformerConfig, init_params
    from tony_tpu_torch.parallel import MeshSpec, build_mesh, schedule_info

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 15)
    cfg = TransformerConfig(dtype="bfloat16", **BENCH_MOE)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 15)
    params = init_params(cfg, gen, device="cuda")
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (MOE_BATCH, TRAIN_SEQ + 1)),
        device="cuda")
    pcfg = TransformerConfig(dtype="float32", remat=True, remat_policy="dots",
                             **dict(MOE_PARITY, n_layers=cfg.n_layers))
    pparams = parity_params(torch, pcfg, seed, MOE_PARITY_SKEW)
    ptokens = torch.as_tensor(rng.integers(
        0, pcfg.vocab_size, (MOE_PP_MICROBATCHES * 2, pcfg.max_seq + 1)),
        device="cuda")
    runs = {"bf16": (cfg, params, tokens, PP_BF16_LOSS_RTOL,
                     PP_BF16_GRAD_TOL),
            "fp32": (pcfg, pparams, ptokens, TRAIN_LOSS_RTOL,
                     TRAIN_GRAD_TOL)}
    refs = {dtype: _moe_run(torch, model, p, t)
            for dtype, (model, p, t, _, _) in runs.items()}
    if not refs["fp32"][1]["moe_drop_rate"] > 0:
        raise AssertionError("moe pp fp32: no token dropped")
    log(f"moe pp references (one microbatch at a time): drop rate bf16 "
        f"{refs['bf16'][1]['moe_drop_rate']}, fp32 "
        f"{refs['fp32'][1]['moe_drop_rate']}")

    _reset_launches(attention, norms)
    schedules = {}
    for stages, schedule, virtual in MOE_PP_SCHEDULES:
        tag = f"pp {stages} {schedule} v {virtual}"
        pipe = dict(pipeline_microbatches=MOE_PP_MICROBATCHES,
                    pipeline_schedule=schedule, pipeline_virtual=virtual,
                    pipeline_stages=stages)
        info = schedule_info(schedule, MOE_PP_MICROBATCHES, stages,
                             cfg.n_layers, virtual)
        computed = info.ticks - (schedule == "interleaved")
        res = {"ticks": info.ticks, "bubble_fraction": info.bubble_fraction}
        for dtype, (model, p, t, loss_rtol, grad_tol) in runs.items():
            held = {}
            dq, dkv = attention.launches_dq, attention.launches_dkv
            t0 = time.perf_counter()
            with _held_to_plain(torch, attention, f"moe {tag} {dtype}",
                                held):
                got = _moe_run(torch, model, p, t, **pipe)
            wall = time.perf_counter() - t0
            # B2 and B3 launch once a layer of every computed tick of every
            # stage (the backward runs every tick, as across ranks).
            n = computed * model.n_layers // virtual
            if (attention.launches_dq - dq, attention.launches_dkv - dkv) \
                    != (n, n):
                raise AssertionError(f"moe {tag} {dtype}: B2/B3 launched "
                                     f"{attention.launches_dq - dq} / "
                                     f"{attention.launches_dkv - dkv} "
                                     f"times, not {n} each")
            res[dtype] = {"b2_launches": n, "launches_vs_plain": held,
                          "wall_s_with_checks": wall,
                          "vs_microbatches": _check_moe_pipeline(
                              f"{tag} {dtype}", got, refs[dtype], loss_rtol,
                              grad_tol)}
            log(f"moe {tag} {dtype}: each launch against its plain "
                f"version: {json.dumps(held)}: ok")
            del got
        schedules[tag] = res
    torch.cuda.synchronize()
    pp_launches = _launches(attention, norms)
    del params, refs, runs
    torch.cuda.empty_cache()

    mesh_cfg = TransformerConfig(dtype="float32", remat=True,
                                 remat_policy="dots", **MOE_PARITY)
    batches = [torch.as_tensor(rng.integers(
        0, mesh_cfg.vocab_size, (PARITY_TRAIN_BATCH, mesh_cfg.max_seq + 1)),
        device="cuda") for _ in range(DP_PARITY_STEPS)]
    mesh_refs = {"remat=True/dots": (mesh_cfg, batches, _tp_parity_run(
        torch, mesh_cfg, parity_params(torch, mesh_cfg, seed,
                                       MOE_PARITY_SKEW), batches, None))}
    meshes = {"tp": (dict(tp=1), {}), "sp": (dict(sp=1), {}),
              "pp": (dict(pp=1), {}),
              "pp_pipeline": (dict(pp=1), dict(pipeline_microbatches=1))}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=timedelta(seconds=DP_TIMEOUT_S))
    checked = {}
    try:
        built = {tag: build_mesh(MeshSpec(**axes), "cuda",
                                 timeout_s=DP_TIMEOUT_S)
                 for tag, (axes, _) in meshes.items()}
        _reset_launches(attention, norms)
        for tag, (_, trunk) in meshes.items():
            checked[tag] = _check_mesh_parity(
                torch, f"moe {tag}", mesh_refs, built[tag], seed,
                skew=MOE_PARITY_SKEW, **trunk)
        torch.cuda.synchronize()
        mesh_launches = _launches(attention, norms)
    finally:
        dist.destroy_process_group()
    for path, launches in (("moe_pp", pp_launches),
                           ("moe_mesh", mesh_launches)):
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"{path} path")
    res = {"schedules": schedules, "microbatches": MOE_PP_MICROBATCHES,
           "mesh_parity": checked, "pp_launches": pp_launches,
           "mesh_launches": mesh_launches,
           "phase_wall_s": time.perf_counter() - t_phase}
    log("moe mesh: " + json.dumps(res))
    return res


def moe_decode_ms(torch, session, prompt) -> dict:
    """The ms per decode step of ``session.generate`` on ``prompt``: the
    wall difference of MOE_DECODE_LENGTHS new tokens over their
    difference (the best of two calls each, after a warm-up)."""
    session.generate(prompt, 8)
    walls = {}
    for n in MOE_DECODE_LENGTHS:
        best = float("inf")
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = session.generate(prompt, n)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        if tuple(out.shape) != (prompt.shape[0], n):
            raise AssertionError(f"moe generate shape {tuple(out.shape)}")
        walls[n] = best * 1e3
    short, long = MOE_DECODE_LENGTHS
    return {"wall_ms": walls,
            "ms_per_token": (walls[long] - walls[short]) / (long - short)}


def moe_serve_phase(torch, attention, norms, seed: int) -> dict:
    """DecodeSession.generate at bench_moe_decode's three points
    (MOE_DECODE_POINTS, bf16; ms per step by differencing two lengths).
    Then a ServingEngine on bench_moe's trunk (bf16, no remat) answers
    MOE_SERVE_REQUESTS concurrent POSTs (serve_phase). The launch
    counters are set to 0 before the bf16 generate and read after the
    engine, so they count this path alone: B1 (prefill) and B4 must have
    launched. Then the checks, outside that window: in fp32, routed and
    dense give equal tokens at E 4 and E 16, and the engine equals
    generate token for token on bench_moe's trunk (parity_phase)."""
    from tony_tpu_torch.models import (DecodeSession, TransformerConfig,
                                       init_params)

    rng = np.random.default_rng(seed + 7)
    prompt = torch.as_tensor(rng.integers(
        0, MOE_DECODE["vocab_size"], (MOE_DECODE_BATCH, MOE_DECODE_PROMPT)),
        device="cuda")
    _reset_launches(attention, norms)
    points, tokens = {}, {}
    for n_experts, mode in MOE_DECODE_POINTS:
        cfg = TransformerConfig(dtype="bfloat16", n_experts=n_experts,
                                moe_decode_mode=mode, **MOE_DECODE)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        session = DecodeSession(init_params(cfg, gen, "cuda"), cfg,
                                device="cuda")
        points[f"E{n_experts}_{mode}"] = moe_decode_ms(torch, session,
                                                       prompt)
        del session
    cfg = TransformerConfig(dtype="bfloat16", **{**BENCH_MOE,
                                                 "remat": False})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, "cuda")
    session = DecodeSession(params, cfg, device="cuda")
    bodies = make_requests(cfg, session, seed, MOE_SERVE_REQUESTS)
    serve = serve_phase(cfg, session, seed, bodies)
    launches = _launches(attention, norms)
    for name in ("rms_norm", "flash_fwd"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the MoE "
                                 f"serving path")
    del session
    torch.cuda.empty_cache()
    for n_experts in (4, 16):
        fp32 = TransformerConfig(dtype="float32", n_experts=n_experts,
                                 **MOE_DECODE)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        weights = init_params(fp32, gen, "cuda")
        for mode in ("routed", "dense"):
            session = DecodeSession(weights, dataclasses.replace(
                fp32, moe_decode_mode=mode), device="cuda")
            tokens[mode] = session.generate(prompt, 32).cpu().numpy()
        if not np.array_equal(tokens["routed"], tokens["dense"]):
            raise AssertionError(f"moe decode: routed and dense tokens "
                                 f"differ at E {n_experts} (fp32)")
        log(f"moe decode fp32 E {n_experts}: routed == dense, "
            f"{tokens['dense'].size} tokens")
    del session, weights
    parity = parity_phase(torch, params, seed,
                          {**BENCH_MOE, "remat": False}, "moe parity")
    res = {"decode": points, "serve": serve, "parity": parity,
           "launches": launches}
    log("moe serve: " + json.dumps(res))
    log("moe decode ms per token, batch 8, prompt 16: " + ", ".join(
        f"{k} {v['ms_per_token']:.4f}" for k, v in points.items())
        + f", on {card_line()}")
    return res


# ---------------------------------------------------------------------------
# Slice 6's paths: the image classifiers, the MNIST job, and the step anatomy
# ---------------------------------------------------------------------------

# bench.py's bench_mnist: the CNN in bf16, batch 512, 50 steps a call, lr
# 1e-3, a distinct batch every step.
MNIST_BATCH = 512
MNIST_PER_CALL = 50
MNIST_WINDOWS = 3
# bench.py's bench_resnet50: depth 50, width 64, 1000 classes, bf16, batch
# 32 of 224 x 224 x 3; warm-ups, then the best of RESNET_WINDOWS windows of
# RESNET_STEPS steps.
RESNET50 = dict(depth=50, width=64, n_classes=1000, dtype="bfloat16")
RESNET_BATCH = 32
RESNET_SIZE = 224
RESNET_WARMUP = 3
RESNET_STEPS = 10
RESNET_WINDOWS = 2
# fp32 (TF32 off) card against the CPU on the same converted weights:
# CLASSIFIER_PARITY_STEPS steps on one batch. Losses within
# CLASSIFIER_LOSS_RTOL, the first step's gradients within
# CLASSIFIER_GRAD_TOL of each leaf's largest (cuDNN and the CPU's
# convolutions sum in other orders).
CLASSIFIER_PARITY = {
    "mnist_cnn": ("mnist", dict(arch="cnn", dtype="float32"), (16, 28, 28, 1)),
    "resnet18_w16": ("resnet", dict(depth=18, width=16, n_classes=10,
                                    dtype="float32"), (8, 64, 64, 3)),
}
CLASSIFIER_PARITY_STEPS = 5
CLASSIFIER_LOSS_RTOL = 1e-4
CLASSIFIER_GRAD_TOL = 1e-4
# The uint8 decode against prescaled float images: ResNet-50 in fp32 at
# batch 2, logits within rtol and atol 1e-4 (the JAX package's bound).
UINT8_TOL = 1e-4
# The MNIST job: one --framework pytorch worker through the orchestrator.
MNIST_JOB_STEPS = (30, 50)
MNIST_JOB_TIMEOUT_S = 300
# The anatomy phase: ANATOMY_STEPS fenced steps a window, windows in turns
# plain, instrumented, instrumented, plain; the instrumented wall must be
# within ANATOMY_NOISE of the plain one (or twice the windows' spread).
ANATOMY_WARMUP = 2
ANATOMY_STEPS = 10
ANATOMY_NOISE = 0.01
ANATOMY_CLASSIFIER_STEPS = 4


def _fresh_registry():
    """A new process-wide metrics registry, so a phase reads only the
    gauges of the steps it builds next."""
    from tony_tpu_torch.observability import metrics

    metrics._default_registry = metrics.MetricsRegistry()
    return metrics._default_registry


def _best_window(torch, fn, windows: int, calls: int) -> float:
    """The best wall seconds of ``windows`` windows of ``calls`` calls of
    fn(), each window fenced by a synchronize."""
    best = float("inf")
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def _classifier_grads(torch, apply_fn, params, images, labels) -> list:
    from tony_tpu_torch.models.train import leaves
    from tony_tpu_torch.ops import softmax_cross_entropy

    lv = [t.detach().clone().requires_grad_() for t in leaves(params)]
    it = iter(lv)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [rebuild(v) for v in tree]
        return next(it)

    p = rebuild(params)
    loss = softmax_cross_entropy(apply_fn(p, images), labels)
    return [g.cpu() for g in torch.autograd.grad(loss, lv)]


def classifier_parity(torch, seed: int) -> dict:
    """fp32, TF32 off: the MNIST CNN and a ResNet-18 (width 16, 64 x 64)
    from the same CPU-made weights, CLASSIFIER_PARITY_STEPS steps on one
    batch on the card and on the CPU (the plain path the CPU tests pin to
    the JAX package): the losses agree within CLASSIFIER_LOSS_RTOL and
    fall, the first step's gradients within CLASSIFIER_GRAD_TOL of each
    leaf's largest."""
    from tony_tpu_torch.models import (MnistConfig, ResNetConfig,
                                       make_image_classifier_step,
                                       mnist_apply, mnist_init, resnet_apply,
                                       resnet_init)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, (kind, kw, shape) in CLASSIFIER_PARITY.items():
        if kind == "mnist":
            cfg = MnistConfig(**kw)
            params = mnist_init(cfg, torch.Generator().manual_seed(seed),
                                "cpu")
            apply_fn = lambda p, x, cfg=cfg: mnist_apply(p, x, cfg)
        else:
            cfg = ResNetConfig(**kw)
            params = resnet_init(cfg, torch.Generator().manual_seed(seed),
                                 "cpu")
            apply_fn = lambda p, x, cfg=cfg: resnet_apply(p, x, cfg)
        rng = np.random.default_rng(seed + 11)
        images = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
        labels = torch.as_tensor(rng.integers(0, 10, shape[:1]))
        losses, grads = {}, {}
        for dev in ("cuda", "cpu"):
            init_fn, step_fn = make_image_classifier_step(
                None, apply_fn, device=dev, learning_rate=1e-3)
            state = init_fn(params=params)
            x, y = images.to(dev), labels.to(dev)
            grads[dev] = _classifier_grads(torch, apply_fn, state.params, x,
                                           y)
            run = []
            for _ in range(CLASSIFIER_PARITY_STEPS):
                state, metrics = step_fn(state, x, y)
                run.append(metrics["loss"])
            losses[dev] = _loss_list(torch, run)
        if not np.allclose(losses["cuda"], losses["cpu"],
                           rtol=CLASSIFIER_LOSS_RTOL, atol=0):
            raise AssertionError(f"classifier parity {name}: losses card "
                                 f"{losses['cuda']} vs cpu {losses['cpu']}")
        for dev in ("cuda", "cpu"):
            if not losses[dev][-1] < losses[dev][0]:
                raise AssertionError(f"classifier parity {name}: the {dev} "
                                     f"loss did not fall {losses[dev]}")
        worst = 0.0
        for i, (a, b) in enumerate(zip(grads["cuda"], grads["cpu"])):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            if not err <= CLASSIFIER_GRAD_TOL * scale:
                raise AssertionError(
                    f"classifier parity {name}: gradient leaf {i} err {err} "
                    f"> {CLASSIFIER_GRAD_TOL} * {scale}")
            worst = max(worst, err / scale if scale else err)
        out[name] = {"losses_cuda": losses["cuda"],
                     "losses_cpu": losses["cpu"],
                     "worst_grad_rel_err": worst}
        log(f"classifier parity fp32 {name}: losses card {losses['cuda']} / "
            f"cpu {losses['cpu']}, worst gradient err {worst:.3g} of the "
            f"leaf max: ok")
    return out


def classifier_phase(torch, attention, norms, seed: int) -> dict:
    """The image classifiers at bench.py's widths, on the card. The launch
    counters are set to 0 just before the timed MNIST and ResNet-50 runs
    and read just after: this path runs none of B1-B4 (convolutions are
    cuDNN's, GroupNorm and the rest plain PyTorch, as the JAX package
    runs them outside any Pallas kernel), so every count must be 0.

    MNIST: the CNN in bf16 through make_classifier_step(steps_per_call=50)
    on 50 distinct batches of 512 a call, steps/s from the best of
    MNIST_WINDOWS one-call windows after a warm-up call. ResNet-50: batch
    32 x 224 x 224 x 3, bf16, from float images and from uint8 images
    (decoded in the step), images/s and step ms from the best of
    RESNET_WINDOWS windows of RESNET_STEPS steps after RESNET_WARMUP,
    peak memory, one profiled step's device time and busy share. Then the
    uint8 decode against prescaled float images in fp32 (UINT8_TOL), and
    classifier_parity."""
    from tony_tpu_torch.models import (MnistConfig, ResNetConfig,
                                       make_classifier_step,
                                       make_image_classifier_step,
                                       resnet_apply, resnet_init)

    rng = np.random.default_rng(seed + 7)
    _reset_launches(attention, norms)
    init_fn, step_fn = make_classifier_step(
        MnistConfig(arch="cnn", dtype="bfloat16"), device="cuda",
        learning_rate=1e-3, steps_per_call=MNIST_PER_CALL)
    state = init_fn(seed)
    images = torch.as_tensor(rng.normal(
        size=(MNIST_PER_CALL, MNIST_BATCH, 28, 28, 1)).astype(np.float32),
        device="cuda")
    labels = torch.as_tensor(rng.integers(
        0, 10, (MNIST_PER_CALL, MNIST_BATCH)), device="cuda")
    losses = []

    def mnist_call():
        nonlocal state
        state, metrics = step_fn(state, images, labels)
        losses.append(metrics["loss"])

    mnist_call()
    dt = _best_window(torch, mnist_call, MNIST_WINDOWS, 1)
    mnist = {"batch": MNIST_BATCH, "steps_per_call": MNIST_PER_CALL,
             "steps_per_s": MNIST_PER_CALL / dt,
             "losses": _loss_list(torch, losses)}
    if not all(np.isfinite(mnist["losses"])):
        raise AssertionError(f"mnist: non-finite loss {mnist['losses']}")
    log("classifier mnist: " + json.dumps(mnist))
    del state, images, labels

    cfg = ResNetConfig(**RESNET50)
    init_fn, step_fn = make_image_classifier_step(
        lambda gen: resnet_init(cfg, gen, "cuda"),
        lambda p, x: resnet_apply(p, x, cfg), device="cuda",
        learning_rate=1e-3, config=cfg)
    shape = (RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3)
    inputs = {
        "float": torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                 device="cuda"),
        "uint8": torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8),
                                 device="cuda")}
    labels = torch.as_tensor(rng.integers(0, 1000, (RESNET_BATCH,)),
                             device="cuda")
    resnet = {"batch": RESNET_BATCH, "image_size": RESNET_SIZE}
    for kind, x in inputs.items():
        state = init_fn(seed)
        losses = []

        def resnet_step():
            nonlocal state
            state, metrics = step_fn(state, x, labels)
            losses.append(metrics["loss"])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(RESNET_WARMUP):
            resnet_step()
        dt = _best_window(torch, resnet_step, RESNET_WINDOWS, RESNET_STEPS)
        events, wall_ms = device_events(torch, resnet_step)
        device_total = sum(us for _, us in events) / 1e3
        run = {"images_per_s": RESNET_BATCH * RESNET_STEPS / dt,
               "step_ms": dt / RESNET_STEPS * 1e3,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "profiled_step": {"wall_ms": wall_ms,
                                 "device_ms": device_total,
                                 "device_busy_share": device_total / wall_ms},
               "losses": _loss_list(torch, losses)}
        if not all(np.isfinite(run["losses"])):
            raise AssertionError(f"resnet50 {kind}: non-finite loss "
                                 f"{run['losses']}")
        resnet[kind] = run
        log(f"classifier resnet50 from {kind} images: " + json.dumps(run))
        del state
    launches = _launches(attention, norms)
    log(f"launches on the classifier path: {launches}")
    check_path_launches({"classifier": launches})
    del inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fp32 = ResNetConfig(**dict(RESNET50, dtype="float32"))
    params = resnet_init(fp32, torch.Generator(device="cuda").manual_seed(seed),
                         "cuda")
    raw = torch.as_tensor(rng.integers(0, 256, (2, RESNET_SIZE, RESNET_SIZE,
                                                3), dtype=np.uint8),
                          device="cuda")
    with torch.no_grad():
        u8 = resnet_apply(params, raw, fp32)
        f32 = resnet_apply(params, raw.float() / 255.0, fp32)
    err = (u8 - f32).abs().max().item()
    if not torch.allclose(u8, f32, rtol=UINT8_TOL, atol=UINT8_TOL):
        raise AssertionError(f"uint8 decode: logits differ from prescaled "
                             f"float images by {err}")
    log(f"classifier uint8 decode (ResNet-50 fp32): max |logit diff| "
        f"{err:.3g} <= {UINT8_TOL} + {UINT8_TOL} |logit|: ok")
    del params
    return {"mnist": mnist, "resnet50": resnet, "uint8_max_abs_err": err,
            "parity": classifier_parity(torch, seed), "launches": launches}


def mnist_job_phase(root: Path) -> dict:
    """tony_tpu_torch/mnist_distributed.py as one --framework pytorch
    worker on the card, submitted through the orchestrator's local
    submitter (in its own process group, killed with its children if it
    overruns): MNIST_JOB_STEPS[0] steps with a checkpoint dir, then a
    rerun to MNIST_JOB_STEPS[1] that resumes from the first run's last
    step. The chief's mnist_metrics.json must hold a finite loss."""
    import os
    import signal

    repo = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(repo), *filter(None, [env.get("PYTHONPATH")])])
    ck = root / "mnist-ck"
    runs = {}
    for i, steps in enumerate(MNIST_JOB_STEPS):
        out = root / f"mnist-{i}.out"
        flags = ["--device", "cuda", "--steps", str(steps),
                 "--checkpoint_dir", str(ck), "--working_dir", str(root),
                 f"> {out} 2>&1"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "tony_tpu.client.cli", "local",
             "--executes", str(repo / "tony_tpu_torch" /
                               "mnist_distributed.py"),
             "--framework", "pytorch", "--python_binary_path",
             sys.executable, "--conf", "tony.worker.instances=1",
             "--conf", "tony.ps.instances=0",
             "--task_params", " ".join(flags)],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        try:
            log_text, _ = proc.communicate(timeout=MNIST_JOB_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        script_out = out.read_text() if out.exists() else ""
        log(f"mnist job {i} (--steps {steps}):\n{script_out.rstrip()}")
        if proc.returncode != 0:
            raise AssertionError(f"mnist job {i} exited {proc.returncode}:\n"
                                 f"{log_text[-3000:]}")
        metrics = json.loads((root / "mnist_metrics.json").read_text())
        if metrics["steps"] != steps or not np.isfinite(
                metrics["final_loss"]):
            raise AssertionError(f"mnist job {i}: metrics {metrics}")
        if i and f"resumed from checkpoint step {MNIST_JOB_STEPS[0]}" \
                not in script_out:
            raise AssertionError("mnist job 1 did not resume from job 0's "
                                 "checkpoint")
        runs[f"run{i}"] = {"metrics": metrics,
                           "command_s": time.perf_counter() - t0}
    log("mnist job: " + json.dumps(runs))
    return runs


def _anatomy(gauges: dict) -> dict:
    from tony_tpu_torch.observability import stepstats

    phases = {p: gauges[f'{stepstats.STEP_PHASE_GAUGE}{{phase="{p}"}}']
              for p in stepstats.PHASES}
    wall = gauges["step_time_ms"]
    if abs(sum(phases.values()) - wall) > 5e-3 * len(phases):
        raise AssertionError(f"anatomy: phases {phases} do not sum to the "
                             f"step wall {wall} ms")
    return {"phases_ms": phases, "wall_ms": wall,
            "host_share": phases["host"] / wall}


def anatomy_phase(torch, attention, norms, seed: int) -> dict:
    """The step anatomy on the card. The LM step at bench_transformer's
    widths (bf16, batch [8, 2049]) through make_train_step, whose step is
    instrumented: after ANATOMY_WARMUP steps, windows of ANATOMY_STEPS
    steps, each fenced by its loss readback as a train loop is, in turns:
    the plain step (step_fn.__wrapped__), the instrumented, the
    instrumented, the plain. The instrumented step's gauges: the five
    tony_step_phase_ms phases sum to its step_time_ms, which is the
    window's wall per step within 5 %; tony_mfu is published against the
    card's PEAK_FLOPS entry (989e12 for the H100 SXM); and the
    instrumented wall is within ANATOMY_NOISE (or twice the spread of the
    windows) of the plain one: the hook adds no synchronize. The heap is
    collected before the windows; each step's wall, the collector's
    pauses and the calibration record's time are logged. The launch
    counters are set to 0 before the windows and read after: B1-B4 must
    each launch. Then the MNIST CNN's step (bf16, batch 512) publishes its
    phases and no tony_mfu."""
    from tony_tpu_torch.models import (MnistConfig, TransformerConfig,
                                       make_classifier_step, make_train_step)
    from tony_tpu_torch.observability import stepstats

    registry = _fresh_registry()
    cfg = TransformerConfig(dtype="bfloat16", **BENCH_TRANSFORMER)
    init_fn, step_fn = make_train_step(cfg, device="cuda")
    state = init_fn(seed)
    rng = np.random.default_rng(seed + 3)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)),
        device="cuda")
    plain = step_fn.__wrapped__
    stats = step_fn.stepstats
    # Diagnostics, logged: every step's wall, the collector's pauses and
    # the calibration record's time, each by the step it fell in.
    steps: dict[str, list[float]] = {}
    pauses: list[list] = []
    records: list[list] = []
    where = {"step": "warm-up", "gc_t0": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            where["gc_t0"] = time.perf_counter()
        else:
            ms = (time.perf_counter() - where["gc_t0"]) * 1e3
            if ms > 0.5:
                pauses.append([where["step"], info["generation"],
                               round(ms, 3)])

    maybe_record = stats._maybe_record

    def timed_record():
        t0 = time.perf_counter()
        maybe_record()
        records.append([where["step"], round(
            (time.perf_counter() - t0) * 1e3, 3)])

    stats._maybe_record = timed_record

    def window(fn, name: str) -> float:
        nonlocal state
        walls_ms = steps.setdefault(name, [])
        t0 = time.perf_counter()
        for i in range(ANATOMY_STEPS):
            where["step"] = f"{name}[{i}]"
            t1 = time.perf_counter()
            state, metrics = fn(state, tokens)
            float(metrics["loss"])
            walls_ms.append(round((time.perf_counter() - t1) * 1e3, 3))
        return (time.perf_counter() - t0) / ANATOMY_STEPS * 1e3

    for _ in range(ANATOMY_WARMUP):
        state, metrics = step_fn(state, tokens)
        float(metrics["loss"])
    # The earlier phases leave a large heap: a full collection of it (370
    # ms in one run) must not land in a window, where it is no cost of the
    # hook. Collected here, no full collection falls due in 40 steps.
    t0 = time.perf_counter()
    gc.collect()
    heap = {"collect_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "objects": len(gc.get_objects()),
            "threads": sorted(t.name for t in threading.enumerate())}
    _reset_launches(attention, norms)
    gc.callbacks.append(on_gc)
    try:
        walls = {"plain": [window(plain, "plain0")]}
        walls["instrumented"] = [window(step_fn, "instrumented0"),
                                 window(step_fn, "instrumented1")]
        gauges = registry.snapshot()["gauges"]
        walls["plain"].append(window(plain, "plain1"))
    finally:
        gc.callbacks.remove(on_gc)
        stats._maybe_record = maybe_record
    log("anatomy lm steps: " + json.dumps(
        {"step_ms": steps, "heap_before": heap, "gc_pauses_ms": pauses,
         "calibration_ms": [r for r in records if r[1] > 0.05]}))
    launches = _launches(attention, norms)
    check_path_launches({"anatomy": launches})
    lm = _anatomy(gauges)
    name = torch.cuda.get_device_name(0)
    peak = stepstats.PEAK_FLOPS.get(name, 0.0)
    if not peak or stats._peak_flops != peak:
        raise AssertionError(f"anatomy: no peak for {name!r} (the step took "
                             f"{stats._peak_flops})")
    flops = gauges[stepstats.MODEL_FLOPS_GAUGE]
    mfu = gauges.get(stepstats.MFU_GAUGE)
    want = flops / (lm["wall_ms"] / 1e3 * peak)
    if mfu is None or abs(mfu - want) > 1e-5 + 1e-3 * want:
        raise AssertionError(f"anatomy: tony_mfu {mfu}, want {want}")
    per_step = walls["instrumented"][-1]
    if abs(lm["wall_ms"] - per_step) > 0.05 * per_step:
        raise AssertionError(f"anatomy: step_time_ms {lm['wall_ms']} is not "
                             f"the window's {per_step} ms a step")
    plain_ms = float(np.mean(walls["plain"]))
    inst_ms = float(np.mean(walls["instrumented"]))
    spread = max(np.ptp(walls["plain"]), np.ptp(walls["instrumented"]))
    allowed = max(ANATOMY_NOISE * plain_ms, 2 * spread)
    if abs(inst_ms - plain_ms) > allowed:
        raise AssertionError(f"anatomy: instrumented {walls['instrumented']}"
                             f" vs plain {walls['plain']} ms a step "
                             f"(allowed {allowed:.3f})")
    lm.update(mfu=mfu, model_flops_per_step=flops, peak_flops=peak,
              window_ms=walls, launches=launches,
              launches_per_step={k: v / (4 * ANATOMY_STEPS)
                                 for k, v in launches.items()})
    log("anatomy lm: " + json.dumps(lm))
    del state, init_fn, step_fn, plain

    registry = _fresh_registry()
    init_fn, step_fn = make_classifier_step(
        MnistConfig(arch="cnn", dtype="bfloat16"), device="cuda")
    state = init_fn(seed)
    x = torch.as_tensor(rng.normal(size=(MNIST_BATCH, 28, 28, 1)).astype(
        np.float32), device="cuda")
    y = torch.as_tensor(rng.integers(0, 10, (MNIST_BATCH,)), device="cuda")
    for _ in range(ANATOMY_CLASSIFIER_STEPS):
        state, metrics = step_fn(state, x, y)
        float(metrics["loss"])
    gauges = registry.snapshot()["gauges"]
    if stepstats.MFU_GAUGE in gauges or \
            stepstats.MODEL_FLOPS_GAUGE in gauges:
        raise AssertionError(f"anatomy: the classifier step published an "
                             f"MFU: {gauges}")
    classifier = _anatomy(gauges)
    log("anatomy classifier: " + json.dumps(classifier))
    _fresh_registry()
    return {"lm": lm, "classifier": classifier}


# ---------------------------------------------------------------------------
# Phase 17: the compile, plan and tune plane
# ---------------------------------------------------------------------------

# tune_flash_blocks' shapes (causal, bf16): the training shape, the hd128
# shape and the generate prefill's, where a 192-row block leaves a third of
# its rows idle.
TUNE_FLASH_SHAPES = {
    "train": dict(b=8, t=2048, h=16, h_kv=16, d=64),
    "hd128": dict(b=8, t=2048, h=8, h_kv=8, d=128),
    "prefill": dict(b=8, t=128, h=16, h_kv=4, d=64),
}
TUNE_ITERS, TUNE_WINDOWS = 10, 5
# Steps of the train step built from the tune record, under StepStats'
# calibration, and of the train step run under the strict sanitizer.
TUNE_CALIBRATE_STEPS = 10
SANITIZER_TRAIN_STEPS = 5
# The plan of one device, the train phase's (the measurement table's key).
ONE_DEVICE_PLAN = "dp1.pp1.ep1.sp1.tp1"

# Run as its own process, twice on one compile-cache dir: the first calls
# of make_train_step's init and step at bench_transformer's width, with
# the compile-cache counters and tony_compile_ms they leave.
FIRST_CALL_SCRIPT = """
import json, sys
import numpy as np, torch
from tony_tpu_torch import runtime
from tony_tpu_torch.models import TransformerConfig, make_train_step
from tony_tpu_torch.observability import default_registry
runtime.initialize(device="cuda")
cfg = TransformerConfig(dtype="bfloat16", **json.loads(sys.argv[1]))
init_fn, step_fn = make_train_step(cfg, device="cuda")
state = init_fn(0)
tokens = torch.as_tensor(np.random.default_rng(0).integers(
    0, cfg.vocab_size, (8, 2049)), device="cuda")
state, metrics = step_fn(state, tokens)
float(metrics["loss"])
snap = default_registry().snapshot()
print(json.dumps({
    "hits": snap["counters"].get("tony_compile_cache_hits_total", 0),
    "misses": snap["counters"].get("tony_compile_cache_misses_total", 0),
    "compile_ms": snap["histograms"].get("tony_compile_ms")}))
"""


def tune_phase(torch, attention, norms, seed: int) -> dict:
    """The autotuner on the card, its records under a temporary compile
    cache. The launch counters are set to 0 just before and read just
    after (the tune path):

    * ``tune_flash_blocks`` at every TUNE_FLASH_SHAPES shape: each of
      ``flash_block_candidates``' points warmed, then timed, forward and
      backward through ``flash_attention``;
    * ``tune_train_step`` on bench_transformer's step at 8 x 2048 tokens
      over the train-step knobs and the tile points at head_dim 64;
    * ``make_train_step`` built from that record (a lookup hit): the tuned
      blocks pinned and the ones its calls take, B1-B3 launched by its
      steps; TUNE_CALIBRATE_STEPS steps under StepStats' calibration write
      the measurement table's entry and ``tony_plan_residual``.
    """
    from tony_tpu_torch import kernels
    from tony_tpu_torch.models import TransformerConfig, make_train_step
    from tony_tpu_torch.parallel import autotune
    from tony_tpu_torch.parallel import plan as plan_lib

    cfg = TransformerConfig(dtype="bfloat16", **BENCH_TRANSFORMER)
    build_dir, active = kernels.BUILD_DIR, plan_lib.active_cache_dir()
    res: dict = {}
    with tempfile.TemporaryDirectory(prefix="tony-tune-") as tmp:
        try:
            plan_lib.configure_compile_cache(tmp)
            reg = _fresh_registry()
            _reset_launches(attention, norms)
            flash = {}
            for name, s in TUNE_FLASH_SHAPES.items():
                rec = autotune.tune_flash_blocks(
                    s["t"], s["b"] * s["h"], s["d"], heads=s["h"],
                    kv_heads=s["h_kv"], iters=TUNE_ITERS,
                    windows=TUNE_WINDOWS, force=True)
                failed = [t for t in rec["trials"] if "error" in t]
                if failed or len(rec["trials"]) != len(
                        autotune.flash_block_candidates(s["d"])):
                    raise AssertionError(f"tune_flash_blocks {name}: "
                                         f"{rec['trials']}")
                flash[name] = {k: rec[k] for k in ("best", "best_ms",
                                                   "default_ms", "trials",
                                                   "search_ms")}
                log(f"tune_flash_blocks {name} {json.dumps(s)}: "
                    f"{json.dumps(flash[name])}")
            candidates = (autotune.train_knob_candidates(cfg)
                          + autotune.flash_block_candidates(cfg.head_dim)[1:])
            rec = autotune.tune_train_step(
                cfg, None, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                candidates=candidates, trial_budget=len(candidates),
                force=True)
            if any("error" in t for t in rec["trials"]):
                raise AssertionError(f"tune_train_step: {rec['trials']}")
            winner = autotune.knobs_from_dict(rec["best"])
            train = {k: rec[k] for k in ("best", "best_ms", "default_ms",
                                         "trials", "search_ms")}
            log(f"tune_train_step bench_transformer [8, 2049]: "
                f"{json.dumps(train)}")

            # make_train_step from the record.
            hits = reg.counter(autotune.TUNE_RECORD_HITS_COUNTER)
            hits0 = hits.value
            init_fn, step_fn = make_train_step(cfg, device="cuda")
            if hits.value != hits0 + 1:
                raise AssertionError("make_train_step did not find the "
                                     "tune record")
            pinned = attention.tuned_blocks()
            taken = attention._default_blocks(cfg.head_dim, None, None)
            if pinned != (winner.block_q, winner.block_k) or taken != pinned:
                raise AssertionError(f"tuned blocks {pinned}, taken {taken}, "
                                     f"record's winner {winner}")
            state = init_fn(seed)
            tokens = torch.as_tensor(np.random.default_rng(seed + 3).integers(
                0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)),
                device="cuda")
            before = _launches(attention, norms)
            for _ in range(TUNE_CALIBRATE_STEPS):
                state, metrics = step_fn(state, tokens)
                float(metrics["loss"])  # the train loop's readback
            step_launches = {k: n - before[k]
                             for k, n in _launches(attention, norms).items()}
            if not all(step_launches.values()):
                raise AssertionError(f"the step built from the record "
                                     f"launched {step_launches}")
            stats = step_fn.stepstats
            table = plan_lib.load_measurements()
            entry = {b: row for b, row in table.items()
                     if ONE_DEVICE_PLAN in row}
            gauges = reg.snapshot()["gauges"]
            residual = gauges.get(
                f'tony_plan_residual{{plan="{ONE_DEVICE_PLAN}"}}')
            if len(entry) != 1 or residual is None:
                raise AssertionError(f"calibration wrote {table} and "
                                     f"residual {residual}")
            (bucket, row), = entry.items()
            # The entry is the best wall when it was written (after three
            # steps, then once a window for a real improvement).
            if row[ONE_DEVICE_PLAN] != round(stats._recorded_ms, 3):
                raise AssertionError(f"measured {row} against the recorded "
                                     f"wall {stats._recorded_ms}")
            live = autotune.load_record(rec["key"]).get("live_best_ms")
            attention.clear_tuned_blocks()
            launches = _launches(attention, norms)
            check_path_launches({"tune": launches})
            res = {"flash": flash, "train": train,
                   "winner": winner.describe(),
                   "step_launches": step_launches,
                   "measurement": {bucket: row}, "residual": residual,
                   "recorded_ms": stats._recorded_ms,
                   "best_wall_ms": stats._best_wall_ms, "live_best_ms": live,
                   "launches": launches}
            log(f"tune phase: {json.dumps(res)}")
        finally:
            attention.clear_tuned_blocks()
            plan_lib.configure_compile_cache(active,
                                             enabled=active is not None)
            kernels.BUILD_DIR = build_dir
    return res


def sanitizer_phase(torch, attention, seed: int) -> dict:
    """The jit sanitizer armed strict (TONY_JIT_SANITIZER=strict) over the
    serve phase's 12 requests through a ServingEngine on the flagship model
    (the engine's own loop thread; no HTTP server) and over
    SANITIZER_TRAIN_STEPS bench_transformer train steps: both must show no
    guarded transfer and no retrace. Then the control: an ``.item()``
    inside a step region must raise and be counted."""
    import os

    from tony_tpu_torch.analysis import jit_sanitizer
    from tony_tpu_torch.models import (DecodeSession, TransformerConfig,
                                       init_params, make_train_step)
    from tony_tpu_torch.serving import ServingEngine

    prev = os.environ.get(jit_sanitizer.ENV_FLAG)
    os.environ[jit_sanitizer.ENV_FLAG] = "strict"
    tracker = jit_sanitizer.tracker()
    tracker.reset()
    reg = _fresh_registry()
    res: dict = {}
    try:
        cfg = TransformerConfig(dtype="bfloat16", **FLAGSHIP)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        params = init_params(cfg, gen, device="cuda")
        session = DecodeSession(params, cfg, device="cuda")
        bodies = make_requests(cfg, session, seed, N_REQUESTS)
        with ServingEngine(params, cfg, device="cuda") as engine:
            reqs = [engine.submit(np.asarray(b["prompt"], np.int32),
                                  b["max_new_tokens"],
                                  eos_id=b.get("eos_id")) for b in bodies]
            tokens_out = sum(r.result(timeout=600)["length"] for r in reqs)
        res["serve"] = {"requests": len(reqs), "tokens": tokens_out,
                        "keys": tracker.report()["keys"],
                        "retraces": tracker.retraces(),
                        "transfers": tracker.transfers()}
        del session, params
        torch.cuda.empty_cache()
        tcfg = TransformerConfig(dtype="bfloat16", **BENCH_TRANSFORMER)
        init_fn, step_fn = make_train_step(tcfg, device="cuda")
        state = init_fn(seed)
        tokens = torch.as_tensor(np.random.default_rng(seed + 3).integers(
            0, tcfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)), device="cuda")
        for _ in range(SANITIZER_TRAIN_STEPS):
            state, metrics = step_fn(state, tokens)
            float(metrics["loss"])  # the loop's readback, outside a region
        res["train"] = {"steps": SANITIZER_TRAIN_STEPS,
                        "keys": tracker.report()["keys"],
                        "retraces": tracker.retraces(),
                        "transfers": tracker.transfers()}
        counters = reg.snapshot()["counters"]
        for name in (jit_sanitizer.RETRACES_COUNTER,
                     jit_sanitizer.GUARDED_TRANSFERS_COUNTER):
            if counters.get(name, 0):
                raise AssertionError(f"{name} = {counters[name]} on the "
                                     f"serving and train paths")
        if tracker.retraces() or tracker.transfers() or len(
                res["train"]["keys"]) < 4:
            raise AssertionError(f"jit sanitizer on the serving and train "
                                 f"paths: {json.dumps(res)} "
                                 f"{tracker.violations()}")
        # The control: a readback inside a region raises.
        try:
            with jit_sanitizer.step_region("control"):
                torch.ones(2, device="cuda").sum().item()
        except RuntimeError as exc:
            res["control"] = str(exc).splitlines()[0]
        else:
            raise AssertionError("an .item() inside a step region did not "
                                 "raise")
        guarded = reg.snapshot()["counters"].get(
            jit_sanitizer.GUARDED_TRANSFERS_COUNTER, 0)
        if tracker.transfers() != 1 or guarded != 1:
            raise AssertionError(f"the control was counted {guarded} / "
                                 f"{tracker.transfers()} times, not once")
        if torch.cuda.get_sync_debug_mode() != 0:
            raise AssertionError("the region left the sync debug mode on")
        log(f"jit sanitizer: {json.dumps(res)}")
    finally:
        if prev is None:
            os.environ.pop(jit_sanitizer.ENV_FLAG, None)
        else:
            os.environ[jit_sanitizer.ENV_FLAG] = prev
        tracker.reset()
    return res


def first_call_phase(root: Path) -> dict:
    """FIRST_CALL_SCRIPT run twice, one process after the other, on one
    compile-cache dir (``TONY_COMPILE_CACHE_DIR``) that starts empty: the
    cold run builds the kernel libraries into it and misses twice (init
    and step), the warm run loads them and hits twice; tony_compile_ms of
    both."""
    import os

    cache = root / "compile-cache"
    env = dict(os.environ, TONY_COMPILE_CACHE_DIR=str(cache),
               PYTHONPATH=str(Path(__file__).resolve().parent))
    res = {}
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", FIRST_CALL_SCRIPT,
             json.dumps(BENCH_TRANSFORMER)],
            env=env, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"first-call {run} run failed:\n"
                                 f"{out.stderr[-4000:]}")
        res[run] = json.loads(out.stdout.strip().splitlines()[-1])
        res[run]["process_s"] = time.perf_counter() - t0
    if (res["cold"]["hits"], res["cold"]["misses"]) != (0, 2) or (
            res["warm"]["hits"], res["warm"]["misses"]) != (2, 0):
        raise AssertionError(f"compile cache counters: {json.dumps(res)}")
    libs = sorted(p.name for p in cache.glob("lib*.so"))
    if len(libs) != 3:
        raise AssertionError(f"the cold run built {libs} into the cache")
    res["libraries"] = libs
    log(f"first calls, cold then warm: {json.dumps(res)}")
    return res


# Phase 18: the telemetry plane. The capture window the serving requests
# are submitted into, the HBM monitor's interval, and the StepProfiler
# window over TELEMETRY_TRAIN_STEPS train steps.
TELEMETRY_CAPTURE_MS = 1000
TELEMETRY_GENERATE_NEW = 4  # DecodeSession.generate's tokens in the window
TELEMETRY_HBM_MS = "500"
TELEMETRY_TRAIN_STEPS = 6
# StepProfiler(start=2, num=3): steps 2-4 are traced and steps 3-4 held
# to the launch counters. In a long-running process the profiler can lose
# the first kernels of a session, so the traced step 2 leads in.
TELEMETRY_WINDOW = (2, 3)
TELEMETRY_HELD = 2  # the window's last steps whose kernel events are held
# PERF.md's last serving reading (the serve phase's 12 HTTP requests on
# the flagship model, 16 slots; NVIDIA H100 80GB HBM3 at 700.00 W),
# printed beside this phase's.
TELEMETRY_SERVE_REFERENCE_TOKENS_PER_S = 437.6


def _trace_events(path: Path) -> list[dict]:
    return json.loads(Path(path).read_text())["traceEvents"]


_COUNTER_NAMES = {"B1": "flash_fwd", "B2": "flash_bwd_dq",
                  "B3": "flash_bwd_dkv", "B4": "rms_norm"}


def _counter_name(event: dict) -> "str | None":
    """The launch counter of a B1-B4 kernel event, else None."""
    if event.get("cat") != "kernel":
        return None
    part = next((c for pat, c in _KERNEL_CATEGORIES
                 if pat in event.get("name", "")), None)
    return _COUNTER_NAMES[part] if part is not None else None


def _kernel_counts(events: list[dict]) -> dict:
    """Kernel events of B1-B4 in a Chrome trace, by launch-counter name."""
    counts = dict.fromkeys(_COUNTER_NAMES.values(), 0)
    for e in events:
        name = _counter_name(e)
        if name is not None:
            counts[name] += 1
    return counts


def _step_kernel_counts(events: list[dict], annotation: str) -> list[dict]:
    """B1-B4 kernel events of each step annotated ``annotation``, in step
    order: a kernel belongs to the step whose annotation holds, on the
    host's clock, the launch call the trace ties to it (their shared
    ``correlation``)."""
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {})}
    steps = sorted((e for e in events if e.get("name") == annotation
                    and e.get("cat") == "user_annotation"),
                   key=lambda e: e["ts"])
    counts = [dict.fromkeys(_COUNTER_NAMES.values(), 0) for _ in steps]
    for e in events:
        name = _counter_name(e)
        t = launched_at.get(e.get("args", {}).get("correlation"))
        if name is None or t is None:
            continue
        for step, count in zip(steps, counts):
            if step["ts"] <= t <= step["ts"] + step["dur"]:
                count[name] += 1
                break
    return counts


def _span_counts(tracer) -> dict:
    names = [e["name"] for e in tracer.to_chrome_events()]
    return {n: names.count(n) for n in ("serving_decode_window",
                                        "serving_prefill_chunks")}


def _decimated(calls: int, dense: int, every: int) -> int:
    """The spans an engine takes over ``calls`` dispatches of one kind."""
    return sum(n < dense or n % every == 0 for n in range(calls))


def telemetry_phase(torch, attention, norms, seed: int, root: Path) -> dict:
    """The telemetry plane on the card, the launch counters set to 0 just
    before (a) and read just after (b).

    (a) TONY_PROFILE_HBM_INTERVAL_MS set, runtime.initialize() (the HBM
    monitor into a fresh default registry), a float ServingEngine on the
    flagship model with a private registry under TONY_JIT_SANITIZER=strict,
    run_capture on a thread for TELEMETRY_CAPTURE_MS, and into its window
    one DecodeSession.generate of TELEMETRY_GENERATE_NEW tokens (the
    serving side's B1: the engine's prefill attends in plain PyTorch, as
    JAX's does) and the serve phase's 12 requests: the tony_serving_*
    counters
    equal the engine's tallies and the responses, 12 TTFT observations,
    queue and active gauges 0 after the drain, the engine's spans in the
    default tracer as its dispatch counts decimate, the three HBM gauges
    read the card, the capture's snapshot says "cuda" and its trace holds
    kernel events of B1 and B4, and the sanitizer saw no guarded transfer
    and no retrace. (b) StepProfiler(start=2, num=3) and
    annotate("telemetry_step") over TELEMETRY_TRAIN_STEPS steps of the
    train cell: one trace, holding each step's annotation, in which the
    B1-B4 kernel events launched inside the annotations of steps 3 and 4
    (tied to their launch calls by the trace's correlation ids) equal each
    step's launch-counter increase; step 2 leads in, and a window whose
    trace dropped an event is logged and profiled again, up to
    PROFILE_TRIES windows. The profiled and unprofiled step times and the
    window's top 12 device ops."""
    import os

    from tony_tpu_torch import constants, profiling, runtime
    from tony_tpu_torch.analysis import jit_sanitizer
    from tony_tpu_torch.models import (DecodeSession, TransformerConfig,
                                       init_params, make_train_step)
    from tony_tpu_torch.observability import (MetricsRegistry,
                                              default_tracer)
    from tony_tpu_torch.observability import profiling as obs_profiling
    from tony_tpu_torch.serving import ServingEngine
    from tony_tpu_torch.serving import scheduler

    res: dict = {}
    saved = {k: os.environ.get(k) for k in (
        constants.TONY_PROFILE_HBM_INTERVAL_MS, jit_sanitizer.ENV_FLAG)}
    try:
        os.environ[constants.TONY_PROFILE_HBM_INTERVAL_MS] = TELEMETRY_HBM_MS
        default_reg = _fresh_registry()
        ctx = runtime.initialize()
        if not obs_profiling._hbm_monitor_started:
            raise AssertionError("runtime.initialize() started no HBM "
                                 "monitor on the card")
        cfg = TransformerConfig(dtype="bfloat16", **FLAGSHIP)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        params = init_params(cfg, gen, device="cuda")
        session = DecodeSession(params, cfg, device="cuda")
        bodies = make_requests(cfg, session, seed, N_REQUESTS)
        os.environ[jit_sanitizer.ENV_FLAG] = "strict"
        tracker = jit_sanitizer.tracker()
        tracker.reset()
        tracer = default_tracer()
        spans_before = _span_counts(tracer)
        reg = MetricsRegistry()
        _reset_launches(attention, norms)
        engine = ServingEngine(params, cfg, device="cuda", slots=16,
                               prefill_chunk=32, seed=seed,
                               registry=reg).start()
        capture: dict = {}

        def run_capture():
            capture.update(obs_profiling.run_capture(
                "telemetry", TELEMETRY_CAPTURE_MS, root / "capture",
                "chip_smoke:0"))
            capture["t_done"] = time.perf_counter()

        capturer = threading.Thread(target=run_capture)
        capturer.start()
        deadline = time.monotonic() + 60
        while obs_profiling._trace_owner is None and capturer.is_alive():
            if time.monotonic() > deadline:
                raise AssertionError("the capture's profiler never opened")
            time.sleep(0.001)
        t_open = time.perf_counter()
        # The engine's prefill attends against the cache in plain PyTorch,
        # as the JAX package's engine does; B1 on the serving side is
        # DecodeSession.generate's prefill, run first in the window (the
        # engine idle, so no step region is armed around it).
        session.generate(np.asarray(bodies[0]["prompt"], np.int32)[None],
                         TELEMETRY_GENERATE_NEW)
        t0 = time.perf_counter()
        reqs = [engine.submit(np.asarray(b["prompt"], np.int32),
                              b["max_new_tokens"], eos_id=b.get("eos_id"))
                for b in bodies]
        results = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
        if not engine.drain(timeout=60):
            raise AssertionError("telemetry engine did not drain")
        capturer.join(timeout=TELEMETRY_CAPTURE_MS / 1e3 + 300)
        if capturer.is_alive():
            raise AssertionError("the capture did not end")
        sanitizer = {"retraces": tracker.retraces(),
                     "transfers": tracker.transfers(),
                     "keys": tracker.report()["keys"]}
        os.environ.pop(jit_sanitizer.ENV_FLAG)
        snap = reg.snapshot()
        counters, gauges = snap["counters"], snap["gauges"]
        stats = engine.stats()
        n_tokens = sum(r["length"] for r in results)
        tallied_tokens = engine.tokens_generated
        spans = {k: v - spans_before[k]
                 for k, v in _span_counts(tracer).items()}
        want_spans = {
            "serving_decode_window": _decimated(
                engine._decode_calls, engine._SPAN_DENSE,
                engine._SPAN_EVERY),
            "serving_prefill_chunks": _decimated(
                engine._pf_draws, engine._SPAN_DENSE, engine._SPAN_EVERY)}
        card = torch.cuda.current_device()
        hbm_gauges = default_reg.snapshot()["gauges"]
        hbm = {k: hbm_gauges.get(f'{obs_profiling.HBM_GAUGE}{{device='
                                 f'"{card}",kind="{k}"}}')
               for k in ("bytes_in_use", "peak_bytes_in_use",
                         "bytes_limit")}
        total_memory = torch.cuda.get_device_properties(card).total_memory
        trace_files = (sorted(Path(capture["trace_dir"]).glob(
            "*.pt.trace.json")) if capture.get("trace_dir") else [])
        capture_events = (_trace_events(trace_files[0]) if trace_files
                          else [])
        capture_kernels = _kernel_counts(capture_events)
        serve = {
            "device": ctx.device, "requests": len(reqs),
            "generated_tokens": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall,
            "tokens_per_s_perf_md": TELEMETRY_SERVE_REFERENCE_TOKENS_PER_S,
            "inter_token_p50_ms": float(np.percentile(
                engine.inter_token_ms_samples, 50)),
            "ttft_p50_ms": float(np.percentile(engine.ttft_ms_samples, 50)),
            "counters": {k: v for k, v in counters.items()
                         if k.startswith("tony_serving_")},
            "gauges": {k: v for k, v in gauges.items()
                       if k.startswith("tony_serving_")},
            "ttft_count": snap["histograms"][
                scheduler.SERVING_TTFT_MS_HISTOGRAM]["count"],
            "inter_token_count": snap["histograms"][
                scheduler.SERVING_INTER_TOKEN_MS_HISTOGRAM]["count"],
            "dispatches": {"decode": engine._decode_calls,
                           "prefill": engine._pf_draws},
            "spans": spans, "hbm_bytes": hbm,
            "capture": {k: capture.get(k) for k in (
                "duration_ms", "trace_error", "artifact")},
            # What the capture took past its window: the profiler's stop
            # (a synchronize, then the trace's collection, which holds
            # every Python thread of the process) and the export.
            "capture_stop_export_s": (capture["t_done"] - t_open
                                      - TELEMETRY_CAPTURE_MS / 1e3),
            "inter_token_max_ms": max(engine.inter_token_ms_samples),
            "capture_source": capture.get("snapshot", {}).get("source"),
            "capture_kernel_events": capture_kernels,
            "capture_cpu_ops": sum(e.get("cat") == "cpu_op"
                                   for e in capture_events),
            "sanitizer": sanitizer,
        }
        log("telemetry serve: " + json.dumps(serve))
        engine.close()
        del engine, session, params
        torch.cuda.empty_cache()
        want_counters = {
            scheduler.SERVING_REQUESTS_COUNTER: stats["requests"],
            scheduler.SERVING_RETIRED_COUNTER: stats["retired"],
            scheduler.SERVING_GENERATED_TOKENS_COUNTER: n_tokens}
        if (stats["requests"], stats["retired"], tallied_tokens) != (
                len(reqs), len(reqs), n_tokens) or \
                serve["counters"] != want_counters:
            raise AssertionError(f"telemetry: serving counters "
                                 f"{serve['counters']} against the "
                                 f"engine's tallies {stats}, "
                                 f"{tallied_tokens} tokens, and the "
                                 f"responses' {n_tokens}")
        if serve["ttft_count"] != len(reqs):
            raise AssertionError(f"telemetry: {serve['ttft_count']} TTFT "
                                 f"observations for {len(reqs)} requests")
        for name in (scheduler.SERVING_QUEUE_DEPTH_GAUGE,
                     scheduler.SERVING_ACTIVE_SLOTS_GAUGE):
            if gauges.get(name) != 0:
                raise AssertionError(f"telemetry: {name} = "
                                     f"{gauges.get(name)} after the drain")
        if spans != want_spans:
            raise AssertionError(f"telemetry: spans {spans}, the engine's "
                                 f"dispatches give {want_spans}")
        if not (hbm["bytes_in_use"] and hbm["bytes_in_use"] > 0
                and hbm["peak_bytes_in_use"] >= hbm["bytes_in_use"]
                and hbm["bytes_limit"] == total_memory):
            raise AssertionError(f"telemetry: HBM gauges {hbm}, the card's "
                                 f"total_memory {total_memory}")
        if serve["capture_source"] != "cuda" or "trace_error" in capture:
            raise AssertionError(f"telemetry: capture {capture}")
        if len(trace_files) != 1 or not (capture_kernels["flash_fwd"]
                                         and capture_kernels["rms_norm"]):
            raise AssertionError(f"telemetry: the capture's trace "
                                 f"{trace_files} holds kernel events "
                                 f"{capture_kernels}")
        if sanitizer["retraces"] or sanitizer["transfers"]:
            raise AssertionError(f"telemetry: jit sanitizer "
                                 f"{json.dumps(sanitizer)} "
                                 f"{tracker.violations()}")
        res["serve"] = serve

        # (b) the train cell under StepProfiler.
        tcfg = TransformerConfig(dtype="bfloat16", **BENCH_TRANSFORMER)
        init_fn, step_fn = make_train_step(tcfg, device="cuda")
        state = init_fn(seed)
        tokens = torch.as_tensor(np.random.default_rng(seed + 3).integers(
            0, tcfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)),
            device="cuda")
        start, num = TELEMETRY_WINDOW
        held = range(start + num - TELEMETRY_HELD, start + num)
        for attempt in range(PROFILE_TRIES):
            log_dir = root / f"train-profile-{attempt}"
            prof = profiling.StepProfiler(start=start, num=num,
                                          log_dir=str(log_dir))
            step_ms, losses, per_step = [], [], []
            for step in range(TELEMETRY_TRAIN_STEPS):
                before = _launches(attention, norms)
                prof.before_step(step)
                t0 = time.perf_counter()
                with profiling.annotate("telemetry_step"):
                    state, metrics = step_fn(state, tokens)
                    losses.append(float(metrics["loss"]))
                step_ms.append((time.perf_counter() - t0) * 1e3)
                prof.after_step(step)
                if start <= step < start + num:
                    per_step.append({k: v - before[k] for k, v in
                                     _launches(attention, norms).items()})
            prof.close()
            files = sorted(log_dir.glob("*.pt.trace.json"))
            events = _trace_events(files[0]) if len(files) == 1 else []
            kernels = _kernel_counts(events)
            traced = _step_kernel_counts(events, "telemetry_step")
            window = {k: sum(s[k] for s in per_step[-TELEMETRY_HELD:])
                      for k in per_step[0]}
            if len(files) == 1 and len(traced) == num and \
                    traced[-TELEMETRY_HELD:] == per_step[-TELEMETRY_HELD:]:
                break
            # The profiler now and then drops device events (a whole
            # trace's, or a kernel's): such a window is profiled again.
            log(f"StepProfiler window {attempt}: traces {files}, B1-B4 "
                f"kernel events by step {traced} against the launch "
                f"counters {per_step}; profiling the window again")
        else:
            raise AssertionError(f"telemetry: in {PROFILE_TRIES} "
                                 f"StepProfiler windows the B1-B4 kernel "
                                 f"events of steps {held[0]}-{held[-1]} "
                                 f"never equalled their launch counters "
                                 f"(last: {traced} against {per_step}, "
                                 f"{len(files)} traces)")
        launches = _launches(attention, norms)
        annotations = sum(e.get("name") == "telemetry_step"
                          and e.get("cat") == "user_annotation"
                          for e in events)
        device = {}
        for e in events:
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                name = e["name"][:90]
                ms, n = device.get(name, (0.0, 0))
                device[name] = (ms + e.get("dur", 0) / 1e3, n + 1)
        device_ms = sum(ms for ms, _ in device.values())
        top = sorted(device.items(), key=lambda kv: -kv[1][0])[:12]
        profiled = step_ms[start:start + num]
        unprofiled = [ms for i, ms in enumerate(step_ms)
                      if i and not start <= i < start + num]
        train = {
            "trace": files[0].name, "attempts": attempt + 1,
            "held_steps": list(held), "held_launches": window,
            "step_launches": per_step, "step_kernel_events": traced,
            "trace_kernel_events": kernels,
            "annotations": annotations,
            "profiled_step_ms": profiled, "unprofiled_step_ms": unprofiled,
            "window_device_ms": device_ms,
            "window_wall_ms": sum(profiled),
            "device_busy_share": device_ms / sum(profiled),
            "top": [{"op": k, "device_ms": ms, "count": n}
                    for k, (ms, n) in top],
            "losses": losses,
        }
        log("telemetry train: " + json.dumps(train))
        if not all(window.values()):
            raise AssertionError(f"telemetry: a kernel never launched over "
                                 f"steps {held[0]}-{held[-1]}: {window}")
        if annotations != num:
            raise AssertionError(f"telemetry: {annotations} telemetry_step "
                                 f"annotations in a window of {num} steps")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"telemetry: losses {losses}")
        res["train"] = train
        res["launches"] = launches
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"launches on the telemetry path: {res['launches']}")
    for name, n in res["launches"].items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"telemetry path")
    return res


def check_path_launches(launches_by_path: dict) -> None:
    """Every kernel launched on every path of the run, but on
    ZERO_LAUNCH_PATHS, the paths that run none of B1-B4 by design, where
    every count must be 0."""
    for path, counts in launches_by_path.items():
        for name, n in counts.items():
            if path in ZERO_LAUNCH_PATHS and n:
                raise AssertionError(f"kernel {name} launched {n} times on "
                                     f"the {path} path, which runs none")
            if path not in ZERO_LAUNCH_PATHS and n <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"{path} path")


# The paths that run no kernel of B1-B4: the image classifiers.
ZERO_LAUNCH_PATHS = ("classifier",)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    from tony_tpu_torch import kernels
    from tony_tpu_torch.models import (DecodeSession, TransformerConfig,
                                       init_params)
    from tony_tpu_torch.ops import attention, norms

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports: dict[str, str] = {}
    built = kernels.build(ptxas_report=reports)
    for name in kernels.KERNELS:
        kernels.function(name)
    log(f"build: {time.perf_counter() - t0:.2f} s ({built})")
    for lib, report in reports.items():
        log(f"[ptxas {lib}]\n{report}")
    check_no_spills(reports)
    for source, instances in (("flash_fwd.cu", FWD_INSTANCES),
                              ("flash_bwd.cu", BWD_INSTANCES)):
        mma = sass_mma_counts(sass_listing(kernels, source), instances)
        log(f"tensor-core instructions (HMMA/HGMMA) in the SASS of "
            f"{source}: {json.dumps(mma)}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    rms_row = check_rms_norm(torch, norms, gen)
    flash_row = check_flash(torch, attention, gen)
    dq_worst, dkv_worst = check_flash_bwd(torch, attention, gen)
    timed = time_attention(torch, attention, gen)
    time_attention_hd128(torch, attention, gen)
    dq_row = {"name": "flash_bwd_dq", "route": "cuda",
              "source": "tony_tpu_torch/csrc/flash_bwd.cu",
              "replaces": "tony_tpu/ops/attention.py:291",
              "max_abs_err": dq_worst}
    dkv_row = {"name": "flash_bwd_dkv", "route": "cuda",
               "source": "tony_tpu_torch/csrc/flash_bwd.cu",
               "replaces": "tony_tpu/ops/attention.py:348",
               "max_abs_err": dkv_worst}
    for row in (flash_row, dq_row, dkv_row):
        t = timed[row["name"]]
        row.update(max_abs_err=max(row["max_abs_err"], t["max_abs_err"]),
                   ms=t["ms"], plain_ms=t["plain_ms"],
                   library_ms=t["library_ms"], bound_ms=t["bound"][0],
                   bound_by=t["bound"][1],
                   shape="q/k/v [8, 2048, 16, 64] bf16, causal")

    cfg = TransformerConfig(dtype="bfloat16", **FLAGSHIP)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, device="cuda")
    session = DecodeSession(params, cfg, device="cuda")
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "unembed"))
    log(f"model: {n_params / 1e6:.1f} M params, bf16")

    # Slice 1's path: serve + generate, counters from 0 around it.
    bodies = make_requests(cfg, session, args.seed, N_REQUESTS)
    norms.launches = 0
    attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    float_serve = serve_phase(cfg, session, args.seed, bodies)
    float_serve["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    serve_launches = {"rms_norm": norms.launches,
                      "flash_fwd": attention.launches}
    generate_phase(torch, cfg, session, args.seed)
    serve_path = {"rms_norm": norms.launches, "flash_fwd": attention.launches}
    log(f"launches on the serving path: {serve_path} (serve phase alone: "
        f"{serve_launches})")
    for name, n in serve_path.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"serving path")
    float_profile = profile_phase(torch, cfg, session)
    parity_phase(torch, params, args.seed)
    # Slice 5's int8 path: the same requests through the int8 KV cache (it
    # resets the counters itself and reads them just after), then its fp32
    # checks.
    int8 = int8_serve_phase(torch, attention, norms, cfg, session, params,
                            args.seed, bodies, float_serve, float_profile)
    del session, params
    torch.cuda.empty_cache()

    # Slice 2's path: the train step at full width (it resets the counters
    # itself and reads them just after).
    train, train_run = train_phase(torch, attention, norms, args.seed)
    train_parity_phase(torch, args.seed)
    # Slice 3's path: the data-parallel train step over a one-rank NCCL
    # mesh (it resets the counters itself and reads them just after).
    dp = dp_phase(torch, attention, norms, args.seed)
    # Slice 4's tp path over a one-rank NCCL mesh (it resets the counters
    # itself and reads them just after).
    tp = tp_phase(torch, attention, norms, args.seed)
    torch.cuda.empty_cache()
    # Slice 4's sp path: the ring in one process and the trunk over a
    # one-rank NCCL mesh (it resets the counters itself and reads them just
    # after).
    sp = sp_phase(torch, attention, norms, args.seed)
    torch.cuda.empty_cache()
    # Slice 4's pp path: the schedules with every stage in one process and
    # the trunk over a one-rank NCCL mesh (it resets the counters itself
    # and reads them just after).
    pp = pp_phase(torch, attention, norms, args.seed)
    torch.cuda.empty_cache()

    # Slice 5's path: jobs that read a file, checkpoint, resume and serve
    # (the counters are reset and read inside), then checkpoint and input
    # timings on the train phase's state.
    with tempfile.TemporaryDirectory(prefix="tony-job-") as tmp:
        root = Path(tmp)
        free = shutil.disk_usage(root).free
        if free < JOB_MIN_FREE_BYTES:
            raise AssertionError(
                f"the job phase writes ~15 GB of checkpoints under {root}, "
                f"which has {free / 1e9:.1f} GB free (20 GB needed)")
        job = job_phase(torch, attention, norms, args.seed, root)
        # This slice's path: job C over gs:// under a fault plan, resumed
        # past its torn step and served from gs:// (it resets the counters
        # itself and reads them just after), and the native read timing.
        job_gs = job_gs_phase(torch, attention, norms, args.seed, root, job)
        job["timing"] = job_timing(torch, job.pop("train_args"), train_run,
                                   root, train["step_ms_median"])
    del train_run
    torch.cuda.empty_cache()

    # Slice 7's paths: the MoE trunk's train step at bench_moe's full
    # width, its parity (card vs CPU, and the ep path over one NCCL rank),
    # then MoE decode and serving (each resets the counters itself and
    # reads them just after).
    moe_train = moe_train_phase(torch, attention, norms, args.seed)
    torch.cuda.empty_cache()
    moe_parity_phase(torch, args.seed)
    # Slice 4's MoE paths: the pipeline in one process at bench_moe's full
    # width, and the MoE trunk over tp, sp and pp on a one-rank NCCL mesh
    # (it resets the counters itself and reads them just after each).
    moe_mesh = moe_mesh_phase(torch, attention, norms, args.seed)
    torch.cuda.empty_cache()
    moe_serve = moe_serve_phase(torch, attention, norms, args.seed)
    torch.cuda.empty_cache()

    # Slice 6's paths: the image classifiers (which launch none of B1-B4;
    # the counters are reset and read inside), the MNIST job through the
    # orchestrator, and the step anatomy of the LM and classifier steps (it
    # resets the counters itself and reads them just after).
    classifier = classifier_phase(torch, attention, norms, args.seed)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="tony-mnist-") as tmp:
        mnist_job_phase(Path(tmp))
    anatomy = anatomy_phase(torch, attention, norms, args.seed)
    torch.cuda.empty_cache()
    # This slice's path: the autotuner and the step built from its record
    # (it resets the counters itself and reads them just after), the jit
    # sanitizer over the serving and train paths, and the compile cache's
    # cold and warm first calls.
    tune = tune_phase(torch, attention, norms, args.seed)
    torch.cuda.empty_cache()
    sanitizer_phase(torch, attention, args.seed)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="tony-first-call-") as tmp:
        first_call_phase(Path(tmp))
    # This slice's path: the telemetry plane (serving with the registry,
    # spans, the HBM monitor and a capture window; train steps under
    # StepProfiler; it resets the counters itself and reads them just
    # after).
    with tempfile.TemporaryDirectory(prefix="tony-telemetry-") as tmp:
        telemetry = telemetry_phase(torch, attention, norms, args.seed,
                                    Path(tmp))
    torch.cuda.empty_cache()
    rows = (rms_row, flash_row, dq_row, dkv_row)
    for row in rows:
        row["launches"] = train["launches"][row["name"]]
        row["launches_by_path"] = {
            "train": train["launches"][row["name"]],
            "serve_generate": serve_path.get(row["name"], 0),
            "serve_int8": int8["launches"][row["name"]],
            "generate": job["generate_launches"][row["name"]],
            "job": job["launches"][row["name"]],
            "job_gs": job_gs["launches"][row["name"]],
            "dp": dp["launches"][row["name"]],
            "tp": tp["launches"][row["name"]],
            "sp": sp["launches"][row["name"]],
            "pp": pp["launches"][row["name"]],
            "moe_train": moe_train["launches"][row["name"]],
            "moe_pp": moe_mesh["pp_launches"][row["name"]],
            "moe_mesh": moe_mesh["mesh_launches"][row["name"]],
            "moe_serve": moe_serve["launches"][row["name"]],
            "classifier": classifier["launches"][row["name"]],
            "anatomy": anatomy["lm"]["launches"][row["name"]],
            "tune": tune["launches"][row["name"]],
            "telemetry": telemetry["launches"][row["name"]]}

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
