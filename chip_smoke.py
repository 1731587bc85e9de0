#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tony_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. build   — compile every CUDA kernel under tony_tpu_torch/csrc with nvcc
             (one process per source, started together), print ptxas's
             report (no function may spill), and count the tensor-core
             instructions (HMMA/HGMMA) of each flash kernel in cuobjdump's
             SASS (forward and backward): every bf16 instance must have
             some, the fp32 (FMA) instances none.
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the main paths' shapes and at edge shapes, in fp32 and bf16:
             B4 (RMSNorm), B1 (flash forward), B2 and B3 (flash backward,
             dq and dk/dv: causal and not, t_q =, < and > t_k, ragged T,
             T at the edges of the bf16 tiles and their double buffers,
             rows before the first key, GQA groups 1/2/4/8, head_dim
             64/128, fused strided q/k/v views, an lse cotangent, a
             non-contiguous dO). Then time kernel, plain version and library
             call (device time from the profiler's kernel events) at the
             training shape, B1/B4 at the serving shapes too, and B1-B3
             against SDPA's forward and backward at the hd128 shape
             [8, 2048, 8, 128]; at those two shapes B1-B3 are also held row
             by row (ROW_TOL).
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
7. train   — make_train_step on bench.py's bench_transformer configuration
             (vocab 32000, d 1024, 8 layers, 16 heads of 64, d_ff 4096,
             bf16, 199.8 M parameters) over a fixed batch of 8 x 2048
             tokens: step time, tokens/s, MFU, peak memory, launches per
             step, one profiled step; the loss must be finite and fall.
8. train parity — fp32 (TF32 off), 2 layers, d 256, GQA 16/4: losses of 3
             steps and first-step gradients on the card equal the CPU's
             plain path, with remat off, "full" and "dots".

The launch counters are set to 0 just before each path (phases 3-4, the
serving path; phase 7, the training path) and read just after; every kernel
of a path must have launched there. The last three lines are the kernels
JSON line, the card's name and power limit (nvidia-smi), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import subprocess
import sys
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

# Parity phase requests: (prompt length, new tokens, engine step at which it
# is submitted). Six slots, prefill chunks of 32 and prefill batches of 4:
# prompts shorter than a chunk and spanning three, two prefill calls in the
# first round (the second padded by duplicating its row 0), six live rows,
# and two late arrivals that wait for a slot the 7-token prompt frees.
PARITY_SLOTS = 6
PARITY_REQUESTS = [(7, 6, 0), (45, 16, 0), (90, 12, 0), (20, 16, 0),
                   (33, 10, 0), (64, 16, 0), (12, 16, 2), (70, 12, 5)]

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


def log(msg: str) -> None:
    print(msg, flush=True)


def device_events(torch, fn):
    """Run fn() once under the profiler; returns ([(name, device_us)] for
    every device-side event (kernels, memcpy, memset) it caused, the wall
    ms of that same call, synchronize included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # User annotations (an optimizer's step range) span kernels that are
    # listed on their own; counting them would count that time twice.
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        raise AssertionError("the profiler saw no device time")
    return events, wall_ms


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


def sass_mma_counts(listing: str,
                    instances: set[str] = BWD_INSTANCES) -> dict[str, int]:
    """Tensor-core instructions (HMMA, HGMMA) in each flash kernel function
    of a SASS listing that is one of ``instances`` (keyed
    "flash_<fwd|bwd_dq|bwd_dkv>_kernel_<dtype><head_dim>"; by default the
    8 backward ones). Raises unless the listing holds exactly those
    instances, every bf16 instance has some and every fp32 instance none."""
    kind = "flash_fwd" if instances <= FWD_INSTANCES else "flash_bwd"
    counts: dict[str, int] = {}
    name = None
    for line in listing.splitlines():
        if "Function :" in line:
            name = kernel_name(line)
            name = name if name in instances else None
            if name:
                counts[name] = 0
        elif name and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    if not counts:
        raise AssertionError(f"cuobjdump listed no {kind} kernel")
    if set(counts) != instances:
        raise AssertionError(f"cuobjdump listed {sorted(counts)}, not the "
                             f"instances {sorted(instances)}")
    for name, n in counts.items():
        if ("_bf16" in name) != (n > 0):
            raise AssertionError(f"{name}: {n} tensor-core instructions "
                                 f"(bf16 instances need some, fp32 none)")
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
        "library_ms": lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6),
    }
    iters = 200 if rows <= 1024 else 50
    res = {k: device_ms(torch, f, iters) for k, f in fns.items()}
    nbytes = 2 * rows * d * x.element_size() + d * w.element_size()
    res["bound"] = bound(nbytes, 4 * rows * d, torch.float32)
    return res


def row_error(diff, want) -> float:
    """The row error (see ROW_TOL) of ``diff`` = got - want, both
    [rows, head_dim] fp32: the worst ||diff_r|| / max(||want_r||,
    ROW_FLOOR * the RMS row norm of ``want``)."""
    w_norm = want.norm(dim=1)
    floor = ROW_FLOOR * w_norm.square().mean().sqrt()
    return (diff.norm(dim=1) / w_norm.clamp(min=floor)).max().item()


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


def _check_fwd(tag, got, want, dtype, rows: bool = False) -> float:
    """Holds B1's (out, lse) against the plain version's (fwd_checks);
    returns the max abs error of out."""
    errs = fwd_errors(got, want)
    if not all(fwd_checks(errs, dtype, rows).values()):
        raise AssertionError(
            f"flash {tag}: {json.dumps(errs)} (tol "
            f"{TOL[('flash_fwd', str(dtype))]}, lse tol "
            f"{TOL[('flash_lse', str(dtype))]}"
            f"{f', row tol {ROW_TOL}' if rows else ''})")
    if rows:
        log(f"flash {tag}: {json.dumps(errs)}: ok")
    else:
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
        "library_ms": device_ms(torch, lambda: sdpa(qs, ks, vs,
                                                    is_causal=True), iters),
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


def _check_bwd(torch, tag, got, want, dtype,
               rows: bool = False) -> tuple[float, float]:
    """Holds (dq, dk, dv) from B2 + B3 against the plain version's within
    TOL, and with ``rows`` row by row within ROW_TOL; returns the max abs
    error of B2 (dq) and of B3 (dk and dv)."""
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
    if rows:
        log(f"flash bwd {tag}: " + json.dumps(errs) + ": ok")
    else:
        log(f"flash bwd {tag}: dq/dk/dv err " + "/".join(
            f"{e['max_abs_err']:.3g}" for e in errs.values()) + ": ok")
    return errs["dq"]["max_abs_err"], max(errs["dk"]["max_abs_err"],
                                          errs["dv"]["max_abs_err"])


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
    # Edges of the bf16 tiles (B2: 64 query rows by key tiles of 16; B3: 64
    # keys by query tiles of 32) and of their double buffers: one below, at
    # and one above one and two tiles of each.
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
    dict(b=1, t_q=32, t_k=32, h=4, h_kv=2, d=128, causal=False),
    dict(b=1, t_q=33, t_k=33, h=4, h_kv=2, d=128, causal=True),
    dict(b=1, t_q=63, t_k=63, h=4, h_kv=4, d=128, causal=False),
    dict(b=1, t_q=64, t_k=64, h=4, h_kv=4, d=128, causal=True),
    dict(b=1, t_q=65, t_k=65, h=4, h_kv=4, d=128, causal=True),
    # t_q under one tile, t_k over three
    dict(b=1, t_q=20, t_k=150, h=4, h_kv=2, d=64, causal=True),
    dict(b=1, t_q=20, t_k=150, h=4, h_kv=2, d=128, causal=True),
    dict(b=1, t_q=20, t_k=150, h=4, h_kv=2, d=64, causal=False),
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


def time_sdpa_bwd(torch, q, k, v, do) -> float:
    """Device ms of SDPA's causal backward (dq, dk, dv) on the same MHA
    inputs in its [B, H, T, D] layout: the library yardstick of B2 + B3."""
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dos = do.transpose(1, 2).contiguous()
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True)
    return device_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), dos, retain_graph=True), 5, warmup=1)


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
    and row by row within ROW_TOL, then timed beside SDPA's forward and
    backward, with the bounds."""
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
    dq_ms, dkv_ms = time_bwd_kernels(torch, attention, q, k, v, out, lse, do)
    dq_bound, dkv_bound = bwd_bounds(q, k)
    res = {"flash_fwd": dict(max_abs_err=fwd_err,
                             **time_fwd(torch, attention, q, k, v, 10, 3)),
           "flash_bwd_dq": dict(max_abs_err=dq_err, ms=dq_ms,
                                bound=dq_bound),
           "flash_bwd_dkv": dict(max_abs_err=dkv_err, ms=dkv_ms,
                                 bound=dkv_bound),
           "sdpa_bwd_ms": time_sdpa_bwd(torch, q, k, v, do)}
    log("attention at the hd128 shape q/k/v [8, 2048, 8, 128] bf16 causal, "
        "device ms (flash_fwd's library_ms: SDPA's forward): "
        + json.dumps(res))
    return res


def time_attention(torch, attention, gen) -> dict:
    """B1, B2 and B3 at the training shape: first their outputs against the
    plain versions' on the same inputs (within TOL and row by row within
    ROW_TOL; the max abs errors are returned under "max_abs_err"), then
    the device time of each kernel (B2 and B3 split by kernel name from
    one profiled backward), their plain versions, SDPA forward and SDPA
    backward as library yardsticks, and the bounds."""
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
    fwd = time_fwd(torch, attention, q, k, v, 10, 3)

    dq_ms, dkv_ms = time_bwd_kernels(torch, attention, q, k, v, out, lse, do)
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


def serve_phase(cfg, session, seed: int, bodies: list[dict]) -> dict:
    from tony_tpu_torch.serving import ServingEngine
    from tony_tpu_torch.serving.http import ServingServer

    n_requests = len(bodies)
    engine = ServingEngine(session.params, cfg, device="cuda", slots=16,
                           prefill_chunk=32, seed=seed).start()
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
    log("serve: " + json.dumps(out))
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


def profile_phase(torch, cfg, session) -> dict:
    """Device time by kernel over 8 decode steps of a full 16-slot batch at
    position ~100 (cache contents are irrelevant to the timing). The busy
    share divides the profiled call's device time by that same call's wall
    time, which the profiler's host-side recording lengthens; the wall of
    an unprofiled call is reported beside it."""
    from tony_tpu_torch.serving import engine as eng

    k_all, v_all = eng.init_slot_cache(cfg, 16, cfg.max_seq, device="cuda")
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
    log("profile: " + json.dumps(res))
    return res


def parity_phase(torch, params, seed: int) -> dict:
    """fp32, TF32 off: staggered requests of mixed lengths through the
    engine (chunked prefill + slot decode, several slots live at once)
    each equal DecodeSession.generate (flash prefill + cache decode) token
    for token, at decode windows 1 and 3."""
    from tony_tpu_torch.models import DecodeSession, TransformerConfig
    from tony_tpu_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(dtype="float32", **FLAGSHIP)
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
        reqs: list = [None] * len(prompts)
        max_live = 0
        for step in range(400):
            for i, (p, (_, n, at)) in enumerate(zip(prompts,
                                                    PARITY_REQUESTS)):
                if at == step:
                    reqs[i] = engine.submit(p, n)
            engine.step()
            max_live = max(max_live, engine.stats()["active_slots"])
            if all(r is not None and r.done() for r in reqs):
                break
        engine.close()
        for i, (req, want) in enumerate(zip(reqs, wants)):
            got = np.asarray(req.result(timeout=1)["tokens"])
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"engine/generate parity broken (window {window}, "
                    f"request {i}, prompt {prompts[i].size}):\n  engine   "
                    f"{got.tolist()}\n  generate {want.tolist()}")
            n_tokens += int(got.size)
        if max_live <= engine.prefill_batch:
            raise AssertionError(f"only {max_live} slots were live at once")
        log(f"parity fp32, decode window {window}: {len(reqs)} requests "
            f"equal, up to {max_live} slots live at once, "
            f"{engine.stats()['retired']} retired")
    return {"requests": len(prompts), "tokens": n_tokens}


def _loss_list(torch, losses) -> list[float]:
    return [float(x) for x in torch.stack(losses).cpu()]


def train_phase(torch, attention, norms, seed: int) -> dict:
    """make_train_step on the bench_transformer configuration, one fixed
    batch of synthetic tokens [8, 2049] from ``seed`` (2048 positions per
    row). Step time is the median over TRAIN_STEPS steps after
    TRAIN_WARMUP warm-ups, between CUDA events recorded at the step
    boundaries (no host sync inside the loop); then one profiled step.
    The launch counters are set to 0 just before and read just after."""
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
    n_steps = TRAIN_WARMUP + TRAIN_STEPS + 1
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
    for name, us in events:
        by_name.setdefault(name, []).append(us)
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
            "top": [{"kernel": k[:90], "device_ms": us / 1e3, "count": c}
                    for us, k, c in rows[:12]],
        },
    }
    log("train: " + json.dumps(res))
    return res


def train_parity_phase(torch, seed: int) -> dict:
    """fp32, TF32 off: the same weights and batches through make_train_step
    on the card and on the CPU (the plain path, which the CPU tests pin to
    the JAX package), with remat off, "full" and "dots": the losses of
    PARITY_TRAIN_STEPS steps and every gradient leaf of the first step
    agree within the stated tolerances."""
    from tony_tpu_torch.models import (TransformerConfig, init_params,
                                       lm_loss, make_train_step)
    from tony_tpu_torch.models.train import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 4)
    out = {}
    for remat, policy in PARITY_REMAT:
        cfg = TransformerConfig(dtype="float32", remat=remat,
                                remat_policy=policy, **PARITY_TRAIN)
        params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
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
            losses[dev] = _loss_list(torch, run)
        tag = f"remat={remat}/{policy}"
        if not np.allclose(losses["cuda"], losses["cpu"], rtol=TRAIN_LOSS_RTOL,
                           atol=0):
            raise AssertionError(f"train parity {tag}: losses card "
                                 f"{losses['cuda']} vs cpu {losses['cpu']}")
        worst = 0.0
        for i, (a, b) in enumerate(zip(grads["cuda"], grads["cpu"])):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            if not err <= TRAIN_GRAD_TOL * scale:
                raise AssertionError(f"train parity {tag}: gradient leaf {i} "
                                     f"err {err} > {TRAIN_GRAD_TOL} * {scale}")
            worst = max(worst, err / scale if scale else err)
        out[tag] = {"losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
                    "worst_grad_rel_err": worst}
        log(f"train parity fp32 {tag}: losses card {losses['cuda']} / cpu "
            f"{losses['cpu']}, worst gradient err {worst:.3g} of the leaf "
            f"max: ok")
    return out


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
    serve_phase(cfg, session, args.seed, bodies)
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
    profile_phase(torch, cfg, session)
    parity_phase(torch, params, args.seed)
    del session, params
    torch.cuda.empty_cache()

    # Slice 2's path: the train step at full width (it resets the counters
    # itself and reads them just after).
    train = train_phase(torch, attention, norms, args.seed)
    train_parity_phase(torch, args.seed)
    rows = (rms_row, flash_row, dq_row, dkv_row)
    for row in rows:
        row["launches"] = train["launches"][row["name"]]
        row["launches_by_path"] = {
            "train": train["launches"][row["name"]],
            "serve_generate": serve_path.get(row["name"], 0)}

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
