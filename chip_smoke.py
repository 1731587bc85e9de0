#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tony_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. build   — compile every CUDA kernel under tony_tpu_torch/csrc with nvcc
             (one process per source, started together).
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the serving path's shapes and at edge shapes, in fp32 and
             bf16, and time kernel, plain version and library call at the
             main-path shape: device time from the profiler's kernel
             events (the "ms" numbers), and time per call between CUDA
             events, which for these short kernels is the launch rate.
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

The launch counters are set to 0 just before phase 3 and read just after
phase 4; every kernel must have launched there. The last three lines are the
kernels JSON line, the card's name and power limit (nvidia-smi), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
import time
import urllib.request

import numpy as np

# Peak rates of an H100 SXM (NVIDIA data sheet, dense), used for bound_ms.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

FLAGSHIP = dict(
    vocab_size=32_000, d_model=1024, n_layers=8, n_heads=16, head_dim=64,
    d_ff=4096, max_seq=2048, n_kv_heads=4, remat=False,
)
N_REQUESTS = 12  # concurrent POST /generate requests in the serve phase

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
    ("rms_norm", "torch.bfloat16"): 2e-2,
    ("flash_fwd", "torch.float32"): 5e-5,
    ("flash_fwd", "torch.bfloat16"): 2e-2,
    ("flash_lse", "torch.float32"): 5e-5,
    ("flash_lse", "torch.bfloat16"): 1e-3,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def call_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call of fn() between two CUDA events: for a call
    whose kernels are shorter than its host-side launch cost this is the
    launch rate, not device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
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


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_rms_norm(torch, norms, gen) -> dict:
    worst = 0.0
    dev = "cuda"
    cases = [(rows, 1024) for rows in (1, 4, 8, 16, 128, 1024)]
    cases += [(3, 64), (257, 4096)]
    for x_dt in (torch.float32, torch.bfloat16):
        for w_dt in (torch.float32, torch.bfloat16):
            for rows, d in cases:
                x = torch.randn(rows, d, generator=gen, device=dev).to(x_dt)
                w = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
                     ).to(w_dt)
                got = norms._rms_norm_cuda(x, w, 1e-6)
                want = norms._rms_norm_plain(x, w, 1e-6)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = TOL[("rms_norm", str(x_dt))]
                if not err <= tol:
                    raise AssertionError(
                        f"rms_norm x={x_dt} w={w_dt} [{rows},{d}]: max abs "
                        f"err {err} > {tol}")
                if x_dt == torch.bfloat16 and w_dt == torch.bfloat16:
                    worst = max(worst, err)
            log(f"rms_norm x={x_dt} w={w_dt}: ok "
                f"(tol {TOL[('rms_norm', str(x_dt))]})")
    # Main-path shape: a decode step over 16 slots, d 1024, bf16 x and w.
    rows, d = 16, 1024
    x = torch.randn(rows, d, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.ones(d, device=dev, dtype=torch.bfloat16)
    fns = {
        "kernel": lambda: norms._rms_norm_cuda(x, w, 1e-6),
        "plain": lambda: norms._rms_norm_plain(x, w, 1e-6),
        "library": lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6),
    }
    times = {k: device_ms(torch, f, 200) for k, f in fns.items()}
    per_call = {k: call_ms(torch, f, 200) for k, f in fns.items()}
    ms, plain_ms, lib_ms = times["kernel"], times["plain"], times["library"]
    nbytes = 2 * rows * d * x.element_size() + d * w.element_size()
    b_ms, b_by = bound(nbytes, 4 * rows * d, torch.float32)
    log(f"rms_norm [16,1024] bf16 device ms: {times}; per call (events): "
        f"{per_call}; bound {b_ms:.6f} ms ({b_by})")
    return {
        "name": "rms_norm", "route": "cuda",
        "source": "tony_tpu_torch/csrc/rms_norm.cu",
        "replaces": "tony_tpu/ops/norms.py:17",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "shape": "x [16, 1024] bf16, w [1024] bf16",
    }


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
    want, want_lse = attention._flash_plain_bthd(
        q, k, v, causal=causal, scale=scale, return_lse=True)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    tag = (f"b={b} tq={t_q} tk={t_k} h={h}/{h_kv} d={d} causal={causal} "
           f"{dtype}{' fused' if fused else ''}")
    tol = TOL[("flash_fwd", str(dtype))]
    lse_tol = TOL[("flash_lse", str(dtype))]
    if not (err <= tol and lse_err <= lse_tol):
        raise AssertionError(f"flash {tag}: out err {err} (tol {tol}), lse "
                             f"err {lse_err} (tol {lse_tol})")
    if causal and t_q > t_k:
        # Rows before the first key are fully masked: O = 0, lse = log(1e-30).
        n_masked = t_q - t_k
        if out[:, :n_masked].abs().max().item() != 0.0:
            raise AssertionError(f"flash {tag}: masked rows not zero")
        lse_m = lse[:, :, :n_masked]
        if (lse_m - np.log(1e-30)).abs().max().item() > 1e-3:
            raise AssertionError(f"flash {tag}: masked-row lse wrong")
    log(f"flash {tag}: out err {err:.3g}, lse err {lse_err:.3g}: ok")
    return err


def check_flash(torch, attention, gen) -> dict:
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        cases = [
            # main path: DecodeSession.generate prefill, B*H = 8*16, T 128
            dict(b=8, t_q=128, t_k=128, h=16, h_kv=4, d=64, causal=True,
                 fused=True),
            dict(b=8, t_q=128, t_k=128, h=16, h_kv=4, d=64, causal=True),
            dict(b=2, t_q=100, t_k=100, h=16, h_kv=4, d=64, causal=True),
            dict(b=2, t_q=257, t_k=257, h=4, h_kv=4, d=64, causal=True),
            dict(b=1, t_q=37, t_k=300, h=8, h_kv=2, d=64, causal=True),
            dict(b=2, t_q=257, t_k=257, h=8, h_kv=2, d=128, causal=True),
            dict(b=2, t_q=100, t_k=257, h=8, h_kv=4, d=128, causal=False),
            dict(b=2, t_q=65, t_k=130, h=4, h_kv=1, d=64, causal=False),
            dict(b=1, t_q=80, t_k=50, h=4, h_kv=2, d=64, causal=True),
        ]
        for case in cases:
            err = _flash_case(torch, attention, gen, dtype=dtype, **case)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    # Main-path shape, bf16, as the generate prefill calls it.
    b, t, h, h_kv, d = 8, 128, 16, 4, 64
    dt = torch.bfloat16
    q = torch.randn(b, t, h, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, t, h_kv, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, t, h_kv, d, generator=gen, device="cuda").to(dt)
    scale = d ** -0.5
    fns = {
        "kernel": lambda: attention._flash_attention_cuda(
            q, k, v, causal=True, scale=scale),
        "plain": lambda: attention._flash_plain_bthd(
            q, k, v, causal=True, scale=scale, return_lse=True),
    }
    # Library yardstick on the same inputs in its [B, H, T, D] layout,
    # KV heads repeated beforehand (outside the timed region).
    qs = q.transpose(1, 2).contiguous()
    ks = k.repeat_interleave(h // h_kv, dim=2).transpose(1, 2).contiguous()
    vs = v.repeat_interleave(h // h_kv, dim=2).transpose(1, 2).contiguous()
    fns["library"] = lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True)
    times = {k: device_ms(torch, f, 50) for k, f in fns.items()}
    per_call = {k: call_ms(torch, f, 50) for k, f in fns.items()}
    ms, plain_ms, lib_ms = times["kernel"], times["plain"], times["library"]
    el = q.element_size()
    nbytes = (2 * b * t * h * d + 2 * b * t * h_kv * d) * el + b * h * t * 4
    pairs = t * (t + 1) // 2  # visible (query, key) pairs per head, causal
    flops = 4 * b * h * d * pairs
    b_ms, b_by = bound(nbytes, flops, dt)
    log(f"flash [8x16, 128, 64] bf16 causal device ms: {times}; per call "
        f"(events): {per_call}; bound {b_ms:.6f} ms ({b_by})")
    return {
        "name": "flash_fwd", "route": "cuda",
        "source": "tony_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "tony_tpu/ops/attention.py:52",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "shape": "q [8, 128, 16, 64], k/v [8, 128, 4, 64] bf16, causal",
    }


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
    built = kernels.build(verbose=True)
    for name in kernels.KERNELS:
        kernels.function(name)
    log(f"build: {time.perf_counter() - t0:.2f} s ({built})")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    rms_row = check_rms_norm(torch, norms, gen)
    flash_row = check_flash(torch, attention, gen)

    cfg = TransformerConfig(dtype="bfloat16", **FLAGSHIP)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, device="cuda")
    session = DecodeSession(params, cfg, device="cuda")
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "unembed"))
    log(f"model: {n_params / 1e6:.1f} M params, bf16")

    bodies = make_requests(cfg, session, args.seed, N_REQUESTS)
    norms.launches = 0
    attention.launches = 0
    serve_phase(cfg, session, args.seed, bodies)
    serve_launches = {"rms_norm": norms.launches,
                      "flash_fwd": attention.launches}
    generate_phase(torch, cfg, session, args.seed)
    launches = {"rms_norm": norms.launches, "flash_fwd": attention.launches}
    log(f"launches on the main path: {launches} (serve phase alone: "
        f"{serve_launches})")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    rms_row["launches"] = launches["rms_norm"]
    flash_row["launches"] = launches["flash_fwd"]

    profile_phase(torch, cfg, session)
    parity_phase(torch, params, args.seed)

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in (rms_row, flash_row)]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
