#!/usr/bin/env python3
"""Studies of the telemetry plane on one NVIDIA card.

    python3 telemetry_study.py probe
    python3 telemetry_study.py serve TREE [TREE ...]

probe: which synchronizing calls CUDA's sync debug mode flags under
"error", the mode the jit sanitizer's step regions arm: a device-wide
``torch.cuda.synchronize()``, an event's and a stream's ``synchronize()``,
``.item()`` and a ``torch.profiler`` stop (whose stop synchronizes the card).
A capture thread may stop its profiler while the serving engine's loop
thread holds a region only if that stop is not flagged.

serve: for each TREE (a checkout of this repository), in the order given,
one process that builds that tree's kernels and serves ``chip_smoke.py``'s
12 requests through its flagship ``ServingEngine`` (bf16, 16 slots, prefill
chunk 32, the default registry) for a warm-up round and SERVE_ROUNDS timed
rounds, and prints one ``serve`` JSON line: tokens/s and inter-token p50 of
each round and their medians. Give a parent checkout and the change in
turns (parent, change, change, parent, ...) to compare the two on one card.

Each mode prints the card's name and power limit first. Needs one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SERVE_ROUNDS = 5


def probe() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    calls = {
        "torch.cuda.synchronize()": torch.cuda.synchronize,
        "event.synchronize()":
            lambda: torch.cuda.current_stream().record_event().synchronize(),
        "stream.synchronize()":
            lambda: torch.cuda.current_stream().synchronize(),
        ".item()": lambda: x.sum().item(),
    }
    flagged = {}
    for name, call in calls.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
            flagged[name] = False
        except RuntimeError:
            flagged[name] = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    (x * 2).sum()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prof.stop()
        flagged["profiler stop"] = False
    except RuntimeError:
        flagged["profiler stop"] = True
        torch.cuda.set_sync_debug_mode(0)
        prof.stop()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("probe " + json.dumps({"flagged_under_error_mode": flagged}),
          flush=True)


def serve_one(tree: str) -> None:
    """One tree's engine; runs in a process of its own with ``tree`` first
    on the path."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke
    from tony_tpu_torch import kernels
    from tony_tpu_torch.models import (DecodeSession, TransformerConfig,
                                       init_params)
    from tony_tpu_torch.serving import ServingEngine

    for mod in (chip_smoke, kernels):
        if not mod.__file__.startswith(tree):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, "
                               f"not {tree}")
    kernels.build()
    cfg = TransformerConfig(dtype="bfloat16", **chip_smoke.FLAGSHIP)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    bodies = chip_smoke.make_requests(
        cfg, DecodeSession(params, cfg, device="cuda"), 0,
        chip_smoke.N_REQUESTS)
    rounds = []
    with ServingEngine(params, cfg, device="cuda", slots=16,
                       prefill_chunk=32, seed=0) as engine:
        for r in range(SERVE_ROUNDS + 1):
            engine.inter_token_ms_samples.clear()
            t0 = time.perf_counter()
            reqs = [engine.submit(np.asarray(b["prompt"], np.int32),
                                  b["max_new_tokens"],
                                  eos_id=b.get("eos_id")) for b in bodies]
            n_tokens = sum(q.result(timeout=600)["length"] for q in reqs)
            wall = time.perf_counter() - t0
            if r:  # round 0 warms up
                rounds.append({
                    "tokens_per_s": n_tokens / wall,
                    "inter_token_p50_ms": float(np.percentile(
                        engine.inter_token_ms_samples, 50))})
    print("serve " + json.dumps({
        "tree": tree, "rounds": rounds,
        "median_tokens_per_s": float(np.median(
            [x["tokens_per_s"] for x in rounds])),
        "median_inter_token_p50_ms": float(np.median(
            [x["inter_token_p50_ms"] for x in rounds]))}), flush=True)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("telemetry_study: CUDA is not available", file=sys.stderr)
        return 1
    if not argv or argv[0] not in ("probe", "serve", "_serve_one"):
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "_serve_one":
        serve_one(argv[1])
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    if argv[0] == "probe":
        probe()
        return 0
    for tree in argv[1:]:
        subprocess.run([sys.executable, __file__, "_serve_one", tree],
                       check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
