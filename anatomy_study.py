#!/usr/bin/env python3
"""Where the instrumented train step's extra wall goes: the step anatomy's
calibration record, written before or after the step's dispatch.

    python3 anatomy_study.py              # 3 rounds of each placement
    python3 anatomy_study.py --rounds 5
    python3 anatomy_study.py --placements end --busy 8 --idle-threads 6
    python3 anatomy_study.py --placements end --order IPPI

Builds the kernels, then, per round and per placement of the calibration
record, builds make_train_step at bench_transformer's widths (bf16, batch
[8, 2049]) as chip_smoke.py's anatomy phase does and runs, after two warm-up
steps (``--warmup``), windows of ten steps each fenced by its loss readback:
the plain step (step_fn.__wrapped__), the instrumented, the instrumented,
the plain (``--order``, P plain and I instrumented).
``end`` is the shipped placement (StepStats writes the record at the
step_end of the dispatch that observed it, after its work is queued);
``begin`` writes it at that observation, before the dispatch, as the JAX
package's StepStats does. Prints one JSON line per round: every step's wall
(ms), the time of the record and the step it landed in, and the anatomy
check's margin (instrumented mean minus plain mean, against the larger of
1 % of the plain mean and twice the windows' spread); then the card's name
and power limit. Runs on the card only.

``--busy N`` runs N processes that spin on the host's cores, and
``--idle-threads M`` M threads of this process that wake once a second and
sleep again (as an idle checkpoint pipeline's threads do), both for the
whole run: the windows under a host whose cores are all taken.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
import threading
import time

import numpy as np

WARMUP, STEPS = 2, 10
NOISE = 0.01


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _spin(stop) -> None:
    while not stop.is_set():
        for _ in range(100_000):
            pass


def _idle(stop) -> None:
    while not stop.wait(timeout=1.0):
        pass


def one_round(torch, cfg, tokens, placement: str,
              order: str = "PIIP", warmup: int = WARMUP) -> dict:
    from tony_tpu_torch.models import make_train_step
    from tony_tpu_torch.observability import metrics, stepstats

    metrics._default_registry = metrics.MetricsRegistry()
    records: list[dict] = []
    clock = {"step": None}
    maybe_record = stepstats.StepStats._maybe_record
    observe = stepstats.StepStats._finish

    def timed_record(self):
        before, t0 = self._recorded_ms, time.perf_counter()
        maybe_record(self)
        if self._recorded_ms != before:
            records.append({"ms": (time.perf_counter() - t0) * 1e3,
                            "step": clock["step"]})

    def observe_then_record(self, draft, gap_ms=None):
        observe(self, draft, gap_ms)
        if self._record_due:
            self._record_due = False
            self._maybe_record()

    stepstats.StepStats._maybe_record = timed_record
    if placement == "begin":
        stepstats.StepStats._finish = observe_then_record
    try:
        init_fn, step_fn = make_train_step(cfg, device="cuda")
        state = init_fn(0)
        plain = step_fn.__wrapped__

        def window(fn, name):
            nonlocal state
            walls = []
            for i in range(STEPS):
                clock["step"] = f"{name}[{i}]"
                t0 = time.perf_counter()
                state, m = fn(state, tokens)
                float(m["loss"])
                walls.append((time.perf_counter() - t0) * 1e3)
            return walls

        for _ in range(warmup):
            state, m = step_fn(state, tokens)
            float(m["loss"])
        seq, seen = [], {"P": 0, "I": 0}
        for kind in order:
            name = f"{'plain' if kind == 'P' else 'inst'}{seen[kind]}"
            seen[kind] += 1
            seq.append((name, window(plain if kind == "P" else step_fn,
                                     name)))
    finally:
        stepstats.StepStats._maybe_record = maybe_record
        stepstats.StepStats._finish = observe
    means = {k: float(np.mean(v)) for k, v in seq}
    plain_w = [v for k, v in means.items() if k.startswith("plain")]
    inst_w = [v for k, v in means.items() if k.startswith("inst")]
    allowed = max(NOISE * float(np.mean(plain_w)),
                  2 * max(np.ptp(plain_w), np.ptp(inst_w)))
    del state, init_fn, step_fn, plain
    torch.cuda.empty_cache()
    return {"placement": placement, "window_means_ms": means,
            "walls_ms": dict(seq), "records": records,
            "inst_minus_plain_ms": float(np.mean(inst_w) - np.mean(plain_w)),
            "allowed_ms": allowed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--placements", default="end,begin",
                    help="comma-separated: end (shipped), begin")
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--order", default="PIIP",
                    help="the windows in turn: P plain, I instrumented "
                         "(chip_smoke.py's anatomy phase runs PIIP)")
    ap.add_argument("--busy", type=int, default=0,
                    help="processes spinning on the host's cores")
    ap.add_argument("--idle-threads", type=int, default=0,
                    help="threads that wake once a second")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("anatomy_study: CUDA is not available; this script runs on "
              "the card only", file=sys.stderr)
        return 1
    from tony_tpu_torch import kernels
    from tony_tpu_torch.models import TransformerConfig
    from tony_tpu_torch.parallel import plan as plan_lib

    import chip_smoke

    # As runtime.initialize does: the kernels and the measurement table
    # the records write go to the compile cache (default: the package's
    # gitignored build directory).
    plan_lib.configure_compile_cache()
    kernels.build()
    for name in kernels.KERNELS:
        kernels.function(name)
    cfg = TransformerConfig(dtype="bfloat16", **chip_smoke.BENCH_TRANSFORMER)
    tokens = torch.as_tensor(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (8, 2049)), device="cuda")
    placements = args.placements.split(",")
    ctx = multiprocessing.get_context("spawn")
    stop_busy, stop_idle = ctx.Event(), threading.Event()
    busy = [ctx.Process(target=_spin, args=(stop_busy,), daemon=True)
            for _ in range(args.busy)]
    idle = [threading.Thread(target=_idle, args=(stop_idle,), daemon=True)
            for _ in range(args.idle_threads)]
    try:
        for t in busy + idle:
            t.start()
        for r in range(args.rounds):
            for placement in (placements if r % 2 == 0
                              else placements[::-1]):
                out = one_round(torch, cfg, tokens, placement,
                                args.order, args.warmup)
                print(json.dumps({"round": r, "order": args.order,
                                  "warmup": args.warmup,
                                  "busy": args.busy,
                                  "idle_threads": args.idle_threads,
                                  **out}), flush=True)
    finally:
        stop_busy.set()
        stop_idle.set()
        for p in busy:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        for t in idle:
            t.join(5)
    print(_card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
