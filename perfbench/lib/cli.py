"""``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell, its result as the last line of
standard output."""

from __future__ import annotations

import argparse
import json
import os
import sys

from perfbench.lib import spec

# Every build and kernel cache at a fixed path inside the checkout, so that
# only a checkout's first run builds; the tune record directory is the
# committed one (empty unless a change adds a record).
CACHE = spec.BENCH_DIR / ".cache"
ENV = {
    "TONY_COMPILE_CACHE_DIR": str(CACHE / "compile"),
    "TONY_TUNE_RECORD_DIR": str(spec.BENCH_DIR / "tune"),
    "TRITON_CACHE_DIR": str(CACHE / "triton"),
    "TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
    "TORCHINDUCTOR_CACHE_DIR": str(CACHE / "inductor"),
    "CUDA_CACHE_PATH": str(CACHE / "nv"),
    "USE_FLAX": "0",
}


def parse(argv):
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv, *, started: float) -> int:
    args = parse(argv)
    if args.seconds <= 0:
        say("--seconds must be above 0")
        return 2
    # Before the cell's family is loaded: it imports torch.
    os.environ.update(ENV)
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        say("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    from perfbench.lib import cell as cell_lib

    result, checks = cell_lib.run(cell, args.seed, args.seconds,
                                  bool(args.trace), started=started)
    banned = cell_lib.loaded_jax()
    if banned:
        say(f"the run loaded {banned}: the benchmark may load neither JAX "
            f"nor the JAX package")
        return 3
    return emit(result, checks)


def emit(result: dict, checks: dict) -> int:
    """The checks as the last lines of standard error, then the result
    line, the checks last in it."""
    for name, c in checks.items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"(worst at {c['where']})")
    say(f"correct {result['correct']}")
    result = dict(result)
    result["checks"] = {name: {"value": c["value"], "limit": c["limit"]}
                        for name, c in checks.items()}
    print(json.dumps(result), flush=True)
    return 0
