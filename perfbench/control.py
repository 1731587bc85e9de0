"""The readings that the limits of ``limits/<workload>.json`` are set
from (not part of a run): for each seed, the program's first train steps
and the fp32 reference's (the configuration's family's), and on some
seeds the fp8 control (the reference one precision below the
configuration's bfloat16) and the program with each planted fault
(``lib/faults.py``), every reading held against the fp32 reference of
its seed. One JSON line a reading to ``--out``, and a summary: the lower
reading of each number (the largest over the program's seeds), the
control's and each fault's smallest.

    python3 perfbench/control.py --workload mistral-train-4k \\
        --seeds 11,12,... --control-seeds 11,12,13 --fault-seeds 11,12,13 \\
        --out control-mistral-train-4k.jsonl
"""

import argparse
import contextlib
import json
import os
import sys
import time


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    from perfbench.lib import cli, compare, faults, spec

    os.environ.update(cli.ENV)
    cell = spec.load_cell(args.workload)
    import torch

    from perfbench.lib import cell as cell_lib
    from tony_tpu_torch import runtime

    s = cell.family.shape(cell.config)
    tr = cell.traffic
    steps = int(cell.limits["check_steps"])
    dev = torch.device(runtime.initialize(device="cuda").device)
    found = {"program": [], "control": []}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        def note(kind, seed, ref, readings, t):
            g = compare.gaps(readings, ref)
            line = {"kind": kind, "seed": seed, "s": time.perf_counter() - t,
                    **{k: v[0] for k, v in g.items()},
                    "where": {k: v[1] for k, v in g.items()},
                    "loss": readings["loss"], "ref_loss": ref["loss"]}
            found.setdefault(kind, []).append(line)
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps(line), flush=True)

        for seed in sorted(set(args.seeds) | set(args.control_seeds)
                           | set(args.fault_seeds)):
            ref = cell_lib.reference_readings(s, tr, steps, seed, dev)
            runs = ([("program", contextlib.nullcontext)]
                    if seed in args.seeds else [])
            runs += [(name, f) for name, f in faults.FAULTS.items()
                     if seed in args.fault_seeds]
            for kind, planted in runs:
                t = time.perf_counter()
                with planted():
                    prog = cell_lib.set_up(s, tr, steps, seed, dev, torch)
                prog.close(torch)
                note(kind, seed, ref, prog.readings, t)
            if seed in args.control_seeds:
                t = time.perf_counter()
                low = cell_lib.reference_readings(s, tr, steps, seed, dev,
                                                 "fp8")
                note("control", seed, ref, low, t)
    summary = {}
    for kind, lines in found.items():
        if not lines:
            continue
        pick = max if kind == "program" else min
        summary[kind] = {n: pick(x[n] for x in lines)
                         for n in compare.NUMBERS}
        summary[kind]["seeds"] = len(lines)
    print("summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
