"""On a machine with a card (``python -m pytest perfbench/tests -q -m
chip``): a short run of every cell, plain and traced, comes out correct
with every metric the benchmark names. Skips without a card."""

import json
import subprocess
import sys

import pytest

from perfbench.lib import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.chip
@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_is_correct(cuda_card, workload, trace):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2 ** 32 + 101), "--seconds", "3", "--trace",
         str(trace)], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=900, check=True).stdout
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    cell = spec.load_cell(workload)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) == {m["name"] for m in want}
    assert result["device"]["platform"] == "gpu"
