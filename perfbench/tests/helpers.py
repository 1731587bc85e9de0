"""Shared by the benchmark's tests: the tiny cells under ``data/``."""

import copy
import json
from pathlib import Path

from perfbench.lib import spec

DATA = Path(__file__).resolve().parent / "data"
TINY = ("tiny-dense-train", "tiny-moe-train")
SEED = 2 ** 33 + 17  # past 32 bits: a run takes any seed that large


def bench() -> dict:
    return json.loads((DATA / "bench.json").read_text())


def tiny_cell(workload: str, *, dtype: str | None = None) -> spec.Cell:
    cell = spec.load_cell(workload, bench(), bench_dir=DATA, root=DATA)
    if dtype is not None:
        cell.config = copy.deepcopy(cell.config)
        cell.config["run"]["compute_dtype"] = dtype
    return cell
