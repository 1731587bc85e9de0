"""A cell as ``BENCHMARK.json`` names it, resolved to its data files.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name: ``configs/<config>.json`` (the file the
configuration entry names), ``traffic/<traffic>.json``,
``limits/<workload>.json`` (the limits of the comparison that decides
``correct``) and ``metrics/<metric>.py`` (a reader with ``read(r)``).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _reports(metric: dict, workload: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(workload: str, bench: dict | None = None,
              bench_dir: Path = BENCH_DIR, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``bench`` (default: the repo's
    ``BENCHMARK.json``). Raises ``KeyError`` for a name it does not hold."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads(
        (bench_dir / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, int(entry["chips"]), entry["config"], config,
                traffic, limits, e2e, per_layer)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``metrics/<name>.py``'s ``read``, loaded by path: a metric's name
    may hold dots and dashes."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
