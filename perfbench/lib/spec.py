"""A cell as ``BENCHMARK.json`` names it, resolved to its data files.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name: ``configs/<config>.json`` (the file the
configuration entry names), ``families/<model_type>.py`` (the code of the
configuration's architecture, ``lib/family.py``), ``traffic/<traffic>.json``,
``limits/<workload>.json`` (the limits of the comparison that decides
``correct``) and ``metrics/<metric>.py`` (a reader with ``read(r)``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

from perfbench.lib import family as family_lib

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FAMILIES = BENCH_DIR / "families"
MODEL_TYPE = re.compile(r"^[A-Za-z0-9_]{1,64}$")


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
    family: ModuleType | None = None


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
    config_file = root / configs[entry["config"]]["file"]
    config = json.loads(config_file.read_text())
    if "model_type" not in config:
        raise KeyError(f"{config_file} states no model_type")
    fam = family(config["model_type"], bench_dir)
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
                traffic, limits, e2e, per_layer, fam)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``metrics/<name>.py``'s ``read``, loaded by path: a metric's name
    may hold dots and dashes."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def family(model_type: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The family module of ``model_type``: ``families/<model_type>.py``
    under ``bench_dir``, else under the harness's own directory. Raises
    ``LookupError`` where there is none, and ``TypeError`` where the
    module lacks a member of ``lib.family.Family``."""
    dirs = list(dict.fromkeys((Path(bench_dir) / "families", FAMILIES)))
    paths = [d / f"{model_type}.py" for d in dirs]
    found = [p for p in paths if p.is_file()] \
        if MODEL_TYPE.match(str(model_type)) else []
    if not found:
        raise LookupError(
            f"model_type {model_type!r}: no family module "
            f"{' or '.join(str(p) for p in paths)}")
    module = load_module(found[0])
    lacks = family_lib.missing(module)
    if lacks:
        raise TypeError(f"family module {found[0]} lacks {lacks}")
    return module


def load_module(path: Path) -> ModuleType:
    """The module of the file ``path``, loaded once a process: a family
    of the harness's own as ``perfbench.families.<name>``, any other file
    (a family or reference file brought with test data) by its path."""
    path = Path(path).resolve()
    if path.parent == FAMILIES:
        return importlib.import_module(f"perfbench.families.{path.stem}")
    name = "perfbench_file_" + re.sub(r"\W", "_", str(path.with_suffix("")))
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]
