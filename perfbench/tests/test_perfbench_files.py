"""BENCHMARK.json against the benchmark's files and the contract's
limits, by checks that hold every family alike.

Each check is a function of the benchmark (``BENCHMARK.json``'s object),
the directory of the harness's data files and the root that a
configuration's ``file`` starts from, and, for a configuration or a
cell, its name. The tests below run them over the repo's benchmark, so
every configuration and cell a later change adds meets them; a family's
own numbers (published widths, hand counts) are pinned by its own test
file, ``test_<model_type>_family.py``. The last tests add a family the
harness does not hold to a copy of the repo's benchmark by new files
only, and see every check pass there and a planted fault fail."""

import copy
import json
import math
import re
import shutil

import pytest

from perfbench.lib import counts, family, feed, spec
from perfbench.lib.shape import Shape
from perfbench.tests.helpers import DATA

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]
# Published widths: never cut. Head, expert and vocabulary counts may be
# cut to the chip's share, with a reason.
WIDTHS = ("hidden_size", "intermediate_size", "moe_intermediate_size",
          "shared_expert_intermediate_size", "head_dim", "sliding_window",
          "num_experts_per_tok", "kv_lora_rank", "q_lora_rank")
LIMITS = {"check_steps", "loss_gap", "grad_gap", "change_gap"}
GROUPS = ("configs", "workloads", "end_to_end", "per_layer")


# The benchmark as a whole.

def top_level_keys_and_names(bench, bench_dir, root):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    for group in GROUPS:
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    assert all(any(f.startswith(p.rstrip("/") + "/") for p in bench["paths"])
               for f in files)


def every_metric_file_is_named(bench, bench_dir, root):
    files = {p.stem for p in (bench_dir / "metrics").glob("*.py")}
    assert files == {m["name"] for m in bench["per_layer"]}


# A configuration.

def _config(bench, root, name):
    entry = {c["name"]: c for c in bench["configs"]}[name]
    return entry, json.loads((root / entry["file"]).read_text())


def source_is_a_hub_url(bench, bench_dir, root, name):
    _, c = _config(bench, root, name)
    assert c["source"].startswith("https://huggingface.co/"), c["source"]


def model_type_finds_its_family(bench, bench_dir, root, name):
    _, c = _config(bench, root, name)
    assert "model_type" in c
    spec.family(c["model_type"], bench_dir)


def reduced_keys_carry_reasons(bench, bench_dir, root, name):
    entry, c = _config(bench, root, name)
    assert sorted(c["reduced"]) == sorted(entry["reduced"])
    for key, why in c["reduced"].items():
        assert isinstance(why, str) and why.strip(), key


def assumed_and_deployment_are_stated(bench, bench_dir, root, name):
    _, c = _config(bench, root, name)
    assert c["assumed"] and c["deployment"]


def no_width_is_cut(bench, bench_dir, root, name):
    entry, c = _config(bench, root, name)
    cut = sorted(k for k in set(c["reduced"]) | set(entry["reduced"])
                 if k in WIDTHS or k.endswith(("_dim", "_rank")))
    assert not cut, f"{name} cuts published widths {cut}"


# A cell.

def _cell(bench, bench_dir, root, name):
    cell = spec.load_cell(name, bench, bench_dir, root)
    return cell, cell.family.shape(cell.config)


def cell_loads_by_name(bench, bench_dir, root, name):
    cell = spec.load_cell(name, bench, bench_dir, root)
    feed.check(cell.traffic)
    assert cell.end_to_end and cell.per_layer


def shape_is_a_shape_of_its_family(bench, bench_dir, root, name):
    cell, s = _cell(bench, bench_dir, root, name)
    assert isinstance(s, Shape) and s.vocab > 0
    # The shape's class lives in a module that gives the cell's family,
    # as the harness's walks over weights and counts find it.
    assert all(getattr(family.of(s), m) is getattr(cell.family, m)
               for m in family.MEMBERS)


def leaf_table_is_sound(bench, bench_dir, root, name):
    cell, s = _cell(bench, bench_dir, root, name)
    table = cell.family.leaf_table(s)
    assert table
    for path, (dims, scale, axes) in table.items():
        assert dims and all(int(n) > 0 for n in dims), path
        assert axes in (0, 1, 2) and axes <= len(dims), path
        assert math.isfinite(scale) and scale >= 0, path


def experts_have_expert_leaves(bench, bench_dir, root, name):
    cell, s = _cell(bench, bench_dir, root, name)
    table = cell.family.leaf_table(s)
    two_axes = [p for p, (_, _, axes) in table.items() if axes == 2]
    assert (s.experts > 0) == bool(two_axes), (s.experts, two_axes)


def counts_are_finite_and_positive(bench, bench_dir, root, name):
    cell, s = _cell(bench, bench_dir, root, name)
    b, t = int(cell.traffic["batch"]), int(cell.traffic["seq"])
    fam = cell.family
    for value in (fam.model_flops(s, b, t),
                  fam.attention_least_s(s, b, t, H100),
                  fam.rms_norm_least_s(s, b, t, H100)):
        assert math.isfinite(value) and value > 0


def port_config_builds(bench, bench_dir, root, name):
    cell, s = _cell(bench, bench_dir, root, name)
    assert cell.family.port_config(s) is not None


def limits_are_the_comparisons(bench, bench_dir, root, name):
    cell = spec.load_cell(name, bench, bench_dir, root)
    assert set(cell.limits) == LIMITS
    assert cell.limits["check_steps"] in (2, 3)
    assert 0 < min(cell.limits.values())


def every_reader_loads(bench, bench_dir, root, name):
    cell = spec.load_cell(name, bench, bench_dir, root)
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"], bench_dir))


def one_chip(bench, bench_dir, root, name):
    # ``cell.run`` drives one process on one card.
    assert spec.load_cell(name, bench, bench_dir, root).chips == 1


BENCH_CHECKS = (top_level_keys_and_names, every_metric_file_is_named)
CONFIG_CHECKS = (source_is_a_hub_url, model_type_finds_its_family,
                 reduced_keys_carry_reasons, assumed_and_deployment_are_stated,
                 no_width_is_cut)
CELL_CHECKS = (cell_loads_by_name, shape_is_a_shape_of_its_family,
               leaf_table_is_sound, experts_have_expert_leaves,
               counts_are_finite_and_positive, port_config_builds,
               limits_are_the_comparisons, every_reader_loads, one_chip)


def failures(bench, bench_dir, root) -> list:
    """(check, name) of every check that fails on ``bench``: every
    configuration and cell under each of its kind's checks."""
    runs = [(c, ()) for c in BENCH_CHECKS]
    runs += [(c, (e["name"],)) for c in CONFIG_CHECKS
             for e in bench["configs"]]
    runs += [(c, (w["name"],)) for c in CELL_CHECKS
             for w in bench["workloads"]]
    found = []
    for check, name in runs:
        try:
            check(bench, bench_dir, root, *name)
        except Exception:
            found.append((check.__name__, *name))
    return found


def _name(check):
    return check.__name__


@pytest.mark.parametrize("check", BENCH_CHECKS, ids=_name)
def test_top_level_keys_and_names(check):
    check(BENCH, spec.BENCH_DIR, spec.ROOT)


@pytest.mark.parametrize("check", CONFIG_CHECKS, ids=_name)
@pytest.mark.parametrize("entry", [c["name"] for c in BENCH["configs"]])
def test_config_files_state_their_cut(entry, check):
    check(BENCH, spec.BENCH_DIR, spec.ROOT, entry)


@pytest.mark.parametrize("check", CELL_CHECKS, ids=_name)
@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(workload, check):
    check(BENCH, spec.BENCH_DIR, spec.ROOT, workload)


def test_feed_is_a_function_of_seed_and_step():
    tr = {"kind": "train", "batch": 2, "seq": 8, "ids": "uniform",
          "trace_steps": 1}
    a = feed.batch(tr, 100, 2 ** 40 + 3, 5)
    assert a.shape == (2, 9) and a.dtype.name == "int64"
    assert (a == feed.batch(tr, 100, 2 ** 40 + 3, 5)).all()
    assert not (a == feed.batch(tr, 100, 2 ** 40 + 3, 6)).all()
    assert 0 <= a.min() and a.max() < 100


# A further family by new files only: the toy decoder of ``data/``, whose
# entries are ``data/further.json`` and whose files land beside the
# repo's as a change that adds a model would put them.
COPIED = ("configs", "traffic", "limits", "families", "reference",
          "metrics")
NEW_FILES = {
    "configs/toy-l3.json": "configs/toy-stated.json",
    "families/toy_decoder.py": "families/toy_decoder.py",
    "reference/toy_decoder.py": "reference/toy_decoder.py",
    "traffic/tiny.json": "traffic/tiny.json",
    "limits/toy-train.json": "limits/toy-train.json",
}


def _repo_files() -> list:
    """The benchmark's data files under ``COPIED``, relative to the
    harness's directory."""
    return sorted(p.relative_to(spec.BENCH_DIR)
                  for d in COPIED for p in (spec.BENCH_DIR / d).rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts)


def _further_tree(root):
    """The repo's benchmark with the toy family's configuration and cell
    added: ``root``'s ``BENCHMARK.json`` and ``perfbench/``, whose
    path it returns."""
    bench_dir = root / spec.BENCH_DIR.name
    for rel in _repo_files():
        (bench_dir / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(spec.BENCH_DIR / rel, bench_dir / rel)
    for rel, data in NEW_FILES.items():
        assert not (spec.BENCH_DIR / rel).exists(), rel
        shutil.copyfile(DATA / data, bench_dir / rel)
    bench = copy.deepcopy(BENCH)
    for group, entries in json.loads(
            (DATA / "further.json").read_text()).items():
        bench[group] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return bench_dir


def test_a_further_family_passes_by_new_files_only(tmp_path):
    bench_dir = _further_tree(tmp_path)
    # Nothing of the repo's is edited: its files byte for byte, its
    # entries in their places, only entries appended.
    for rel in _repo_files():
        assert (bench_dir / rel).read_bytes() == \
            (spec.BENCH_DIR / rel).read_bytes(), rel
    merged = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key, value in BENCH.items():
        if key in GROUPS:
            assert merged[key][:len(value)] == value, key
        else:
            assert merged[key] == value, key
    assert [c["name"] for c in merged["configs"][len(BENCH["configs"]):]] \
        == ["toy-l3"]
    assert [w["name"] for w in
            merged["workloads"][len(BENCH["workloads"]):]] == ["toy-train"]
    cell = spec.load_cell("toy-train", merged, bench_dir, tmp_path)
    assert cell.config["model_type"] == "toy_decoder"
    assert cell.config["model_type"] not in \
        {p.stem for p in spec.FAMILIES.glob("*.py")}
    assert failures(merged, bench_dir, tmp_path) == []


def _edit_json(path, edit):
    value = json.loads(path.read_text())
    edit(value)
    path.write_text(json.dumps(value, indent=1))


def test_a_cut_width_fails_the_generic_checks(tmp_path):
    bench_dir = _further_tree(tmp_path)
    _edit_json(bench_dir / "configs/toy-l3.json", lambda c: c["reduced"]
               .update(hidden_size="planted: a width cut"))
    _edit_json(tmp_path / "BENCHMARK.json", lambda b: b["configs"][-1]
               ["reduced"].append("hidden_size"))
    merged = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert failures(merged, bench_dir, tmp_path) == \
        [("no_width_is_cut", "toy-l3")]


def test_experts_without_expert_leaves_fail_the_generic_checks(tmp_path):
    bench_dir = _further_tree(tmp_path)
    path = bench_dir / "families/toy_decoder.py"
    path.write_text(path.read_text() + (
        "\n\n_shape = shape\n\n\n"
        "def shape(c):\n"
        "    import dataclasses\n"
        "    return dataclasses.replace(_shape(c), experts=4)\n"))
    merged = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert failures(merged, bench_dir, tmp_path) == \
        [("experts_have_expert_leaves", "toy-train")]
