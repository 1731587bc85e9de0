"""A configuration's ``model_type`` finds its family module, and the
shared machinery walks whatever leaf table a family gives. The toy
family under ``data/`` (``families/toy_decoder.py``, its reference
``reference/toy_decoder.py``, ``configs/toy.json``,
``limits/toy-train.json`` and ``bench-toy.json``) is a second
architecture added by new files only. Its limits were set from the
program's readings over 14 seeds (loss 3.62e-4, grad 1.38e-3, change
1.71e-3 at most) against half a batch's least over 3 (1.06e-2, 3.21e-2,
0.157) and an unchanged state's (grad and change 1)."""

import json
import math
import time
from pathlib import Path

import pytest
import torch

from perfbench.lib import cell as cell_lib, compare, counts, faults, spec
from perfbench.lib import trace, weights
from perfbench.tests.helpers import DATA, SEED

TOY = "toy-train"
H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]


def _toy():
    bench = json.loads((DATA / "bench-toy.json").read_text())
    return spec.load_cell(TOY, bench, bench_dir=DATA, root=DATA)


def _run(seconds=0.2, traced=False):
    return cell_lib.run(_toy(), SEED, seconds, traced,
                        started=time.perf_counter(), device="cpu")


def test_the_toy_family_comes_from_the_test_data():
    cell = _toy()
    for module in (cell.family, cell.family.reference):
        assert Path(module.__file__).is_relative_to(DATA), module.__file__
    assert cell.config["model_type"] == "toy_decoder"
    assert "hidden_size" not in cell.config


def test_a_cell_of_the_toy_family_is_correct():
    result, checks = _run()
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_half_a_batch_of_the_toy_family_is_not_correct():
    with faults.half_batch():
        result, checks = _run()
    assert not result["correct"], checks


def test_the_readers_count_with_the_cells_family():
    """``step_mfu``, ``flash_roofline`` and ``rms_norm_roofline`` read the
    work from ``r.family``: here the toy's counts."""
    cell = _toy()
    s = cell.family.shape(cell.config)
    b, t = int(cell.traffic["batch"]), int(cell.traffic["seq"])
    events = [trace.DeviceEvent("flash_fwd_kernel", 0.0, 1000.0),
              trace.DeviceEvent("rms_norm_kernel", 0.0, 10.0)]
    r = cell_lib.Readings(s, cell.family, cell.traffic, 1, H100, 5, 2.0,
                          b * t, [], trace.Trace(1, 1.0, 1.0, events))
    fam = cell.family
    want = {
        "step_mfu": 100.0 * fam.model_flops(s, b, t) * 5 / 2.0 / 989e12,
        "flash_roofline": 100.0 * fam.attention_least_s(s, b, t, H100)
        / 1e-3,
        "rms_norm_roofline": 100.0 * fam.rms_norm_least_s(s, b, t, H100)
        / 1e-5,
    }
    for name, value in want.items():
        assert spec.metric_reader(name)(r) == pytest.approx(value,
                                                            rel=1e-12)


# Two stacks, nested up to three deep: 2 dense layers, split on 1 piece
# axis, beside 3 expert layers whose experts split on 2.
D, F, E, V = 6, 5, 4, 11
TWO_STACKS = {
    "embed": ((V, D), 1.0, 0),
    "dense_layers.ln": ((2, D), 0.0, 1),
    "dense_layers.mlp.w_up": ((2, D, F), D ** -0.5, 1),
    "layers.router": ((3, D, E), D ** -0.5, 1),
    "layers.experts.w_up": ((3, E, D, F), D ** -0.5, 2),
    "layers.shared.w_up": ((3, D, F), D ** -0.5, 1),
    "final_norm": ((D,), 0.0, 0),
}


def test_a_table_of_two_stacks_is_walked_leaf_by_leaf():
    tree = weights.draw(TWO_STACKS, SEED, "cpu")
    assert set(tree) == {"embed", "dense_layers", "layers", "final_norm"}
    assert set(tree["layers"]["experts"]) == {"w_up"}
    items = weights.leaf_items(tree)
    assert [p for p, _ in items] == list(TWO_STACKS)
    for path, leaf in items:
        shape, scale, axes = TWO_STACKS[path]
        assert tuple(leaf.shape) == shape
        # The pieces fill the leaf once each, and each draws again alike.
        hits = torch.zeros(shape)
        for (layer, expert), index in weights.pieces(path, TWO_STACKS):
            hits[index] += 1
            again = weights.fill_piece(torch.empty(shape[len(index):]),
                                       SEED, path, layer, expert, scale)
            assert torch.equal(leaf[index], again)
        assert bool((hits == 1).all()), path
        assert len(weights.pieces(path, TWO_STACKS)) == \
            math.prod(shape[:axes])
        assert torch.equal(weights.draw_leaf(TWO_STACKS, SEED, path, "cpu"),
                           leaf)
    assert not torch.equal(tree["layers"]["experts"]["w_up"][0, 0],
                           tree["layers"]["experts"]["w_up"][0, 1])


@pytest.mark.parametrize("moved", list(TWO_STACKS))
def test_a_change_to_one_leaf_of_two_stacks_shows_there_alone(moved):
    tree = weights.draw(TWO_STACKS, SEED, "cpu")
    start = {k: float(v) for k, v in
             weights.change_norms(TWO_STACKS, SEED, tree).items()}
    assert start == {k: 0.0 for k in TWO_STACKS}
    leaf = weights.get(tree, moved)
    leaf.view(-1)[-1] += 1.0
    change = {k: float(v) for k, v in
              weights.change_norms(TWO_STACKS, SEED, tree).items()}
    assert change.pop(moved) == pytest.approx(1.0, rel=1e-6)
    assert change == {k: 0.0 for k in TWO_STACKS if k != moved}
    # The comparison reads every leaf: a gap in one is found there.
    ref = {"loss": [1.0], "grad": {k: 1.0 for k in TWO_STACKS},
           "change": {k: 1.0 for k in TWO_STACKS}}
    prog = {"loss": [1.0],
            "grad": {k: 2.0 if k == moved else 1.0 for k in TWO_STACKS},
            "change": {k: 3.0 if k == moved else 1.0 for k in TWO_STACKS}}
    found = compare.gaps(prog, ref)
    assert found["grad_gap"] == (1.0, moved)
    assert found["change_gap"] == (2.0, moved)


def test_an_unknown_model_type_names_itself_and_where_it_looked():
    with pytest.raises(LookupError) as err:
        spec.family("no_such_family", DATA)
    message = str(err.value)
    assert "'no_such_family'" in message
    assert str(DATA / "families" / "no_such_family.py") in message
    assert str(spec.FAMILIES / "no_such_family.py") in message
    with pytest.raises(LookupError, match="'../mistral'"):
        spec.family("../mistral")


def test_mixtral_is_the_mistral_family_under_its_name():
    mistral, mixtral = spec.family("mistral"), spec.family("mixtral")
    assert mixtral is not mistral
    for member in ("shape", "port_config", "leaf_table", "model_flops",
                   "attention_least_s", "rms_norm_least_s", "reference"):
        assert getattr(mixtral, member) is getattr(mistral, member)
