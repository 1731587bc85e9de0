"""BENCHMARK.json against the benchmark's files and the contract's
limits, and the counts against hand counts."""

import json
import re

import pytest

from perfbench.lib import counts, feed, spec
from perfbench.lib.shape import Shape

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(workload):
    cell = spec.load_cell(workload)
    feed.check(cell.traffic)
    s = Shape.from_config(cell.config)
    assert s.d % s.heads == 0 and s.heads % s.kv_heads == 0
    assert set(cell.limits) == {"check_steps", "loss_gap", "grad_gap",
                                "change_gap"}
    assert cell.limits["check_steps"] in (2, 3)
    assert 0 < min(cell.limits.values())
    assert cell.end_to_end and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert cell.chips == 1


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_cut(entry):
    c = json.loads((spec.ROOT / entry["file"]).read_text())
    assert c["source"].startswith("https://huggingface.co/")
    assert sorted(c["reduced"]) == sorted(entry["reduced"])
    assert c["assumed"] and c["deployment"]
    # Published widths, never cut.
    assert (c["hidden_size"], c["intermediate_size"], c["head_dim"],
            c["num_attention_heads"], c["num_key_value_heads"]) == \
        (4096, 14336, 128, 32, 8)


def test_every_metric_file_is_named_in_the_benchmark():
    files = {p.stem for p in (spec.BENCH_DIR / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


def _shape(name):
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    return Shape.from_config(json.loads((spec.ROOT / entry["file"])
                                        .read_text()))


def test_counts_match_hand_counts():
    mistral, mixtral = _shape("mistral-7b-v0.3-l10"), \
        _shape("mixtral-8x7b-l2")
    # Per layer: q/k/v/o 4096 * (32 + 8 + 8) * 128 + 32 * 128 * 4096,
    # SwiGLU 3 * 4096 * 14336 (twice for top-2), router 4096 * 8; then
    # the unembedding 4096 * vocab.
    assert counts.matmul_params(mistral) == \
        10 * (25_165_824 + 16_777_216 + 176_160_768) + 4096 * 32768
    assert counts.matmul_params(mistral) == 2_315_255_808
    assert counts.matmul_params(mixtral) == \
        2 * (41_943_040 + 352_321_536 + 32_768) + 4096 * 32000
    for s, b, t, want in ((mistral, 4, 4096, 2.4409e14),
                          (mixtral, 4, 4096, 9.3705e13),
                          (mistral, 1, 32768, 7.1908e14)):
        hand = (6.0 * counts.matmul_params(s) * b * t
                + 6.0 * s.layers * b * s.heads * s.head_dim * t * (t + 1))
        assert counts.model_flops(s, b, t) == pytest.approx(hand, rel=1e-12)
        assert counts.model_flops(s, b, t) == pytest.approx(want, rel=1e-4)
    # Attention at 4k: six products over 4 * 32 * 4096 * 4097 / 2 pairs,
    # bound by operations; RMSNorm: 21 norms of 16384 x 4096 bf16 read and
    # written, bound by bytes.
    pairs = 4 * 32 * 4096 * 4097 // 2
    assert counts.attention_least_s(mistral, 4, 4096, H100) == \
        pytest.approx(10 * 12 * 128 * pairs / 989e12, rel=1e-12)
    assert counts.rms_norm_least_s(mistral, 4, 4096, H100) == \
        pytest.approx(21 * (4 * 16384 * 4096 + 4096 * 4) / 3.35e12,
                      rel=1e-12)


def test_feed_is_a_function_of_seed_and_step():
    tr = {"kind": "train", "batch": 2, "seq": 8, "ids": "uniform",
          "trace_steps": 1}
    a = feed.batch(tr, 100, 2 ** 40 + 3, 5)
    assert a.shape == (2, 9) and a.dtype.name == "int64"
    assert (a == feed.batch(tr, 100, 2 ** 40 + 3, 5)).all()
    assert not (a == feed.batch(tr, 100, 2 ** 40 + 3, 6)).all()
    assert 0 <= a.min() and a.max() < 100
