"""The Mistral family's own numbers (``families/mistral.py``, and
``mixtral.py`` under Mixtral's name): its two configurations state the
published widths of Mistral-7B-v0.3 and Mixtral-8x7B-v0.1
(``config.json``), and its counts agree with hand counts. The checks of
``test_perfbench_files.py`` hold every family alike; these are named
here by configuration and cell, so that they cannot go vacuous."""

import json

import pytest

from perfbench.families import mistral as family
from perfbench.lib import counts, spec
from perfbench.lib.shape import Shape

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]
CONFIGS = ("mistral-7b-v0.3-l10", "mixtral-8x7b-l2")
CELLS = ("mistral-train-4k", "mixtral-train-4k", "mistral-train-32k")


def _config(name):
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    return json.loads((spec.ROOT / entry["file"]).read_text())


def _shape(name):
    return Shape.from_config(_config(name))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_states_the_published_widths(name):
    c = _config(name)
    assert spec.family(c["model_type"]).shape is family.shape
    # Published widths, never cut.
    assert (c["hidden_size"], c["intermediate_size"], c["head_dim"],
            c["num_attention_heads"], c["num_key_value_heads"]) == \
        (4096, 14336, 128, 32, 8)
    s = _shape(name)
    assert s.d % s.heads == 0 and s.heads % s.kv_heads == 0


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_a_configuration_of_the_family(workload):
    cell = spec.load_cell(workload)
    assert cell.config_name in CONFIGS
    s = cell.family.shape(cell.config)
    assert isinstance(s, family.MistralShape)
    assert s.d % s.heads == 0 and s.heads % s.kv_heads == 0


def test_counts_match_hand_counts():
    mistral, mixtral = _shape("mistral-7b-v0.3-l10"), \
        _shape("mixtral-8x7b-l2")
    # Per layer: q/k/v/o 4096 * (32 + 8 + 8) * 128 + 32 * 128 * 4096,
    # SwiGLU 3 * 4096 * 14336 (twice for top-2), router 4096 * 8; then
    # the unembedding 4096 * vocab.
    assert family.matmul_params(mistral) == \
        10 * (25_165_824 + 16_777_216 + 176_160_768) + 4096 * 32768
    assert family.matmul_params(mistral) == 2_315_255_808
    assert family.matmul_params(mixtral) == \
        2 * (41_943_040 + 352_321_536 + 32_768) + 4096 * 32000
    for s, b, t, want in ((mistral, 4, 4096, 2.4409e14),
                          (mixtral, 4, 4096, 9.3705e13),
                          (mistral, 1, 32768, 7.1908e14)):
        hand = (6.0 * family.matmul_params(s) * b * t
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
