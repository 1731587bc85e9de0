"""A toy family, brought with the test data as a later architecture
brings its own files: its ``model_type`` ("toy_decoder") finds this
file, it reads configuration keys of its own names, builds the port's
dense model, and brings its own reference file and counts."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from perfbench.lib.shape import Shape, run_settings
from perfbench.lib.spec import load_module

reference = load_module(Path(__file__).resolve().parent.parent
                        / "reference" / "toy_decoder.py")


@dataclass(frozen=True, kw_only=True)
class ToyShape(Shape):
    width: int
    depth: int
    query_heads: int
    kv_groups: int
    head_width: int
    mlp_width: int
    context: int
    rotary_base: float


def shape(c: dict) -> ToyShape:
    return ToyShape(vocab=int(c["tokens"]), width=int(c["width"]),
                    depth=int(c["depth"]), query_heads=int(c["query_heads"]),
                    kv_groups=int(c["kv_groups"]),
                    head_width=int(c["head_width"]),
                    mlp_width=int(c["mlp_width"]), context=int(c["context"]),
                    rotary_base=float(c["rotary_base"]), **run_settings(c))


def port_config(s: ToyShape):
    from tony_tpu_torch.models import TransformerConfig

    return TransformerConfig(
        vocab_size=s.vocab, d_model=s.width, n_layers=s.depth,
        n_heads=s.query_heads, n_kv_heads=s.kv_groups,
        head_dim=s.head_width, d_ff=s.mlp_width, max_seq=s.context,
        rope_theta=s.rotary_base, dtype=s.compute_dtype)


def leaf_table(s: ToyShape) -> dict:
    d, h, g, k, f, n = (s.width, s.query_heads, s.kv_groups, s.head_width,
                        s.mlp_width, s.depth)
    return {
        "embed": ((s.vocab, d), 1.0, 0),
        "layers.ln1": ((n, d), 0.0, 1),
        "layers.wq": ((n, d, h, k), d ** -0.5, 1),
        "layers.wk": ((n, d, g, k), d ** -0.5, 1),
        "layers.wv": ((n, d, g, k), d ** -0.5, 1),
        "layers.wo": ((n, h, k, d), (h * k) ** -0.5, 1),
        "layers.ln2": ((n, d), 0.0, 1),
        "layers.w_gate": ((n, d, f), d ** -0.5, 1),
        "layers.w_up": ((n, d, f), d ** -0.5, 1),
        "layers.w_down": ((n, f, d), f ** -0.5, 1),
        "final_norm": ((d,), 0.0, 0),
        "unembed": ((d, s.vocab), d ** -0.5, 0),
    }


def _pairs(s: ToyShape, batch: int, seq: int) -> int:
    return batch * s.query_heads * seq * (seq + 1) // 2


def model_flops(s: ToyShape, batch: int, seq: int) -> float:
    """Forward and backward: three times the forward's 2 flops a weight a
    token and 4 D a visible pair a layer."""
    weights = s.depth * (s.width * s.head_width * (2 * s.query_heads
                                                   + 2 * s.kv_groups)
                         + 3 * s.width * s.mlp_width) + s.width * s.vocab
    forward = 2.0 * weights * batch * seq \
        + 4.0 * s.head_width * _pairs(s, batch, seq) * s.depth
    return 3.0 * forward


def attention_least_s(s: ToyShape, batch: int, seq: int,
                      chip: dict) -> float:
    """Six products over the visible pairs, bound by operations."""
    return s.depth * 12.0 * s.head_width * _pairs(s, batch, seq) \
        / chip["bf16_flops"]


def rms_norm_least_s(s: ToyShape, batch: int, seq: int,
                     chip: dict) -> float:
    """Each norm reads and writes [tokens, width] in bf16, bound by
    bytes."""
    return (2 * s.depth + 1) * 4.0 * batch * seq * s.width \
        / chip["hbm_bytes"]
