"""A configuration file's model, as plain numbers: what the weights, the
counts, the reference and the port's config are all built from.

``Shape`` holds the fields every family has, the only ones the harness
reads; a family (``lib/family.py``) subclasses it in its own module with
the fields of its architecture.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, kw_only=True)
class Shape:
    vocab: int
    compute_dtype: str = "bfloat16"
    experts: int = 0           # 0: no expert layer
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip: float = 1.0

    @classmethod
    def from_config(cls, c: dict) -> "Shape":
        """The shape that the family of ``c``'s ``model_type`` reads."""
        from perfbench.lib import spec

        return spec.family(c["model_type"]).shape(c)


def run_settings(c: dict) -> dict:
    """The fields a configuration file's ``run`` block gives every family
    alike: the compute dtype and the optimizer."""
    run = c["run"]
    opt = run["optimizer"]
    return dict(compute_dtype=run["compute_dtype"],
                lr=float(opt["learning_rate"]),
                weight_decay=float(opt["weight_decay"]),
                beta1=float(opt["beta1"]), beta2=float(opt["beta2"]),
                adam_eps=float(opt["eps"]), grad_clip=float(opt["grad_clip"]))
