"""A configuration file's model, as plain numbers: what the weights, the
counts, the reference and the port's config are all built from."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Shape:
    vocab: int
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    max_seq: int
    theta: float
    eps: float
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    balance_coef: float = 0.0
    zloss_coef: float = 0.0
    compute_dtype: str = "bfloat16"
    remat: str = "full"
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip: float = 1.0

    @classmethod
    def from_config(cls, c: dict) -> "Shape":
        run = c["run"]
        opt = run["optimizer"]
        moe = {}
        if c.get("num_local_experts"):
            moe = dict(experts=int(c["num_local_experts"]),
                       top_k=int(c["num_experts_per_tok"]),
                       capacity_factor=float(run["capacity_factor"]),
                       balance_coef=float(c["router_aux_loss_coef"]),
                       zloss_coef=float(run["router_z_loss_coef"]))
        return cls(
            vocab=int(c["vocab_size"]), d=int(c["hidden_size"]),
            layers=int(c["num_hidden_layers"]),
            heads=int(c["num_attention_heads"]),
            kv_heads=int(c["num_key_value_heads"]),
            head_dim=int(c["head_dim"]), ff=int(c["intermediate_size"]),
            max_seq=int(c["max_position_embeddings"]),
            theta=float(c["rope_theta"]), eps=float(c["rms_norm_eps"]),
            compute_dtype=run["compute_dtype"], remat=run["remat"],
            lr=float(opt["learning_rate"]),
            weight_decay=float(opt["weight_decay"]),
            beta1=float(opt["beta1"]), beta2=float(opt["beta2"]),
            adam_eps=float(opt["eps"]), grad_clip=float(opt["grad_clip"]),
            **moe)
