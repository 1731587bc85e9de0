"""Stable losses. Cross-entropy takes un-normalized logits and avoids the
softmax round-trip (logsumexp minus the picked logit), with the logits upcast
to fp32 once, as the JAX package computes it. Plain PyTorch: the JAX package
has no kernel here either."""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          where: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy. logits: [..., V], labels: int [...], where:
    optional bool mask [...] (False entries excluded from the mean)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - picked
    if where is not None:
        w = where.float()
        return (nll * w).sum() / torch.clamp_min(w.sum(), 1.0)
    return nll.mean()
