"""Stable losses. Cross-entropy takes un-normalized logits and avoids the
softmax round-trip (logsumexp minus the picked logit), with the logits upcast
to fp32 once, as the JAX package computes it. Plain PyTorch: the JAX package
has no kernel here either.

``vocab_parallel_cross_entropy`` is the same loss over logits whose vocab
axis is split over the tp ranks of a mesh (the tensor-parallel trunk's
unembed gives each rank its own columns): the row max, the sum of
exponentials and the picked logit are each all_reduced over tp, so no rank
holds the whole [.., V] row. JAX's GSPMD trunk inserts the same reductions
itself."""

from __future__ import annotations

import torch
import torch.distributed as dist

from tony_tpu_torch.parallel.collectives import axis_group, reduce_from_tp
from tony_tpu_torch.parallel.mesh import axis_coordinate


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


class _VocabParallelLse(torch.autograd.Function):
    """logsumexp over a vocab axis split over the ranks of ``group``,
    computed as ``torch.logsumexp`` computes it (log of the sum of exp(x -
    max), plus the max) and differentiated as it is (grad * exp(x - lse)
    on this rank's columns), so on one rank it gives the same bits."""

    @staticmethod
    def forward(ctx, logits, group):
        m = logits.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        m = m.masked_fill(m.abs() == torch.inf, 0.0)
        s = (logits - m[..., None]).exp().sum(-1)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        lse = s.log().add(m)
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        logits, lse = ctx.saved_tensors
        return grad[..., None] * (logits - lse[..., None]).exp(), None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mesh) -> torch.Tensor:
    """Mean cross-entropy of logits [..., V/tp], this rank's block of the
    vocab (block ``tp coordinate``), against global labels int [...]. fp32
    throughout, as ``softmax_cross_entropy``; every tp rank returns the same
    loss, and each rank's logits get their own columns' gradient."""
    logits = logits.float()
    group = axis_group(mesh, "tp")[0]
    v = logits.shape[-1]
    local = labels.long() - axis_coordinate(mesh, "tp") * v
    mine = (local >= 0) & (local < v)
    lse = _VocabParallelLse.apply(logits, group)
    picked = logits.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
    picked = reduce_from_tp(torch.where(mine, picked, 0.0), mesh)
    return (lse - picked).mean()
