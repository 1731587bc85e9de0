"""The LM train step on one device: forward, next-token cross-entropy,
backward, global-norm clipping and AdamW, as the JAX package's
``make_train_step`` composes them (``optax.chain(clip_by_global_norm,
adamw)``).

JAX donates the old state so the update happens in place in device memory;
here the update IS in place: ``step_fn`` writes the new weights and moments
into the tensors of the state it is given and returns a state that holds
those same tensors. The step reads nothing back to the host: the metrics
are 0-d tensors on the device, and the clip never asks for the norm's
value.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
)
from tony_tpu_torch.ops import softmax_cross_entropy


class TrainState(NamedTuple):
    step: torch.Tensor  # 0-d int32 on the device
    params: Any         # the params dict of fp32 masters (requires_grad)
    opt_state: Any      # the torch.optim.AdamW holding the moments


def lm_loss(params, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None, *, return_metrics: bool = False):
    """Next-token cross-entropy. tokens: [B, T+1] int. With
    ``return_metrics`` returns ``(total, {"cross_entropy": ce})``; dense
    trunks have no router losses, so total == ce."""
    tokens = tokens.to(params["embed"].device)
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward(params, inputs, cfg, mesh, return_aux=True)
    ce = softmax_cross_entropy(logits, labels)
    if not return_metrics:
        return ce
    return ce, {"cross_entropy": ce, **aux}


def leaves(params: dict) -> list[torch.Tensor]:
    """The params tree's tensors in a fixed order (sorted keys, depth
    first)."""
    out = []
    for key in sorted(params):
        val = params[key]
        out.extend(leaves(val) if isinstance(val, dict) else [val])
    return out


def clip_by_global_norm_(grads: list[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm, in place and without a host sync: with
    g = ||grads||_2 over every leaf, leave the grads as they are when
    g < max_norm, else replace each t by (t / g) * max_norm (no epsilon,
    unlike torch.nn.utils.clip_grad_norm_). Returns g as a 0-d tensor."""
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)).float())
    clip = ~(norm < max_norm)  # a NaN norm clips, as optax's select does
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, max_norm * one, one))
    return norm


def _single_device_only(mesh, plan, pipeline_microbatches,
                        pipeline_schedule, pipeline_virtual) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=) waits for the data-parallel slice "
            "(slice 3) of the port"
        )
    if (pipeline_microbatches is not None or pipeline_schedule != "gpipe"
            or pipeline_virtual != 1):
        raise NotImplementedError(
            "pipeline training waits for the model-parallel slice (slice 4) "
            "of the port"
        )
    if plan is not None:
        raise NotImplementedError(
            "make_train_step(plan=) waits for the measurement-plane slice "
            "(slice 7) of the port"
        )
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"a torch.distributed world of {dist.get_world_size()} "
            f"processes needs data-parallel training, which waits for "
            f"slice 3 of the port"
        )


def make_train_step(
    cfg: TransformerConfig,
    mesh=None,
    *,
    device="cuda",
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
    pipeline_microbatches: int | None = None,
    pipeline_schedule: str = "gpipe",
    pipeline_virtual: int = 1,
    plan=None,
):
    """Returns ``(init_fn, step_fn)`` for one device.

    ``init_fn(seed_or_generator=0, *, params=None) -> TrainState``: fresh
    fp32 weights from an int seed or a ``torch.Generator`` on ``device``,
    or the given ``params`` (e.g. converted from the JAX package with
    ``interop.params_from_numpy``), copied to ``device`` as fp32 masters.

    ``step_fn(state, tokens[B, T+1]) -> (state', {"loss", "cross_entropy"})``:
    one optimizer step, updating ``state`` in place (see the module note).
    The optimizer is optax's: global-norm clipping at ``grad_clip``, then
    AdamW with b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
    parameter (``torch.optim.AdamW`` computes that update).
    """
    _single_device_only(mesh, plan, pipeline_microbatches, pipeline_schedule,
                        pipeline_virtual)
    device = resolve_device(device)

    def init_fn(seed_or_generator=0, *, params=None) -> TrainState:
        if params is None:
            gen = seed_or_generator
            if not isinstance(gen, torch.Generator):
                gen = torch.Generator(device=device)
                gen.manual_seed(int(seed_or_generator))
            params = init_params(cfg, gen, device)
        params = _masters(params, device)
        opt = torch.optim.AdamW(
            leaves(params), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        step = torch.zeros((), dtype=torch.int32, device=device)
        return TrainState(step, params, opt)

    def step_fn(state: TrainState, tokens):
        opt = state.opt_state
        tokens = torch.as_tensor(tokens).to(device)
        opt.zero_grad(set_to_none=True)
        loss, metrics = lm_loss(state.params, tokens, cfg,
                                return_metrics=True)
        loss.backward()
        clip_by_global_norm_(
            [p.grad for p in leaves(state.params)], grad_clip)
        opt.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (TrainState(state.step + 1, state.params, opt),
                {"loss": loss.detach(), **metrics})

    return init_fn, step_fn


def _masters(params: dict, device: torch.device) -> dict:
    """fp32 leaf tensors on ``device`` that require grad (copies: the
    caller's tensors are never updated by the optimizer)."""
    return {
        key: (_masters(val, device) if isinstance(val, dict)
              else val.detach().to(device=device, dtype=torch.float32,
                                   copy=True).requires_grad_())
        for key, val in params.items()
    }
