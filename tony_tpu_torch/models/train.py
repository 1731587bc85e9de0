"""The train steps: the LM's and the image classifiers'
(``make_image_classifier_step``, see its docstring). Both return an
instrumented step (``_instrumented``) whose ``stepstats`` publishes the
step's anatomy (``observability.stepstats``).

The LM train step: forward, next-token cross-entropy, backward,
global-norm clipping and AdamW, as the JAX package's ``make_train_step``
composes them (``optax.chain(clip_by_global_norm, adamw)``), on one device
or over a mesh of processes.

With a mesh (``parallel.build_mesh``; dp, pp, ep, sp and tp),
each rank keeps plain local tensors, placed as the JAX package's
``_sharding_for_tree`` places its state: a leaf whose role names
``embed_fsdp`` is split over dp along that dimension where dp divides it,
a leaf with an ``expert`` dimension is split over ep there, one with a
``heads``, ``mlp`` or ``vocab`` dimension over tp (Megatron's split), the
layer stack over pp in contiguous blocks, every other leaf is replicated,
and the AdamW moments follow their parameters. A step gathers the
dp-split dimensions for the forward (all_gather; the backward
reduce-scatters their gradients); the tp blocks and the expert dimension
of the expert FFN weights stay local (the trunk's tp collectives and the
MoE layer's all_to_all work on them as they lie). Over pp the step runs
one of the JAX package's two trunks: without ``pipeline_microbatches``
the layer stack is gathered over pp and every pp rank runs the whole
trunk on the same rows (each keeps its block's slice of the gradient);
with it each rank runs its own L/pp layers as a stage of
``forward_pipeline``'s schedule. Either way a leaf replicated over pp has
the same gradient on every pp rank (the pipeline's input sums its
cotangent over pp, the logits are computed on every pp rank from the
same outputs), so pp takes no part in the mean. Each gradient is
then made the global batch's mean: summed over the data axes (dp, ep, sp)
it is not split over and divided by their size (``_reduce_and_clip``); a
tp block's gradient is its own, and a leaf replicated over tp has the same
gradient on every tp rank. The clip takes the global norm (each block's
squared norm summed over the axes its leaf is split over, pp and tp
included, so each block counts once) and AdamW runs on the local pieces.
Each rank feeds its own ``[B_local, T+1]`` slice of the global batch
(split over dp x ep; the pp, sp and tp ranks of one slice feed the same
rows). Over sp, each rank shifts the rows into inputs and labels
and keeps its block of T/sp positions of both, as JAX's shift re-shards
the tokens onto sp; the rank's loss is its block's mean, and since the
blocks are equal the mean over the data axes is the global batch's mean.
The cross-entropy is the vocab-parallel one.

JAX donates the old state so the update happens in place in device memory;
here the update IS in place: ``step_fn`` writes the new weights and moments
into the tensors of the state it is given and returns a state that holds
those same tensors. The step reads nothing back to the host: the metrics
are 0-d tensors on the device, and the clip never asks for the norm's
value.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from tony_tpu_torch import observability, profiling
from tony_tpu_torch.analysis import jit_sanitizer
from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.mnist import MnistConfig, mnist_apply, mnist_init
from tony_tpu_torch.models.transformer import (
    EXPERT_LEAVES,
    TransformerConfig,
    check_mesh,
    check_pipeline,
    forward,
    forward_pipeline,
    init_params,
    param_roles,
)
from tony_tpu_torch.ops import (
    softmax_cross_entropy,
    vocab_parallel_cross_entropy,
)
from tony_tpu_torch.parallel.collectives import (
    all_gather_with_scatter_grad,
    all_gather_with_slice_grad,
    axis_group,
    pmean_gradients,
)
from tony_tpu_torch.observability.stepstats import StepStats
from tony_tpu_torch.ops import attention as attention_lib
from tony_tpu_torch.parallel import autotune as autotune_lib
from tony_tpu_torch.parallel import plan as plan_lib
from tony_tpu_torch.parallel.mesh import (
    DATA_AXES,
    MeshSpec,
    axis_coordinate,
    axis_size,
)
from tony_tpu_torch.parallel.pipeline import SCHEDULES, check_schedule_args
from tony_tpu_torch.parallel.plan import Plan
from tony_tpu_torch.parallel.sharding import shard_pytree

# The axes that split a model's leaves without splitting its tokens: a
# leaf's gradient is its own block's over them, and its norm sums the
# blocks' squares over them.
MODEL_AXES = ("pp", "tp")


class TrainState(NamedTuple):
    step: torch.Tensor  # 0-d int32 on the device
    params: Any         # the params dict of fp32 masters (requires_grad)
    opt_state: Any      # the torch.optim.AdamW holding the moments
    # With a mesh: the params-shaped dict of each leaf's
    # parallel.sharding.Placement (params and moments are local pieces).
    placements: Any = None


def lm_loss(params, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None, *, pipeline_microbatches: int | None = None,
            pipeline_schedule: str = "gpipe", pipeline_virtual: int = 1,
            pipeline_stages: int | None = None,
            return_metrics: bool = False):
    """Next-token cross-entropy, plus ``moe_balance_coef`` times the
    balance loss and ``moe_zloss_coef`` times the router z-loss when the
    config has experts. tokens: [B, T+1] int. With ``return_metrics``
    returns ``(total, {"cross_entropy": ce, **router aux})``. With a mesh
    the logits are split over the vocab and the cross-entropy is
    ``vocab_parallel_cross_entropy``; over sp, the inputs and labels are
    this rank's block of the shifted sequence and the loss is its mean.
    With ``pipeline_microbatches`` the trunk is ``forward_pipeline``'s
    (``pipeline_schedule``, ``pipeline_virtual`` virtual stages); without a
    mesh, ``pipeline_stages`` stages of it run in this process."""
    tokens = tokens.to(params["embed"].device)
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    sp = 1 if mesh is None else axis_size(mesh, "sp")
    if sp > 1:
        t = inputs.shape[1]
        if t % sp:
            raise ValueError(f"sp {sp} must divide the sequence length {t}")
        start = axis_coordinate(mesh, "sp") * (t // sp)
        inputs = inputs[:, start:start + t // sp]
        labels = labels[:, start:start + t // sp]
    if pipeline_microbatches is not None:
        logits, aux = forward_pipeline(
            params, inputs, cfg, mesh, num_microbatches=pipeline_microbatches,
            schedule=pipeline_schedule, virtual_stages=pipeline_virtual,
            return_aux=True, stages=pipeline_stages)
    else:
        logits, aux = forward(params, inputs, cfg, mesh, return_aux=True)
    ce = (softmax_cross_entropy(logits, labels) if mesh is None
          else vocab_parallel_cross_entropy(logits, labels, mesh))
    total = ce
    if aux:
        total = (total + cfg.moe_balance_coef * aux["moe_balance"]
                 + cfg.moe_zloss_coef * aux["moe_zloss"])
    if not return_metrics:
        return total
    return total, {"cross_entropy": ce, **aux}


def leaves(params) -> list[torch.Tensor]:
    """The params tree's tensors in JAX's flattening order (dicts by sorted
    key, lists in order, depth first)."""
    if isinstance(params, dict):
        return [t for key in sorted(params) for t in leaves(params[key])]
    if isinstance(params, list):
        return [t for val in params for t in leaves(val)]
    return [params]


def _instrumented(step_fn, stats: StepStats | None = None, *,
                  marked: bool = False):
    """Count dispatches and host-side dispatch time into the process
    registry (``train_step_dispatches_total``,
    ``train_step_dispatch_seconds``), and drive ``stats`` (the step
    anatomy: the interval between consecutive dispatches is the completed
    step's wall; its ``host`` phase is the device clock's gap between
    steps, or without one the dispatch time). ``stats``' device-clock
    marks go around the dispatch unless ``marked``: ``step_fn`` records
    them itself (``stats.mark_begin``/``mark_end``). Nothing is
    synchronized and nothing read back: the caller's readback fence is
    where the wall closes. The recorder rides the returned step as
    ``step.stepstats`` so train loops can wire their batch iterator in
    (``stats.wrap_batches``); ``step.__wrapped__`` is ``step_fn``."""
    registry = observability.default_registry()
    dispatches = registry.counter("train_step_dispatches_total")
    dispatch_s = registry.histogram("train_step_dispatch_seconds")

    def step(*args, **kwargs):
        if stats is not None:
            stats.step_begin(
                getattr(args[1], "shape", None) if len(args) > 1 else None
            )
        t0 = time.perf_counter()
        if stats is not None and not marked:
            stats.mark_begin()
        out = step_fn(*args, **kwargs)
        if stats is not None and not marked:
            stats.mark_end()
        dt = time.perf_counter() - t0
        dispatches.inc()
        dispatch_s.observe(dt)
        if stats is not None:
            stats.step_end(dt)
        return out

    step.stepstats = stats
    step.__wrapped__ = step_fn
    return step


def clip_scale(grads: list[torch.Tensor], max_norm: float, *,
               leaf_norms: list[torch.Tensor] | None = None) -> torch.Tensor:
    """optax.clip_by_global_norm as the divisor that a fused AdamW's
    ``grad_scale`` applies, without a host sync: with g = ||grads||_2 over
    every leaf, 1 when g < max_norm, else g / max_norm (no epsilon, unlike
    torch.nn.utils.clip_grad_norm_). The step divides each gradient by it
    in its one pass over the parameters and leaves the clipped gradient in
    ``.grad``. ``leaf_norms`` gives each leaf's norm when the grads are
    pieces of larger leaves. Returns a 0-d fp32 tensor."""
    if leaf_norms is None:
        leaf_norms = torch._foreach_norm(grads)
    norm = torch.linalg.vector_norm(torch.stack(leaf_norms).float())
    # A NaN norm clips, as optax's select does.
    return torch.where(norm < max_norm, torch.ones_like(norm),
                       norm / max_norm)


def _check_supported(cfg, mesh, pipeline_microbatches,
                     pipeline_schedule, pipeline_virtual) -> None:
    if pipeline_schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {pipeline_schedule!r}")
    if pipeline_microbatches is not None:
        if mesh is None:
            raise ValueError(
                "pipeline training runs over a mesh's pp axis: pass "
                "make_train_step(cfg, mesh, pipeline_microbatches=...)")
        pp, tp, ep = (axis_size(mesh, a) for a in ("pp", "tp", "ep"))
        check_schedule_args(pipeline_microbatches, pp, pipeline_schedule,
                            pipeline_virtual)
        check_pipeline(cfg, pp, tp, pipeline_schedule, pipeline_virtual, ep)
    if mesh is not None:
        check_mesh(mesh, cfg)
    _check_world(mesh)


def _check_world(mesh) -> None:
    if mesh is None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise ValueError(
            f"a torch.distributed world of {dist.get_world_size()} "
            f"processes trains data-parallel over a mesh: pass "
            f"runtime.build_job_mesh() as the mesh"
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
    plan: Plan | None = None,
):
    """Returns ``(init_fn, step_fn)`` for one device, or for this rank of
    a ``mesh`` (see the module note).

    ``init_fn(seed_or_generator=0, *, params=None) -> TrainState``: fresh
    fp32 weights from an int seed or a ``torch.Generator`` on ``device``,
    or the given ``params`` (e.g. converted from the JAX package with
    ``interop.params_from_numpy``), copied to ``device`` as fp32 masters.
    With a mesh every rank must start from the same weights (the same
    seed); it keeps its pieces and their ``placements``.

    ``step_fn(state, tokens[B, T+1]) -> (state', metrics)``: one optimizer
    step, updating ``state`` in place (see the module note). The metrics
    are "loss" and "cross_entropy", and for an MoE config the layer means of
    "moe_balance", "moe_zloss", "moe_drop_rate" and "moe_entropy".
    With a mesh, ``tokens`` is this rank's slice of the global batch (the
    same slice on every pp, sp and tp rank of a dp row) and the metrics
    are means over the global batch. ``pipeline_microbatches`` (with a
    mesh) trains through ``forward_pipeline``: its schedule
    (``pipeline_schedule``, "gpipe" or "interleaved" with
    ``pipeline_virtual`` virtual stages) over the mesh's pp axis, even at
    pp = 1; the microbatches must divide this rank's rows. The optimizer is optax's:
    global-norm clipping at ``grad_clip``, then AdamW with b1 0.9, b2
    0.999, eps 1e-8, decoupled weight decay on every parameter
    (``torch.optim.AdamW(fused=True)`` computes that update, the clip
    folded into its ``grad_scale``, in one pass over the parameters;
    ``.grad`` holds the clipped gradient after the step).

    ``plan`` (``parallel.plan.Plan``) supplies the mesh (built from its
    spec when ``mesh`` is None) and the pipeline kwargs in one object, as
    the JAX package's does; explicit pipeline kwargs win over the plan's.
    A plan of more than one slice is refused (slices are TPU pods).

    A tune record for (cfg, mesh) (``autotune.lookup("lm_train_step")``)
    fills what the caller and the plan left at their defaults: the
    microbatches and schedule, the remat policy, and the flash tile knob
    (``attention.set_tuned_blocks``).

    ``init_fn`` and the step are wrapped in ``plan.instrument_jit`` under
    ``plan_cache_key``: each one's first call is timed into
    ``tony_compile_ms`` and counted as a compile-cache hit or miss, and
    with the jit sanitizer armed every call is classified and runs in a
    ``step_region`` (the batch moves to the device before it). The
    returned ``step_fn`` is also instrumented (``_instrumented``): its
    ``step_fn.stepstats`` publishes the step's phases and ``tony_mfu``,
    sized with the global batch (this rank's rows times the mesh's data
    rows, dp x ep), and calibrates the plan (one device's plan without a
    mesh).
    """
    device = resolve_device(device)
    if plan is not None:
        if plan.num_slices > 1:
            raise ValueError(
                f"a plan of {plan.num_slices} slices: slices are TPU pods; "
                f"a GPU job is one slice")
        if mesh is None:
            mesh = plan.build_mesh(device)
        if pipeline_microbatches is None:
            pipeline_microbatches = plan.microbatches
            # Explicit schedule/virtual kwargs still win over the plan's:
            # only defaults are replaced.
            if pipeline_schedule == "gpipe" and pipeline_virtual == 1:
                pipeline_schedule = plan.pipeline_schedule
                pipeline_virtual = plan.pipeline_virtual
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                         f"{device}")
    # The measured autotuner's record for this (config, topology, backend)
    # fills what the caller and the plan left at defaults; it never
    # overrides an explicit argument.
    tuned = autotune_lib.lookup("lm_train_step", config=cfg, mesh=mesh)
    if tuned is not None:
        if pipeline_microbatches is None and tuned.microbatches is not None:
            pipeline_microbatches = tuned.microbatches
            if pipeline_schedule == "gpipe" and tuned.pipeline_schedule:
                pipeline_schedule = tuned.pipeline_schedule
        cfg = autotune_lib.apply_knobs_to_config(cfg, tuned)
        if tuned.block_q or tuned.block_k:
            attention_lib.set_tuned_blocks(tuned.block_q, tuned.block_k)
    _check_supported(cfg, mesh, pipeline_microbatches, pipeline_schedule,
                     pipeline_virtual)
    pipeline = dict(pipeline_microbatches=pipeline_microbatches,
                    pipeline_schedule=pipeline_schedule,
                    pipeline_virtual=pipeline_virtual)

    def init_fn(seed_or_generator=0, *, params=None) -> TrainState:
        if params is None:
            gen = seed_or_generator
            if not isinstance(gen, torch.Generator):
                gen = torch.Generator(device=device)
                gen.manual_seed(int(seed_or_generator))
            params = init_params(cfg, gen, device)
        placements = None
        if mesh is not None:
            params, placements = shard_pytree(params, param_roles(cfg), mesh)
        # Given weights may lie on the host: their upload is explicit.
        with jit_sanitizer.explicit_fence():
            params = _masters(params, device)
        opt = torch.optim.AdamW(
            leaves(params), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay, fused=True,
        )
        step = torch.zeros((), dtype=torch.int32, device=device)
        return TrainState(step, params, opt, placements)

    # Step anatomy, sized from the global batch: the hook sees only this
    # rank's rows, which would understate MFU by the data-row count.
    # Without a mesh the plan is one device's, so calibration records.
    stats = StepStats(cfg=cfg,
                      plan=plan if plan is not None or mesh is not None
                      else Plan(MeshSpec()),
                      mesh=mesh, microbatches=pipeline_microbatches,
                      size_from_shapes=False, device=device)

    def step_fn(state: TrainState, tokens):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        stats.mark_begin()
        with record_function("train.forward"):
            params = state.params
            if mesh is not None:
                params = _gather(params, state.placements, mesh,
                                 EXPERT_LEAVES if cfg.n_experts else (),
                                 pipelined=pipeline_microbatches is not None)
            loss, metrics = lm_loss(params, tokens, cfg, mesh,
                                    return_metrics=True, **pipeline)
        # The backward pass runs on the autograd engine's thread (on the
        # card): the range opens there. The one on this thread holds what
        # backward() launches before the engine takes over.
        profiling.annotate_backward(loss, "train.backward")
        with record_function("train.backward"):
            loss.backward()
        with record_function("train.optimizer"):
            grads = [p.grad for p in leaves(state.params)]
            metrics = {"loss": loss, **metrics}
            metrics = {k: v.detach().clone() for k, v in metrics.items()}
            if mesh is None:
                opt.grad_scale = clip_scale(grads, grad_clip)
            else:
                opt.grad_scale = _reduce_and_clip(
                    grads, leaves(state.placements), mesh, grad_clip)
                pmean_gradients(list(metrics.values()), mesh, DATA_AXES)
            opt.step()
            step = state.step + 1
        stats.mark_end()
        return (TrainState(step, state.params, opt, state.placements),
                metrics)

    # Everything whose change must invalidate a compiled artefact rides
    # the plan cache key (argument shapes join at the first call).
    fingerprint = {
        "learning_rate": learning_rate,
        "weight_decay": weight_decay,
        "grad_clip": grad_clip,
        "microbatches": pipeline_microbatches,
        "schedule": pipeline_schedule,
        "virtual": pipeline_virtual,
        "optimizer": "default-adamw",
    }
    jit_init = plan_lib.instrument_jit(init_fn, plan_lib.plan_cache_key(
        "lm_train_init", config=cfg, mesh=mesh, plan=plan,
        extra=fingerprint))
    jit_step = plan_lib.instrument_jit(step_fn, plan_lib.plan_cache_key(
        "lm_train_step", config=cfg, mesh=mesh, plan=plan,
        extra=fingerprint))

    rows = 1 if mesh is None else axis_size(mesh, ("dp", "ep"))

    def step(state: TrainState, tokens):
        stats.set_workload(tokens.shape[0] * rows,
                           max(tokens.shape[1] - 1, 1))
        # The batch's upload, outside the step's sanitized region.
        return jit_step(state, torch.as_tensor(tokens).to(device))

    return jit_init, _instrumented(step, stats, marked=True)


def _gather(params: dict, placements: dict, mesh, resident=(), *,
            pipelined: bool = False) -> dict:
    """The parameters the forward takes: every split dimension of a leaf
    all-gathered, but the tp blocks, the ep dimension of the ``resident``
    leaves (the expert FFN weights), and under ``pipelined`` the pp blocks
    of the layer stack (each rank runs its own stage). A dp block's
    gradient is reduce-scattered back; a pp block's gathered for the
    unpipelined trunk, which every pp rank runs whole on the same rows,
    keeps its own slice of the whole gradient
    (``all_gather_with_slice_grad``)."""
    out = {}
    for key, val in params.items():
        if isinstance(val, dict):
            out[key] = _gather(val, placements[key], mesh, resident,
                               pipelined=pipelined)
            continue
        for dim, entry in enumerate(placements[key].spec):
            if entry is None or entry == "tp" or (
                    key in resident and entry == "ep"):
                continue
            if entry == "pp":
                if not pipelined:
                    val = all_gather_with_slice_grad(val, dim, entry,
                                                     mesh=mesh)
                continue
            val = all_gather_with_scatter_grad(val, dim, entry, mesh=mesh)
        out[key] = val
    return out


def _split_axes(placement) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(the data axes, of DATA_AXES, a leaf is split over; the model axes,
    pp and tp, it is split over)."""
    names = set()
    for entry in placement.spec:
        if entry is not None:
            names.update((entry,) if isinstance(entry, str) else entry)
    return (tuple(a for a in DATA_AXES if a in names),
            tuple(a for a in MODEL_AXES if a in names))


def _reduce_and_clip(grads: list[torch.Tensor], placements: list, mesh,
                     grad_clip: float) -> torch.Tensor:
    """Turn each rank's gradients into the global batch's and return the
    clip's divisor (``clip_scale``) for their global norm. A leaf's
    gradient arrives summed over the data axes it is split over (a
    gathered dimension's reduce-scatter sums over dp; an expert leaf holds
    its ep peers' tokens' sum, which the all_to_all brought back) and is
    this rank's own over the others: a leaf
    replicated over the data axes has its gradient averaged over dp x ep x
    sp, a split one's is summed over the data axes above 1 it is not split
    over (sp after a dp reduce-scatter), and each is divided so that it is
    the mean over the global batch. Over sp a rank's gradient is that of
    the sum of the ranks' block losses through its own activations (the
    ring's backward sends each block's dk/dv back to its owner), so the
    mean over sp is the gradient of the mean loss. tp
    takes no part in the mean: a tp block's gradient is its block's, and a
    leaf replicated over tp gets the same gradient on every tp rank
    (``copy_to_tp`` sums the cotangent over tp before the norms' backward);
    pp takes no part either (see the module note).
    Then each split leaf's norm is the root of its blocks' squared norms
    summed over the axes it is split over (one all_reduce per set of data
    axes, then one over each of pp and tp), so each block counts once, and every rank
    clips its pieces by the same global norm in the step."""
    by_axes: dict[tuple[tuple[str, ...], bool], list[int]] = {}
    for i, pl in enumerate(placements):
        by_axes.setdefault(_split_axes(pl), []).append(i)
    for (data, _), idx in by_axes.items():
        gs = [grads[i] for i in idx]
        if not data:
            pmean_gradients(gs, mesh, DATA_AXES)
            continue
        rest = tuple(a for a in DATA_AXES
                     if a not in data and axis_size(mesh, a) > 1)
        if rest:
            pmean_gradients(gs, mesh, rest)
        n = axis_size(mesh, data)
        if n > 1:
            torch._foreach_div_(gs, n)
    norms = list(torch._foreach_norm(grads))
    for (data, model), idx in by_axes.items():
        if not (data or model):
            continue
        blocks = torch.stack([norms[i] for i in idx])
        squares = blocks * blocks
        for axes in (data, *((a,) for a in model)):
            if axes:
                dist.all_reduce(squares, op=dist.ReduceOp.SUM,
                                group=axis_group(mesh, axes)[0])
        for i, norm in zip(idx, squares.sqrt().unbind()):
            norms[i] = norm
    return clip_scale(grads, grad_clip, leaf_norms=norms)


def _masters(params, device: torch.device):
    """The params tree (dicts and lists) as fp32 leaf tensors on
    ``device`` that require grad (copies: the caller's tensors are never
    updated by the optimizer)."""
    if isinstance(params, dict):
        return {key: _masters(val, device) for key, val in params.items()}
    if isinstance(params, list):
        return [_masters(val, device) for val in params]
    return torch.as_tensor(params).detach().to(
        device=device, dtype=torch.float32, copy=True).requires_grad_()


# ---------------------------------------------------------------------------
# Image classifiers
# ---------------------------------------------------------------------------

def make_classifier_step(cfg: MnistConfig, mesh=None, *, device="cuda",
                         learning_rate: float = 1e-3,
                         steps_per_call: int = 1):
    """The supervised step of the MNIST models (see
    ``make_image_classifier_step``)."""
    device = resolve_device(device)
    return make_image_classifier_step(
        lambda gen: mnist_init(cfg, gen, device),
        lambda params, images: mnist_apply(params, images, cfg),
        mesh,
        device=device,
        learning_rate=learning_rate,
        steps_per_call=steps_per_call,
        config=cfg,
    )


def uint8_image_normalizer(mean: float = 0.0, std: float = 255.0):
    """The decode for byte-transferred images, run inside the step: uint8
    -> fp32 ``(x - mean) / std``. Pass it as
    ``make_image_classifier_step(preprocess=...)``."""
    scale = 1.0 / std

    def pre(images):
        return (images.float() - mean) * scale

    return pre


def make_image_classifier_step(
    init_params_fn,
    apply_fn,
    mesh=None,
    *,
    device="cuda",
    learning_rate: float = 1e-3,
    steps_per_call: int = 1,
    preprocess=None,
    config=None,
):
    """Supervised step for any image classifier ``apply_fn(params,
    images) -> logits``: softmax cross-entropy, and optax's ``adam``
    (b1 0.9, b2 0.999, eps 1e-8, no weight decay; ``torch.optim.Adam``
    computes that update). Returns ``(init_fn, step_fn)``.

    ``init_fn(seed_or_generator=0, *, params=None) -> TrainState``:
    ``init_params_fn(generator)`` with a ``torch.Generator`` on ``device``
    (from an int seed, or the one given), or the given ``params`` (e.g.
    ``interop.image_params_from_numpy`` of JAX weights), copied to
    ``device`` as fp32 masters.

    ``step_fn(state, images, labels) -> (state', {"loss", "accuracy"})``:
    one optimizer step, updating ``state`` in place. ``steps_per_call =
    n > 1`` runs n steps a call on stacked batches ``[n, B, ...]`` and
    returns the last step's metrics. ``preprocess`` runs on the images
    inside the step, before ``apply_fn`` (``uint8_image_normalizer``).

    With a ``mesh`` every rank holds the whole (replicated) params and
    feeds its own rows of the global batch (split over dp x ep; the other
    axes' ranks of a data row feed the same rows); the gradients and the
    metrics are averaged over the data axes, so each rank steps with the
    global batch's mean. ``step_fn.stepstats`` publishes the step's
    phases (per optimizer step) and no MFU.
    """
    device = resolve_device(device)
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                         f"{device}")
    _check_world(mesh)
    n = steps_per_call

    def init_fn(seed_or_generator=0, *, params=None) -> TrainState:
        if params is None:
            gen = seed_or_generator
            if not isinstance(gen, torch.Generator):
                gen = torch.Generator(device=device)
                gen.manual_seed(int(seed_or_generator))
            params = init_params_fn(gen)
        with jit_sanitizer.explicit_fence():
            params = _masters(params, device)
        opt = torch.optim.Adam(leaves(params), lr=learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        step = torch.zeros((), dtype=torch.int32, device=device)
        return TrainState(step, params, opt)

    def one_step(state: TrainState, images, labels):
        if preprocess is not None:
            images = preprocess(images)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        logits = apply_fn(state.params, images)
        loss = softmax_cross_entropy(logits, labels)
        loss.backward()
        metrics = [loss.detach().clone(),
                   (logits.detach().argmax(-1) == labels).float().mean()]
        if mesh is not None:
            pmean_gradients([p.grad for p in leaves(state.params)], mesh,
                            DATA_AXES)
            pmean_gradients(metrics, mesh, DATA_AXES)
        opt.step()
        return (TrainState(state.step + 1, state.params, opt),
                dict(zip(("loss", "accuracy"), metrics)))

    def step_fn(state: TrainState, images, labels):
        if n == 1:
            return one_step(state, images, labels)
        for i in range(n):
            state, metrics = one_step(state, images[i], labels[i])
        return state, metrics

    # ``config`` rides the plan cache key when given; without it the
    # state's leaf shapes, folded in at the first call, carry the model.
    fingerprint = {
        "learning_rate": learning_rate,
        "steps_per_call": steps_per_call,
        "preprocess": getattr(preprocess, "__name__", repr(preprocess))
        if preprocess is not None else None,
    }
    jit_init = plan_lib.instrument_jit(init_fn, plan_lib.plan_cache_key(
        "classifier_init", config=config, mesh=mesh, extra=fingerprint))
    jit_step = plan_lib.instrument_jit(step_fn, plan_lib.plan_cache_key(
        "classifier_step", config=config, mesh=mesh, extra=fingerprint))

    def step(state: TrainState, images, labels):
        # The batch's upload, outside the step's sanitized region.
        return jit_step(state, torch.as_tensor(images).to(device),
                        torch.as_tensor(labels).to(device))

    # Phases only: image shapes carry no flops model.
    stats = StepStats(cfg=config, mesh=mesh, steps_per_call=n,
                      tokens_workload=False, device=device)
    return jit_init, _instrumented(step, stats)
