"""Parallelism over ``torch.distributed``: the five-axis device mesh, the
logical sharding rules, the collectives over mesh axes, ring attention
over the sequence axis, the pipeline schedules over the pp axis, and the
plan layer (the planner, its measurement table and the compile cache)."""

from tony_tpu_torch.parallel.collectives import (
    all_gather_tp,
    all_gather_with_slice_grad,
    all_to_all_ep,
    anchor,
    copy_to,
    copy_to_tp,
    exchange_chunks,
    exchange_ep,
    pmean,
    pmean_gradients,
    ppermute,
    reduce_from,
    reduce_from_tp,
    reduce_scatter_tp,
    ring_halo_exchange,
    select,
)
from tony_tpu_torch.parallel.mesh import (
    AXES,
    MeshSpec,
    axis_group_ranks,
    build_mesh,
)
from tony_tpu_torch.parallel.pipeline import (
    ScheduleInfo,
    pipeline_apply,
    pipeline_apply_in_process,
    schedule_info,
)
from tony_tpu_torch.parallel.plan import (
    Plan,
    candidate_plans,
    configure_compile_cache,
    plan_cache_key,
    plan_for,
    record_step_time,
)
from tony_tpu_torch.parallel.ring import ring_attention
from tony_tpu_torch.parallel.sharding import (
    LOGICAL_RULES,
    Placement,
    logical_spec,
    shard_pytree,
    with_logical_constraint,
)

__all__ = [
    "AXES",
    "LOGICAL_RULES",
    "MeshSpec",
    "Placement",
    "Plan",
    "ScheduleInfo",
    "all_gather_tp",
    "all_gather_with_slice_grad",
    "all_to_all_ep",
    "anchor",
    "axis_group_ranks",
    "build_mesh",
    "candidate_plans",
    "configure_compile_cache",
    "copy_to",
    "copy_to_tp",
    "exchange_chunks",
    "exchange_ep",
    "logical_spec",
    "pmean",
    "pipeline_apply",
    "pipeline_apply_in_process",
    "plan_cache_key",
    "plan_for",
    "pmean_gradients",
    "ppermute",
    "reduce_from",
    "reduce_from_tp",
    "record_step_time",
    "reduce_scatter_tp",
    "ring_attention",
    "ring_halo_exchange",
    "schedule_info",
    "select",
    "shard_pytree",
    "with_logical_constraint",
]
