"""Parallelism over ``torch.distributed``: the five-axis device mesh, the
logical sharding rules, the collectives over mesh axes, and ring attention
over the sequence axis."""

from tony_tpu_torch.parallel.collectives import (
    all_gather_tp,
    all_to_all_ep,
    copy_to_tp,
    exchange_ep,
    pmean,
    pmean_gradients,
    ppermute,
    reduce_from_tp,
    reduce_scatter_tp,
    ring_halo_exchange,
)
from tony_tpu_torch.parallel.mesh import (
    AXES,
    MeshSpec,
    axis_group_ranks,
    build_mesh,
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
    "all_gather_tp",
    "all_to_all_ep",
    "axis_group_ranks",
    "build_mesh",
    "copy_to_tp",
    "exchange_ep",
    "logical_spec",
    "pmean",
    "pmean_gradients",
    "ppermute",
    "reduce_from_tp",
    "reduce_scatter_tp",
    "ring_attention",
    "ring_halo_exchange",
    "shard_pytree",
    "with_logical_constraint",
]
