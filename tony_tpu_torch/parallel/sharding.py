"""Logical-axis sharding rules: model code names array dimensions by role
("batch", "seq", "embed", ...); this module maps roles onto mesh axes. The
port's counterpart of the JAX package's ``parallel/sharding.py``, with the
same table.

JAX places a global array and lets GSPMD move its pieces. Here every rank
holds plain local tensors: ``shard_pytree`` cuts each leaf to this rank's
piece and says where the piece lies in the global array (``Placement``),
and the train step moves pieces with explicit collectives
(``collectives.py``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from tony_tpu_torch.parallel.mesh import axis_coordinate, axis_size

# role -> mesh axis (or tuple of axes). None = replicated.
LOGICAL_RULES: dict[str, Any] = {
    "batch": ("dp", "ep"),   # ep folds into the batch split outside MoE blocks
    "seq": "sp",             # sequence/context parallel (ring attention)
    "embed": None,           # activations replicated over tp; weights split below
    "heads": "tp",           # attention heads tensor-parallel
    "kv": None,
    "mlp": "tp",             # MLP hidden dim tensor-parallel (megatron split)
    "vocab": "tp",
    "expert": "ep",          # MoE expert axis
    "layers": "pp",          # stacked layer params pipeline-staged
    "embed_fsdp": "dp",      # weight-sharding (fsdp/zero-3) along embed dim
    "stage": "pp",
}


def logical_spec(*axes: str | None,
                 rules: dict[str, Any] | None = None) -> tuple:
    """('batch','seq','embed') -> (('dp','ep'), 'sp', None): the entries of
    the JAX package's PartitionSpec, one per dimension."""
    rules = LOGICAL_RULES if rules is None else rules
    out = []
    for ax in axes:
        if ax is None:
            out.append(None)
        else:
            if ax not in rules:
                # .get() would silently replicate a typo'd role ("head" for
                # "heads") — an OOM or lost parallelism with no error.
                raise KeyError(
                    f"unknown logical axis {ax!r}; known: {sorted(rules)}")
            out.append(rules[ax])
    return tuple(out)


def with_logical_constraint(x: torch.Tensor, *axes: str | None,
                            mesh=None) -> torch.Tensor:
    """JAX's in-graph sharding hint has nothing to hint here: a tensor is
    this rank's local piece and no compiler re-shards it. The roles are
    still checked (an unknown one raises ``KeyError``, as in JAX), and
    ``x`` comes back unchanged."""
    logical_spec(*axes)
    return x


class Placement(NamedTuple):
    """Where this rank's piece of a leaf lies: the global shape, the mesh
    axes each dimension is split over (None: not split), and the piece's
    [start, stop) per dimension in global coordinates."""

    global_shape: tuple[int, ...]
    spec: tuple
    index: tuple[tuple[int, int], ...]

    @property
    def sharded(self) -> bool:
        return any(e is not None for e in self.spec)

    def region(self) -> tuple[slice, ...]:
        return tuple(slice(a, b) for a, b in self.index)


def place(shape, axes: tuple | None, mesh) -> Placement:
    """The ``Placement`` of a leaf of ``shape`` with logical ``axes`` (None:
    replicated) on ``mesh``. A dimension the mesh axes do not divide, or
    whose axes have size 1, is not split: sharding is a placement choice,
    never a correctness requirement (the JAX train step's rule)."""
    shape = tuple(int(d) for d in shape)
    spec = logical_spec(*axes) if axes is not None else (None,) * len(shape)
    fixed, index = [], []
    for entry, dim in zip(spec, shape):
        n = 1 if entry is None else axis_size(mesh, entry)
        if n == 1 or dim % n:
            fixed.append(None)
            index.append((0, dim))
            continue
        step = dim // n
        start = axis_coordinate(mesh, entry) * step
        fixed.append(entry)
        index.append((start, start + step))
    return Placement(shape, tuple(fixed), tuple(index))


def shard_pytree(tree: Any, spec_tree: Any, mesh) -> tuple[Any, Any]:
    """Cut every leaf of a (nested dict) tree to this rank's piece, by the
    parallel tree of logical-axis tuples (None: replicate). Returns
    ``(local_tree, placement_tree)``: the pieces (views of the leaves,
    contiguous copies where split) and each leaf's ``Placement``."""
    if isinstance(tree, dict):
        pairs = {k: shard_pytree(v, spec_tree[k], mesh)
                 for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    placement = place(tree.shape, spec_tree, mesh)
    local = tree[placement.region()]
    return (local.contiguous() if placement.sharded else local), placement
