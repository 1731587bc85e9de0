"""Device meshes over the five parallelism axes, on ``torch.distributed``.

The port's counterpart of the JAX package's ``parallel/mesh.py``: the same
axis names and order, the same ``MeshSpec`` auto-factoring and multi-slice
rules, and ``build_mesh`` returning a torch ``DeviceMesh`` over the current
process group, one device (one process) per mesh position:

  dp  — data parallel (batch split, gradients averaged)
  pp  — pipeline parallel (layer stages)
  ep  — expert parallel (MoE experts, tokens all_to_all'd)
  sp  — sequence/context parallel (ring attention over the sequence axis)
  tp  — tensor parallel (heads / mlp-hidden split)

Ranks are laid out in C order over ``AXES``, so tp is innermost (adjacent
ranks, the same host's NVLink) and dp outermost (the only axis that may cross
hosts). On GPUs one node is one slice.

A collective over two or more axes at once needs a group of its own: for
each set of the data axes (dp, ep, sp) with two or more axes above 1,
``build_mesh`` flattens them into one more mesh dimension named by the
axes joined with ``_`` (``"dp_ep"``, ``"dp_sp"``, ``"dp_ep_sp"``, ...;
``axis_group_ranks`` lists its groups' ranks from the ``MeshSpec`` alone).
The gradient mean of the train step and the MoE layer's router
statistics run over the data axes.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch.distributed as dist

from tony_tpu_torch.device import resolve_device

# Canonical axis order, outermost (across hosts) to innermost (NVLink-hot).
AXES = ("dp", "pp", "ep", "sp", "tp")
# The data axes: a batch or sequence split over them leaves each rank its
# own tokens, and the gradients are averaged over all of them.
DATA_AXES = ("dp", "ep", "sp")


@dataclass(frozen=True)
class MeshSpec:
    """A validated mesh shape over the five parallelism axes."""

    dp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.dp, self.pp, self.ep, self.sp, self.tp)

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    def validate(self, num_devices: int | None = None) -> "MeshSpec":
        for name, size in zip(AXES, self.shape):
            if size < 1:
                raise ValueError(f"mesh axis {name!r} must be >= 1, got {size}")
        if num_devices is not None and self.num_devices != num_devices:
            raise ValueError(
                f"mesh spec {self.shape} needs {self.num_devices} devices, "
                f"have {num_devices}"
            )
        return self

    @staticmethod
    def auto(
        num_devices: int,
        *,
        dp: int | None = None,
        pp: int | None = None,
        ep: int | None = None,
        sp: int | None = None,
        tp: int | None = None,
    ) -> "MeshSpec":
        """Fill unset axes by factoring ``num_devices``, preferring (in order)
        tp, sp, pp, dp — the axes whose collectives benefit most from short
        hops get sized first; dp absorbs the remainder (its gradient mean is
        the most latency-tolerant collective).
        """
        fixed = {"dp": dp, "pp": pp, "ep": ep, "sp": sp, "tp": tp}
        sized = math.prod(v for v in fixed.values() if v is not None)
        if num_devices % max(sized, 1) != 0:
            raise ValueError(
                f"fixed axes {fixed} do not divide device count {num_devices}"
            )
        rest = num_devices // max(sized, 1)
        out = dict(fixed)
        for axis in ("tp", "sp", "pp"):
            if out[axis] is None:
                f = _largest_factor_at_most(rest, 2)
                out[axis] = f
                rest //= f
        if out["ep"] is None:
            out["ep"] = 1
        # The leftover factor goes to the first unset axis that can take it
        # (dp by preference — its gradient mean tolerates long hops best).
        if fixed["dp"] is None:
            out["dp"] = rest
        else:
            for axis in ("pp", "sp", "tp", "ep"):
                if fixed[axis] is None and rest > 1:
                    out[axis] *= rest
                    rest = 1
                    break
            if rest > 1:
                raise ValueError(
                    f"all axes fixed as {fixed} but {rest}x devices left over "
                    f"for {num_devices} devices"
                )
        spec = MeshSpec(**{k: int(v) for k, v in out.items()})
        return spec.validate(num_devices)


def _largest_factor_at_most(n: int, cap: int) -> int:
    for f in range(min(cap, n), 0, -1):
        if n % f == 0:
            return f
    return 1


def check_slices(spec: MeshSpec, num_devices: int, num_slices: int) -> None:
    """The multi-slice rules of the JAX package: the devices split into
    equal slices, dp is a multiple of the slice count, and (dp/num_slices)
    x pp x ep x sp x tp fills one slice, so only dp crosses a slice."""
    if num_slices <= 1:
        return
    if num_devices % num_slices:
        raise ValueError(
            f"{num_devices} devices do not split into {num_slices} "
            f"equal slices"
        )
    if spec.dp % num_slices:
        raise ValueError(
            f"multi-slice meshes need dp ({spec.dp}) divisible by "
            f"num_slices ({num_slices}) — dp is the only axis allowed "
            f"to cross the slice boundary"
        )
    per_slice = num_devices // num_slices
    inner = spec.pp * spec.ep * spec.sp * spec.tp
    if (spec.dp // num_slices) * inner != per_slice:
        raise ValueError(
            f"mesh {spec.shape} cannot tile {num_slices} slices of "
            f"{per_slice} devices with dp outermost: "
            f"(dp/num_slices) x pp x ep x sp x tp = "
            f"{(spec.dp // num_slices) * inner} != {per_slice}"
        )


def build_mesh(
    spec: MeshSpec | None = None,
    device="cuda",
    *,
    num_slices: int = 1,
    timeout_s: float = 300.0,
):
    """A 5-axis ``DeviceMesh`` over the current process group, one rank per
    position. With no spec, auto-factor over the world (multi-slice: dp
    pinned to the slice count).

    Ranks are numbered node by node, so the C-order layout puts each
    slice's ranks in its own dp rows. Every axis gets its own process group
    (NCCL for ``device="cuda"``, gloo for ``"cpu"``; the default group must
    use the same backend) with ``timeout_s``: a rank that dies fails its
    peers' collectives within that time."""
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs a torch.distributed process group: call "
            "runtime.initialize() first"
        )
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != backend:
        raise ValueError(
            f"a {dev.type} mesh needs the {backend} backend; the process "
            f"group uses {dist.get_backend()}"
        )
    world = dist.get_world_size()
    if spec is None:
        spec = (MeshSpec.auto(world) if num_slices == 1
                else MeshSpec.auto(world, dp=num_slices))
    spec.validate(world)
    check_slices(spec, world, num_slices)
    timeout = timedelta(seconds=timeout_s)

    def options():
        opts = (dist.ProcessGroupNCCL.Options() if backend == "nccl"
                else dist.ProcessGroupGloo._Options())
        opts._timeout = timeout
        return backend, opts

    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(dev.type, spec.shape, mesh_dim_names=AXES,
                            backend_override={n: options() for n in AXES})
    # Every rank creates the same groups in the same order (_flatten makes
    # process groups).
    wide = [a for a in DATA_AXES if getattr(spec, a) > 1]
    for n in range(2, len(wide) + 1):
        for names in itertools.combinations(wide, n):
            mesh[names]._flatten(flat_name(names),
                                 backend_override=options())
    return mesh


def flat_name(names) -> str:
    """The name of the mesh dimension ``build_mesh`` flattens from data
    axes ``names`` (in ``AXES`` order)."""
    return "_".join(names)


def axis_group_ranks(spec: MeshSpec, names) -> list[list[int]]:
    """The rank lists of the groups over mesh axes ``names`` taken
    together: ranks that share their coordinates on every other axis, in
    the C order of ``AXES`` over the named ones (the first named axis
    major). A pure function of the spec."""
    names = (names,) if isinstance(names, str) else tuple(names)
    dims = [AXES.index(n) for n in names]
    rest = [i for i in range(len(AXES)) if i not in dims]
    grid = np.arange(spec.num_devices).reshape(spec.shape)
    size = math.prod(spec.shape[i] for i in dims)
    return grid.transpose(rest + dims).reshape(-1, size).tolist()


def axis_size(mesh, names) -> int:
    """The product of the sizes of mesh axes ``names`` (one name or a
    tuple)."""
    names = (names,) if isinstance(names, str) else tuple(names)
    return math.prod(mesh.size(AXES.index(n)) for n in names)


def axis_coordinate(mesh, names) -> int:
    """This rank's position along mesh axes ``names`` taken together, the
    first axis major (how a tuple entry of a PartitionSpec splits a
    dimension)."""
    names = (names,) if isinstance(names, str) else tuple(names)
    pos = 0
    for n in names:
        pos = pos * mesh.size(AXES.index(n)) + mesh.get_local_rank(n)
    return pos


def data_row(spec: MeshSpec, rank: int) -> tuple[int, int]:
    """(index, count) of rank ``rank``'s data row on a mesh of ``spec``:
    its (dp, ep) coordinate, dp major, of dp x ep rows. The pp, sp and tp
    ranks of a data row feed the same rows of the batch. A pure function
    of the spec (ranks lie in C order over ``AXES``), so it is known
    before the process group is."""
    dp, _, ep, _, _ = np.unravel_index(rank, spec.shape)
    return int(dp) * spec.ep + int(ep), spec.dp * spec.ep


def mesh_spec(mesh) -> MeshSpec:
    """The ``MeshSpec`` of a mesh ``build_mesh`` made."""
    return MeshSpec(*(mesh.size(i) for i in range(len(AXES))))
