"""Sharding plans: the part of the JAX package's ``parallel/plan.py`` that
the train step and the step anatomy read.

* ``Plan``: a declarative description of one train step: the mesh spec
  (+ slice count), microbatching for the pipeline trunk, and the
  schedule/virtual-stage knobs. ``make_train_step(plan=)`` takes one.
* ``plan_from_mesh``: the Plan of a mesh ``build_mesh`` made.
* ``estimate_phases``: the cost model's compute/communication split of
  one step, which ``observability.stepstats`` uses to divide a measured
  device residual into compute and collective phases, and its per-axis
  byte estimates.

The compile-cache half of the reference (plan cache keys, the key index,
``instrument_jit``), the planner (``candidate_plans``, ``plan_for``) and
the measurement table (``record_step_time``, ``calibration_residuals``)
are not here yet.

``donate_state`` is kept for the plan's identity; the port's train step
updates its state in place whatever it says.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

from tony_tpu_torch.parallel.mesh import AXES, MeshSpec, build_mesh, mesh_spec


@dataclass(frozen=True)
class Plan:
    """A declarative plan: how one train step is sharded.

    ``microbatches=None`` selects the plain trunk; any integer selects the
    pipeline trunk (``forward_pipeline``)."""

    mesh_spec: MeshSpec
    num_slices: int = 1
    microbatches: int | None = None
    pipeline_schedule: str = "gpipe"
    pipeline_virtual: int = 1
    donate_state: bool = True

    @property
    def trunk(self) -> str:
        return "pipeline" if self.microbatches is not None else "gspmd"

    @property
    def num_devices(self) -> int:
        return self.mesh_spec.num_devices

    def build_mesh(self, device="cuda", **kwargs):
        return build_mesh(self.mesh_spec, device,
                          num_slices=self.num_slices, **kwargs)

    def train_step_kwargs(self) -> dict[str, Any]:
        """kwargs for ``make_train_step`` implied by this plan."""
        return {
            "pipeline_microbatches": self.microbatches,
            "pipeline_schedule": self.pipeline_schedule,
            "pipeline_virtual": self.pipeline_virtual,
        }

    def key(self) -> str:
        """Short stable id for measurement tables and log lines."""
        s = self.mesh_spec
        parts = [f"dp{s.dp}", f"pp{s.pp}", f"ep{s.ep}", f"sp{s.sp}",
                 f"tp{s.tp}"]
        if self.num_slices > 1:
            parts.append(f"x{self.num_slices}sl")
        if self.microbatches is not None:
            parts.append(f"mb{self.microbatches}")
            if self.pipeline_schedule != "gpipe":
                parts.append(f"{self.pipeline_schedule}{self.pipeline_virtual}")
        return ".".join(parts)

    def describe(self) -> dict[str, Any]:
        return {
            "mesh": dict(zip(AXES, self.mesh_spec.shape)),
            "num_slices": self.num_slices,
            "trunk": self.trunk,
            "microbatches": self.microbatches,
            "schedule": self.pipeline_schedule,
            "virtual": self.pipeline_virtual,
        }


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------

# The reference's relative cost units, copied as they are: they were set
# for TPU interconnect (ICI links, DCN between slices) and are not times.
# They are recalibrated for NVLink and NCCL with the measurement table.
# Relative per-byte cost of a collective on each axis; dp crossing slices
# costs _DCN_PENALTY times more.
_COMM_COST = {"tp": 1.0, "sp": 1.3, "ep": 1.8, "pp": 0.6, "dp": 0.4}
_DCN_PENALTY = 12.0

# Flop-equivalents per communicated element.
_ELEM_UNIT = 8000.0

# Fixed launch overhead per collective hop, in the same flop-equivalent
# units as the compute term.
_HOP_LATENCY = {"tp": 1.0, "sp": 1.5, "ep": 2.0, "pp": 1.0, "dp": 0.5}
_HOP_UNIT = 1e6


def estimate_phases(
    plan: Plan,
    cfg,
    *,
    global_batch: int | None = None,
    seq: int | None = None,
) -> dict[str, Any]:
    """The cost model's compute/communication decomposition for one
    plan: ``{"compute": units, "collective": units, "comm_bytes":
    {axis: bytes/step}}``. Units are arbitrary but shared, so the share
    (collective / total) and the bytes are meaningful without a
    measurement. A pipeline axis without microbatching reads as infinite
    compute."""
    s = plan.mesh_spec
    d_model = getattr(cfg, "d_model", 512)
    d_ff = getattr(cfg, "d_ff", 4 * d_model)
    n_layers = getattr(cfg, "n_layers", 1)
    n_heads = getattr(cfg, "n_heads", 8)
    head_dim = getattr(cfg, "head_dim", 64)
    n_kv = getattr(cfg, "n_kv_heads", 0) or n_heads
    seq = seq or getattr(cfg, "max_seq", 1024)
    batch = global_batch or max(s.dp * s.ep, 1)

    # Model flops per step (PaLM 6N counting + causal attention term).
    n_params = n_layers * (
        d_model * (n_heads + 2 * n_kv) * head_dim
        + n_heads * head_dim * d_model
        + 3 * d_model * d_ff
    ) + 2 * getattr(cfg, "vocab_size", 32000) * d_model
    flops = 6.0 * n_params * batch * seq \
        + 6.0 * n_layers * batch * seq * seq * n_heads * head_dim
    compute = flops / plan.num_devices

    # Fill penalty: each tp-split matmul contraction below 128 lanes
    # leaves the matrix unit proportionally idle.
    def fill(dim: int) -> float:
        return max(1.0, 128.0 / max(dim, 1)) ** 0.5

    compute *= fill(d_ff // s.tp) * fill((n_heads // s.tp) * head_dim)

    # Pipeline bubble (gpipe): (pp-1) of (m + pp - 1) ticks are idle.
    if plan.microbatches:
        m = plan.microbatches
        compute *= (m + s.pp - 1) / m
    elif s.pp > 1:
        compute = math.inf

    # Communication volumes per axis, in elements.
    act = batch * seq * d_model / max(s.dp * s.ep * s.sp, 1)
    elems: dict[str, float] = {}
    if s.tp > 1:  # 4 (ag + rs) pairs per layer on the megatron split
        elems["tp"] = 4 * n_layers * act * (s.tp - 1) / s.tp
    if s.sp > 1:  # ring K/V pass per layer
        kv = batch * seq * n_kv * head_dim / max(s.dp * s.ep, 1)
        elems["sp"] = 2 * n_layers * kv * (s.sp - 1) / s.sp
    if s.ep > 1:  # token all_to_all both ways per layer
        elems["ep"] = 2 * n_layers * act * (s.ep - 1) / s.ep
    if s.pp > 1:  # stage-boundary activations across pp-1 boundaries
        elems["pp"] = act * (s.pp - 1)
    if s.dp > 1:  # gradient mean over the sharded params
        elems["dp"] = 2 * n_params * (s.dp - 1) / s.dp
    comm = sum(
        _COMM_COST[ax] * (
            _DCN_PENALTY if ax == "dp" and plan.num_slices > 1 else 1.0
        ) * v
        for ax, v in elems.items()
    )
    # Fixed launch overhead: (axis_size - 1) hops per collective round.
    hops = sum(
        _HOP_LATENCY[ax] * (getattr(s, ax) - 1) * n_layers
        for ax in ("tp", "sp", "ep", "pp")
    ) + _HOP_LATENCY["dp"] * (s.dp - 1)
    elem_bytes = 2.0 if "16" in str(getattr(cfg, "dtype", "")) else 4.0
    return {
        "compute": compute,
        "collective": comm * _ELEM_UNIT + hops * _HOP_UNIT,
        "comm_bytes": {ax: v * elem_bytes for ax, v in elems.items()},
    }


def plan_from_mesh(mesh, *, microbatches: int | None = None,
                   num_slices: int = 1, **kwargs) -> Plan:
    """The Plan implied by a mesh ``build_mesh`` made: axis sizes come
    from the mesh's shape."""
    return Plan(mesh_spec(mesh), num_slices=num_slices,
                microbatches=microbatches, **kwargs)
