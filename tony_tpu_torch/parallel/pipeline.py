"""Pipeline parallelism: layer stages on the ``pp`` mesh axis, activations
handed from stage to stage under a microbatch schedule. The port's
counterpart of the JAX package's ``parallel/pipeline.py``.

Two schedules, the JAX package's:

* ``"gpipe"``: m + pp - 1 ticks of one whole stage each; bubble fraction
  (pp - 1) / (m + pp - 1).
* ``"interleaved"``: Megatron's virtual stages. Each rank holds v
  round-robin chunks of depth L / (v * pp) (chunk c of rank d is global
  virtual stage c * pp + d); v * m + pp ticks of one chunk each. The ring
  transfer wraps stage pp - 1 back to stage 0, which both feeds chunk
  c + 1 and delivers the final outputs to stage 0.

``schedule_info`` is the single source of truth for tick counts. The
schedule is apart from the transport, as in ``ring.py``: a ``_StageRun`` is
one stage's side of a schedule, a tick at a time, and the caller hands each
tick's output on. ``pipeline_apply`` runs this rank's stage and hands the
output to the next rank with ``collectives.ppermute`` over the pp axis
(NCCL or gloo send/recv, whose backward sends each cotangent back to the
stage that sent the activation); ``pipeline_apply_in_process`` runs every
stage of a pipeline in this process, tick by tick, handing each stage's
output to the next by a list shift. Both run the same ticks and the same
stage calls.

Every rank runs every tick, bubble ticks included (on garbage
activations, as the JAX package's scan does), and sends and receives after
every tick but the last, whose transfer JAX's scan makes and drops. A
stage's input is ``collectives.select``'s pick between the injected
microbatch and what arrived, so the unused one stays in the backward graph
at a zero gradient: without it a rank's backward would skip that
transfer's reverse send while its peers wait for it. The stage aux is
accumulated by selection, never by multiplying with a mask: a bubble
tick's aux may be non-finite, and 0 * inf is NaN. The selection is on the
tick's own validity, a Python condition, so a bubble tick's aux leaves the
backward graph too (a zero cotangent through a non-finite local derivative
would be NaN there).

Where the port differs from the JAX package:

* ``pipeline_apply`` takes **this rank's** stage parameters (GPipe: the
  leaves of its L/pp layers; interleaved: its v chunks stacked [v, ...]),
  not the global [pp, ...] stack: the port has no global arrays.
  ``pipeline_apply_in_process`` takes the global stack.
* The outputs are kept as a list indexed by microbatch, written at valid
  ticks only: the values of JAX's clamped overwrite, with no in-place
  write into a tensor autograd saved. The last tick of the interleaved
  schedule only records (its compute is a bubble tick on every rank and
  feeds nothing).
* The input enters the pipeline through ``copy_to`` over pp (identity
  forward, the cotangents summed over pp backward) and the outputs leave
  through ``reduce_from`` over pp of the holder's outputs and the other
  ranks' zeros (JAX's masked ``psum``, whose transpose keeps each rank's
  own cotangent: a backward that summed over pp would hand the holder pp
  times the gradient).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from tony_tpu_torch.parallel.collectives import (
    anchor,
    copy_to,
    ppermute,
    reduce_from,
    select,
)
from tony_tpu_torch.parallel.mesh import axis_coordinate, axis_size

SCHEDULES = ("gpipe", "interleaved")


@dataclass(frozen=True)
class ScheduleInfo:
    """Tick accounting for a pipeline schedule (the single source of
    truth: the schedules take their tick counts from it, tests their
    bubble fractions). ``tick_layers`` is the work of a tick in layers;
    ``bubble_fraction`` is the idle time of a rank over the makespan."""

    ticks: int
    tick_layers: float
    bubble_fraction: float


def schedule_info(schedule: str, num_micro: int, pp: int, n_layers: int,
                  virtual: int = 1) -> ScheduleInfo:
    if schedule == "gpipe":
        # Each rank is busy num_micro of the ticks: idle = pp - 1.
        ticks = num_micro + pp - 1
        return ScheduleInfo(ticks=ticks, tick_layers=n_layers / pp,
                            bubble_fraction=(pp - 1) / ticks)
    if schedule == "interleaved":
        # +pp (not +pp-1): the wrap hop that lands the last microbatch's
        # final output on stage 0 costs one extra tick. Each rank is busy
        # virtual*num_micro of the ticks: idle = pp ticks, each 1/virtual
        # the work of a GPipe tick.
        ticks = virtual * num_micro + pp
        return ScheduleInfo(ticks=ticks,
                            tick_layers=n_layers / (virtual * pp),
                            bubble_fraction=pp / ticks)
    raise ValueError(f"unknown schedule {schedule!r}")


def check_schedule(batch: int, num_microbatches: int, pp: int,
                   schedule: str, virtual: int) -> None:
    """The JAX package's refusals, with its messages: a batch the
    microbatches do not divide, an unknown schedule, an interleaved one
    whose microbatches pp does not divide or with virtual < 1, and
    virtual > 1 without it."""
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible by "
                         f"{num_microbatches} microbatches")
    check_schedule_args(num_microbatches, pp, schedule, virtual)


def check_schedule_args(num_microbatches: int, pp: int, schedule: str,
                        virtual: int) -> None:
    """``check_schedule`` less the batch."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "interleaved":
        if num_microbatches % pp:
            # The tight interleave needs whole pp-sized microbatch blocks.
            raise ValueError(
                f"interleaved schedule needs num_microbatches "
                f"({num_microbatches}) divisible by pp ({pp})")
        if virtual < 1:
            raise ValueError(f"virtual must be >= 1, got {virtual}")
    elif virtual != 1:
        raise ValueError("virtual > 1 requires schedule='interleaved'")


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_map2(fn: Callable, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _clip(x: int, lo: int, hi: int) -> int:
    return min(max(x, lo), hi)


class _StageRun:
    """Stage ``stage`` of ``pp``'s side of a schedule, a tick at a time.
    ``tick(t)`` computes the tick (and records the outputs that reach this
    stage) and returns its output to hand on, or None when the tick only
    records; the caller sets ``state`` to what arrives before the next
    tick. ``x_mb``: the microbatches [m, mb, ...]; ``params``: the stage's
    (GPipe) or its chunks stacked [v, ...] (interleaved)."""

    def __init__(self, stage_fn, params, x_mb, *, schedule: str, pp: int,
                 stage: int, virtual: int, stage_aux: bool):
        self.stage_fn, self.params, self.x_mb = stage_fn, params, x_mb
        self.schedule, self.pp, self.stage = schedule, pp, stage
        self.virtual, self.stage_aux = virtual, stage_aux
        self.m = x_mb.shape[0]
        self.ticks = schedule_info(schedule, self.m, pp, 0, virtual).ticks
        self.state = torch.zeros_like(x_mb[0])
        self.recorded: list = [None] * self.m
        self.aux = None
        # GPipe's outputs leave stage pp - 1; interleaved ones arrive on
        # stage 0 over the wrap.
        self.holder = pp - 1 if schedule == "gpipe" else 0

    def tick(self, t: int):
        pp, m, v = self.pp, self.m, self.virtual
        u = t - self.stage  # the stage's local tick
        if self.schedule == "gpipe":
            i, inject = _clip(t, 0, m - 1), self.stage == 0
            params = self.params
            busy = m
        else:
            # Group g = u // pp picks block g // v of pp microbatches and
            # chunk c = g % v; microbatch i = (g // v) * pp + u % pp.
            # Stage 0, chunk 0 injects a fresh microbatch.
            g = _clip(u // pp, 0, v * (m // pp) - 1)
            c = g % v
            i = _clip((g // v) * pp + u % pp, 0, m - 1)
            inject = self.stage == 0 and c == 0
            params = _tree_map(lambda p: p[c], self.params)
            busy = v * m
            # What arrived is a final output on stage 0 if the sender
            # (stage pp - 1, one tick ago) ran chunk v - 1: c_s == v - 1.
            u_s = t - pp
            g_s = u_s // pp
            if u_s >= 0 and g_s % v == v - 1:
                j = _clip((g_s // v) * pp + u_s % pp, 0, m - 1)
                self.recorded[j] = self.state
            if t == self.ticks - 1:
                return None
        x_in = select(inject, self.x_mb[i], self.state)
        if self.stage_aux:
            y, aux = self.stage_fn(params, x_in)
            # Selection, on the tick's own validity: a bubble tick's aux
            # (garbage in, maybe non-finite) leaves neither the sum nor
            # the backward graph.
            if not 0 <= u < busy:
                aux = _tree_map(torch.zeros_like, aux)
            self.aux = aux if self.aux is None else _tree_map2(
                torch.add, self.aux, aux)
        else:
            y = self.stage_fn(params, x_in)
        if self.schedule == "gpipe" and 0 <= t - (pp - 1) < m:
            self.recorded[t - (pp - 1)] = y
        return y

    def outputs(self) -> torch.Tensor:
        """[m, mb, ...]: the outputs recorded (every stage records at the
        same ticks, so every rank builds the same graph)."""
        if any(r is None for r in self.recorded):
            raise AssertionError("a microbatch's output was never recorded")
        return torch.stack(self.recorded)


def _microbatches(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    mb = x.shape[0] // num_microbatches
    return x.reshape(num_microbatches, mb, *x.shape[1:])


def pipeline_apply(stage_fn, stage_params, x: torch.Tensor, *, mesh,
                   num_microbatches: int, axis_name: str = "pp",
                   schedule: str = "gpipe", virtual: int = 1,
                   stage_aux: bool = False):
    """Apply ``stage_fn(params, x) -> y`` through the pp stages of the
    mesh. ``stage_fn`` maps a microbatch to one of the same shape.

    ``stage_params``: this rank's stage (see the module note): for
    ``"gpipe"`` what ``stage_fn`` takes; for ``"interleaved"`` its
    ``virtual`` chunks, every leaf stacked [virtual, ...], chunk c being
    global virtual stage c * pp + this rank's stage. ``x`` [batch, ...]:
    the same on every pp rank (this rank's part over the other axes);
    ``num_microbatches`` must divide the batch. Returns [batch, ...] on
    every pp rank, and with ``stage_aux`` (``stage_fn`` returns (y, aux), a
    dict of scalars) also the sum of every valid tick's aux over the
    ticks and the stages."""
    pp = axis_size(mesh, axis_name)
    check_schedule(x.shape[0], num_microbatches, pp, schedule, virtual)
    x_mb = _microbatches(copy_to(x, mesh, axis_name), num_microbatches)
    run = _StageRun(stage_fn, stage_params, x_mb, schedule=schedule, pp=pp,
                    stage=axis_coordinate(mesh, axis_name), virtual=virtual,
                    stage_aux=stage_aux)
    for t in range(run.ticks):
        y = run.tick(t)
        if t < run.ticks - 1:
            run.state = ppermute((y,), axis_name, mesh=mesh)[0]
    out = run.outputs()
    out = reduce_from(select(run.stage == run.holder, out,
                             torch.zeros_like(out)), mesh, axis_name)
    out = out.reshape(x.shape[0], *out.shape[2:])
    if not stage_aux:
        return out
    return out, _tree_map(lambda a: reduce_from(a, mesh, axis_name), run.aux)


def pipeline_apply_in_process(stage_fn, stacked_params, x: torch.Tensor,
                              pp: int, *, num_microbatches: int,
                              schedule: str = "gpipe", virtual: int = 1,
                              stage_aux: bool = False):
    """Every stage of a pipeline of ``pp`` run in this process, tick by
    tick: each tick runs every stage's ``_StageRun``, then hands stage s's
    output to stage s + 1 (mod pp) by a list shift. ``stacked_params``:
    every leaf stacked [pp, ...] (GPipe) or [pp, virtual, ...]
    (interleaved), the JAX package's ``stage_params``. Returns what
    ``pipeline_apply`` returns. Differentiable: autograd follows the list
    shift as the distributed backward follows the sends, and runs the
    backward of every tick of every stage, as across ranks."""
    check_schedule(x.shape[0], num_microbatches, pp, schedule, virtual)
    x_mb = _microbatches(x, num_microbatches)
    runs = [_StageRun(stage_fn, _tree_map(lambda p: p[s], stacked_params),
                      x_mb, schedule=schedule, pp=pp, stage=s,
                      virtual=virtual, stage_aux=stage_aux)
            for s in range(pp)]
    ticks = runs[0].ticks
    for t in range(ticks):
        ys = [run.tick(t) for run in runs]
        if t < ticks - 1:
            for s, run in enumerate(runs):
                run.state = ys[(s - 1) % pp]
    holder = runs[0].holder
    # The other stages' records are anchored as the distributed masked sum
    # anchors them: the backward runs every tick of every stage, as it
    # does across ranks.
    out = anchor(runs[holder].outputs(),
                 *(run.outputs() for s, run in enumerate(runs)
                   if s != holder))
    out = out.reshape(x.shape[0], *out.shape[2:])
    if not stage_aux:
        return out
    total = runs[0].aux
    for run in runs[1:]:
        total = _tree_map2(torch.add, total, run.aux)
    return out, total
