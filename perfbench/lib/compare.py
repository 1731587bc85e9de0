"""The comparison that decides ``correct``: the program's first train
steps against the reference's on the same weights and batches.

Three numbers, each held to its limit (``limits/<workload>.json``):

* ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  over the compared steps;
* ``grad_gap``: over the leaves, the largest gap between the norm of the
  first clipped gradient (the program's worked out from AdamW's first
  moment after one step) and the reference's, as a share of the larger
  of that leaf's reference norm and the median leaf's;
* ``change_gap``: the same over the norm of each leaf's change over the
  compared steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (nought to rounding: Adam moves them by
  round-off alone).
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
QUIET_LEAF = 1e-3


def _worst(prog: dict, ref: dict, leaves) -> tuple[float, str]:
    floor = statistics.median(abs(ref[k]) for k in ref)
    worst, where = 0.0, ""
    for k in leaves:
        got = prog.get(k, math.nan)
        gap = abs(got - ref[k]) / max(abs(ref[k]), floor, 1e-30)
        if not gap <= worst:  # NaN wins
            worst, where = gap, k
    return worst, where


def gaps(prog: dict, ref: dict) -> dict:
    """{number: (value, where)} of program readings against the
    reference's (``reference.model.train``'s form)."""
    steps = len(ref["loss"])
    loss = 0.0
    for i in range(steps):
        got = prog["loss"][i] if i < len(prog["loss"]) else math.nan
        gap = abs(got - ref["loss"][i]) / max(abs(ref["loss"][i]), 1e-30)
        if not gap <= loss:
            loss = gap
    floor = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= QUIET_LEAF * floor]
    return {
        "loss_gap": (loss, f"{steps} steps"),
        "grad_gap": _worst(prog["grad"], ref["grad"], ref["grad"]),
        "change_gap": _worst(prog["change"], ref["change"], moving),
    }


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit", "where"}}); a number that is
    not finite fails."""
    checks = {}
    ok = True
    for name in NUMBERS:
        value, where = found[name]
        limit = float(limits[name])
        checks[name] = {"value": value, "limit": limit, "where": where}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
