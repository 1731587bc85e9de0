"""Structured, seedable fault injection: the user-process half of
``tony.fault.plan``.

The port's copy of the JAX package's ``resilience/faults.py``, with its
names and semantics. The orchestrator validates the plan, runs the
coordinator, scheduler and executor faults itself, and exports the plan to
every task as ``TONY_FAULT_PLAN``. A port process reads it here and obeys the
four faults that fire inside the user process:

=====================  =====================================================
action                 injection point in the port
=====================  =====================================================
fail_checkpoint_write  ``CheckpointManager``'s persist stage at ``step``:
                       ``mode: "error"`` raises where a real disk or GCS
                       failure would (surfaced by ``wait()`` or the next
                       save); ``mode: "partial"`` writes the shard but
                       withholds the commit sidecar and the step marker,
                       a torn step that no reader may surface
delay_checkpoint_write the persist stage sleeps ``ms`` before each of the
                       next ``count`` writes (optionally only at ``step``)
throttle_io            the reader's batch iterator (and the train CLI's
                       synthetic corpus) sleeps ``ms`` before each of the
                       next ``count`` batches once ``after_batches`` have
                       been served, inside ``next()``, so the step anatomy
                       reads it as ``data_wait``
degrade_task           the train CLI sleeps ``ms`` after each of the next
                       ``count`` steps past ``after_steps``, after the
                       loss readback, so it reads as step wall;
                       incarnation 0 only (``TONY_TASK_INCARNATION``)
=====================  =====================================================

``FaultPlan.parse`` validates every action a JAX plan may hold, so a plan
that the orchestrator accepts parses here too and one it refuses is refused
with the same errors. Every fault may carry ``"session": n`` and
``"count": k`` (default 1); ``target`` is ``"job:index"``.

The consumers' plans are lazy process singletons keyed on the environment
(``TONY_FAULT_PLAN``, ``JOB_NAME``/``TASK_INDEX``, ``SESSION_ID``,
``TONY_TASK_INCARNATION``), parsed once per process as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Sequence

from tony_tpu_torch import constants

log = logging.getLogger(__name__)

ANY_NON_CHIEF = "any_non_chief"

CRASH_COORDINATOR = "crash_coordinator"
KILL_TASK = "kill_task"
EXIT_EXECUTOR = "exit_executor"
DROP_HEARTBEATS = "drop_heartbeats"
DELAY_HEARTBEATS = "delay_heartbeats"
BLACKOUT_RPC = "blackout_rpc"
FAIL_CHECKPOINT_WRITE = "fail_checkpoint_write"
DELAY_CHECKPOINT_WRITE = "delay_checkpoint_write"
THROTTLE_IO = "throttle_io"
DEGRADE_TASK = "degrade_task"
CRASH_SCHEDULER = "crash_scheduler"
PARTITION_SCHEDULER = "partition_scheduler"

COORDINATOR_PHASES = ("prepare", "schedule", "monitor")
# Scheduler-daemon crash boundaries (crash_scheduler's ``at``): right
# after a write-ahead journal append with the transition not yet acted
# on; between a tick's lease sweeps and its pop loop; and right before
# the snapshot publish.
SCHEDULER_PHASES = ("post-journal", "mid-tick", "pre-publish")

# action → (required fields, optional fields). "session" and "count" are
# legal everywhere; everything else must be declared here — unknown fields
# are validation errors, not silent no-ops (a typo'd field name must not
# turn a chaos test into a pass-by-accident).
_FIELDS: dict[str, tuple[frozenset[str], frozenset[str]]] = {
    CRASH_COORDINATOR: (frozenset({"phase"}), frozenset({"code"})),
    KILL_TASK: (
        frozenset({"target"}),
        frozenset({"at", "after_heartbeats", "after_ms", "after_steps"}),
    ),
    EXIT_EXECUTOR: (frozenset({"target"}), frozenset({"at", "code"})),
    DROP_HEARTBEATS: (frozenset({"target"}), frozenset()),
    DELAY_HEARTBEATS: (frozenset({"target", "ms"}), frozenset()),
    BLACKOUT_RPC: (frozenset({"ms"}), frozenset({"target", "after_ms"})),
    FAIL_CHECKPOINT_WRITE: (
        frozenset({"step"}), frozenset({"target", "mode"}),
    ),
    DELAY_CHECKPOINT_WRITE: (
        frozenset({"ms"}), frozenset({"target", "step"}),
    ),
    THROTTLE_IO: (
        frozenset({"ms"}),
        frozenset({"target", "after_batches"}),
    ),
    DEGRADE_TASK: (
        frozenset({"target", "ms"}),
        frozenset({"after_steps"}),
    ),
    CRASH_SCHEDULER: (frozenset({"at"}), frozenset({"code"})),
    PARTITION_SCHEDULER: (frozenset({"ms"}), frozenset({"after_ms"})),
}
_COMMON_FIELDS = frozenset({"action", "session", "count"})


class FaultPlanError(ValueError):
    """The plan failed validation; ``errors`` carries every complaint."""

    def __init__(self, errors: Sequence[str]) -> None:
        self.errors = list(errors)
        super().__init__(
            "invalid tony.fault.plan: " + "; ".join(self.errors)
        )


@dataclass(frozen=True)
class FaultSpec:
    action: str
    target: str | None = None
    at: str | None = None
    phase: str | None = None
    session: int | None = None
    count: int = 1
    code: int = 1
    ms: int = 0
    after_ms: int | None = None
    after_heartbeats: int | None = None
    after_steps: int | None = None
    step: int | None = None
    after_batches: int = 0
    mode: str = "error"  # fail_checkpoint_write: "error" | "partial"

    def in_session(self, session: int) -> bool:
        return self.session is None or self.session == session

    def matches_task(self, task_id: str) -> bool:
        return self.target is None or self.target == task_id


def _positive_int(raw: object, what: str, errors: list[str],
                  minimum: int = 0) -> int:
    if isinstance(raw, bool) or not isinstance(raw, int):
        errors.append(f"{what} must be an integer, got {raw!r}")
        return minimum
    if raw < minimum:
        errors.append(f"{what} must be >= {minimum}, got {raw}")
        return minimum
    return raw


def _parse_spec(i: int, obj: object, errors: list[str]) -> FaultSpec | None:
    where = f"faults[{i}]"
    if not isinstance(obj, dict):
        errors.append(f"{where} must be an object, got {type(obj).__name__}")
        return None
    action = obj.get("action")
    if action not in _FIELDS:
        errors.append(
            f"{where}: unknown action {action!r}; legal: "
            f"{sorted(_FIELDS)}"
        )
        return None
    required, optional = _FIELDS[action]
    legal = required | optional | _COMMON_FIELDS
    for f in sorted(set(obj) - legal):
        errors.append(f"{where} ({action}): unknown field {f!r}")
    for f in sorted(required - set(obj)):
        errors.append(f"{where} ({action}): missing required field {f!r}")

    session = obj.get("session")
    if session is not None:
        session = _positive_int(session, f"{where}.session", errors, 1)
    count = _positive_int(obj.get("count", 1), f"{where}.count", errors, 1)
    code = _positive_int(obj.get("code", 1), f"{where}.code", errors, 0)
    ms = _positive_int(obj.get("ms", 0), f"{where}.ms", errors, 0)
    after_ms = obj.get("after_ms")
    if after_ms is not None:
        after_ms = _positive_int(after_ms, f"{where}.after_ms", errors, 0)
    after_hb = obj.get("after_heartbeats")
    if after_hb is not None:
        after_hb = _positive_int(
            after_hb, f"{where}.after_heartbeats", errors, 1
        )
    after_steps = obj.get("after_steps")
    if after_steps is not None:
        # Floor depends on the action: a kill at "0 steps observed" can
        # never trigger (the counter starts advancing at 1), while
        # degrade_task's after_steps=0 means "slow from the first step".
        after_steps = _positive_int(
            after_steps, f"{where}.after_steps", errors,
            1 if action == KILL_TASK else 0,
        )
    step = obj.get("step")
    if step is not None:
        step = _positive_int(step, f"{where}.step", errors, 0)
    after_batches = _positive_int(
        obj.get("after_batches", 0), f"{where}.after_batches", errors, 0
    )

    target = obj.get("target")
    if target is not None:
        if not isinstance(target, str) or not target:
            errors.append(f"{where}.target must be a non-empty string")
            target = None
        elif target != ANY_NON_CHIEF and ":" not in target:
            errors.append(
                f"{where}.target must be 'job:index' or "
                f"{ANY_NON_CHIEF!r}, got {target!r}"
            )
    at = obj.get("at")
    phase = obj.get("phase")

    if action == CRASH_COORDINATOR and phase not in COORDINATOR_PHASES:
        errors.append(
            f"{where}.phase must be one of {list(COORDINATOR_PHASES)}, "
            f"got {phase!r}"
        )
    if action == KILL_TASK:
        triggers = [
            t for t in (at, after_hb, after_ms, after_steps)
            if t is not None
        ]
        if len(triggers) != 1:
            errors.append(
                f"{where} (kill_task): exactly one trigger required — "
                f"at='rendezvous', after_heartbeats, after_ms, or "
                f"after_steps"
            )
        if at is not None and at != "rendezvous":
            errors.append(
                f"{where}.at must be 'rendezvous' for kill_task, got {at!r}"
            )
        if target == ANY_NON_CHIEF and at is None:
            errors.append(
                f"{where}: target {ANY_NON_CHIEF!r} is only legal with "
                f"at='rendezvous' (timed/heartbeat/step kills need a "
                f"concrete task)"
            )
    if action == EXIT_EXECUTOR:
        if at is None:
            at = "pre_register"
        if at != "pre_register":
            errors.append(
                f"{where}.at must be 'pre_register' for exit_executor, "
                f"got {at!r}"
            )
        if code == 0:
            # Exit 0 pre-registration injects no failure — it marks the
            # task COMPLETED-successfully and leaves the rest of the gang
            # blocked at the barrier forever. A plan must not silently
            # test nothing (or hang).
            errors.append(
                f"{where}.code must be nonzero for exit_executor"
            )
        if target == ANY_NON_CHIEF:
            errors.append(
                f"{where}: exit_executor needs a concrete 'job:index' "
                f"target"
            )
    if action in (DROP_HEARTBEATS, DELAY_HEARTBEATS, FAIL_CHECKPOINT_WRITE,
                  DELAY_CHECKPOINT_WRITE, THROTTLE_IO, DEGRADE_TASK):
        if target == ANY_NON_CHIEF:
            errors.append(
                f"{where}: {action} needs a concrete 'job:index' target"
            )
    if action == CRASH_SCHEDULER and at not in SCHEDULER_PHASES:
        errors.append(
            f"{where}.at must be one of {list(SCHEDULER_PHASES)} for "
            f"crash_scheduler, got {at!r}"
        )
    if action == PARTITION_SCHEDULER and ms == 0:
        errors.append(
            f"{where}.ms must be nonzero for partition_scheduler (a "
            f"0 ms partition tests nothing)"
        )
    if action in (THROTTLE_IO, DEGRADE_TASK, DELAY_CHECKPOINT_WRITE) \
            and ms == 0:
        errors.append(
            f"{where}.ms must be nonzero for {action} (a 0 ms "
            f"slowdown tests nothing)"
        )
    mode = obj.get("mode", "error")
    if action == FAIL_CHECKPOINT_WRITE and mode not in ("error", "partial"):
        errors.append(
            f"{where}.mode must be 'error' or 'partial' for "
            f"fail_checkpoint_write, got {mode!r}"
        )
        mode = "error"

    return FaultSpec(
        action=action, target=target, at=at, phase=phase, session=session,
        count=count, code=code, ms=ms, after_ms=after_ms,
        after_heartbeats=after_hb, after_steps=after_steps, step=step,
        after_batches=after_batches, mode=str(mode),
    )


@dataclass
class FaultPlan:
    seed: int = 0
    specs: list[FaultSpec] = field(default_factory=list)
    raw: str = ""   # the JSON text, for re-export into the user process env

    # -- construction -------------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        errors: list[str] = []
        try:
            data = json.loads(text)
        except ValueError as exc:
            raise FaultPlanError([f"not valid JSON: {exc}"]) from None
        if not isinstance(data, dict):
            raise FaultPlanError(
                [f"plan must be a JSON object, got {type(data).__name__}"]
            )
        for f in sorted(set(data) - {"seed", "faults"}):
            errors.append(f"unknown top-level field {f!r}")
        seed = data.get("seed", 0)
        if isinstance(seed, bool) or not isinstance(seed, int):
            errors.append(f"seed must be an integer, got {seed!r}")
            seed = 0
        faults = data.get("faults", [])
        if not isinstance(faults, list):
            errors.append("faults must be a list")
            faults = []
        specs = []
        for i, obj in enumerate(faults):
            spec = _parse_spec(i, obj, errors)
            if spec is not None:
                specs.append(spec)
        if errors:
            raise FaultPlanError(errors)
        return cls(seed=seed, specs=specs, raw=text)


_ckpt_faults: "CheckpointFaults | None | bool" = False  # False = not loaded


class CheckpointFaults:
    """``fail_checkpoint_write`` + ``delay_checkpoint_write``, enforced
    inside the checkpoint pipeline's persist stage in the user process."""

    def __init__(self, plan: FaultPlan, task_id: str | None,
                 session: int = 1) -> None:
        # Session scoping filters here, like every executor-side fault: a
        # retried session is a fresh process, so the _fired counter cannot
        # span sessions — the session id is what makes "fail once, then
        # recover on retry" expressible.
        self._specs = [
            (i, s) for i, s in enumerate(plan.specs)
            if s.action in (FAIL_CHECKPOINT_WRITE, DELAY_CHECKPOINT_WRITE)
            and (s.target is None or s.target == task_id)
            and s.in_session(session)
        ]
        self._fired: dict[int, int] = {}

    def _take(self, idx: int, spec: FaultSpec) -> bool:
        if self._fired.get(idx, 0) >= spec.count:
            return False
        self._fired[idx] = self._fired.get(idx, 0) + 1
        return True

    def maybe_fail_write(self, step: int) -> None:
        for idx, spec in self._specs:
            if spec.action != FAIL_CHECKPOINT_WRITE or spec.step != step \
                    or spec.mode != "error":
                continue
            if self._take(idx, spec):
                raise OSError(
                    f"fault injection: checkpoint write failed at step "
                    f"{step}"
                )

    def partial_write(self, step: int) -> bool:
        """True when this step's shard should land WITHOUT its commit
        sidecar/marker (fail_checkpoint_write mode=partial): the
        torn-step-unreadability probe."""
        for idx, spec in self._specs:
            if spec.action != FAIL_CHECKPOINT_WRITE or spec.step != step \
                    or spec.mode != "partial":
                continue
            if self._take(idx, spec):
                return True
        return False

    def write_delay_ms(self, step: int) -> int:
        """ms to sleep before this step's persist write (0 = none); a
        ``step``-less delay applies to every write until its count
        drains — the slow-store probe for the off-step-path claim."""
        delay = 0
        for idx, spec in self._specs:
            if spec.action != DELAY_CHECKPOINT_WRITE:
                continue
            if spec.step is not None and spec.step != step:
                continue
            if self._take(idx, spec):
                delay = max(delay, spec.ms)
        return delay


class IoFaults:
    """``throttle_io`` applied batch-by-batch in the user process: the
    input pipeline calls ``maybe_throttle()`` once per batch served and
    this sleeps the configured delay for the next ``count`` batches once
    ``after_batches`` have gone by — a deterministic starved-input
    pipeline, injected where real input stalls happen (so the step
    anatomy attributes it to ``data_wait`` like any real stall)."""

    def __init__(self, plan: FaultPlan, task_id: str | None,
                 session: int = 1, sleep=time.sleep) -> None:
        self._specs = [
            (i, s) for i, s in enumerate(plan.specs)
            if s.action == THROTTLE_IO
            and (s.target is None or s.target == task_id)
            and s.in_session(session)
        ]
        self._sleep = sleep
        self._served = 0
        self._fired: dict[int, int] = {}

    @property
    def active(self) -> bool:
        return bool(self._specs)

    def maybe_throttle(self) -> None:
        self._served += 1
        delay_ms = 0
        for idx, spec in self._specs:
            if self._served <= spec.after_batches:
                continue
            if self._fired.get(idx, 0) >= spec.count:
                continue
            self._fired[idx] = self._fired.get(idx, 0) + 1
            delay_ms = max(delay_ms, spec.ms)
        if delay_ms:
            self._sleep(delay_ms / 1000.0)


class StepFaults:
    """``degrade_task`` applied step-by-step in the user process: the
    train loop calls ``maybe_degrade(step)`` once per step and this
    sleeps the configured delay for the next ``count`` steps past
    ``after_steps`` — a deterministic mid-training straggler, injected
    where real fail-slow hosts hurt (the fleet's MAD scorer sees a
    genuine slow-side step_time_ms outlier).

    Incarnation-scoped on purpose: the fault models a SICK HOST, so it
    applies only to incarnation 0 of its target — an evicted-and-
    replaced copy (TONY_TASK_INCARNATION > 0) runs clean, exactly like
    a replacement landing on healthy hardware. Without this the healing
    loop could never win: the replacement would inherit the slowdown."""

    def __init__(self, plan: FaultPlan, task_id: str | None,
                 session: int = 1, incarnation: int = 0,
                 sleep=time.sleep) -> None:
        self._specs = [
            (i, s) for i, s in enumerate(plan.specs)
            if s.action == DEGRADE_TASK
            and (s.target is None or s.target == task_id)
            and s.in_session(session)
        ] if incarnation == 0 else []
        self._sleep = sleep
        self._fired: dict[int, int] = {}

    @property
    def active(self) -> bool:
        return bool(self._specs)

    def maybe_degrade(self, step: int) -> None:
        delay_ms = 0
        for idx, spec in self._specs:
            if step <= (spec.after_steps or 0):
                continue
            if self._fired.get(idx, 0) >= spec.count:
                continue
            self._fired[idx] = self._fired.get(idx, 0) + 1
            delay_ms = max(delay_ms, spec.ms)
        if delay_ms:
            self._sleep(delay_ms / 1000.0)


_io_faults: "IoFaults | None | bool" = False  # False = not loaded
_step_faults: "StepFaults | None | bool" = False  # False = not loaded


def step_faults_from_env() -> StepFaults | None:
    """Lazy singleton over ``TONY_FAULT_PLAN`` for ``degrade_task`` —
    called from the train CLI's step loop (train.py), so a plan can make
    any task a deterministic straggler without touching the script. Returns None (no per-step
    overhead) when the plan carries no degrade entries or this process
    is a replacement incarnation."""
    global _step_faults
    if _step_faults is not False:
        return _step_faults
    plan, task_id, session = _user_process_plan()
    try:
        incarnation = int(
            os.environ.get(constants.TONY_TASK_INCARNATION, "0") or 0
        )
    except ValueError:
        incarnation = 0
    faults = (
        StepFaults(plan, task_id, session, incarnation=incarnation)
        if plan is not None and any(
            s.action == DEGRADE_TASK for s in plan.specs
        ) else None
    )
    _step_faults = faults if faults is not None and faults.active else None
    return _step_faults


def io_faults_from_env() -> IoFaults | None:
    """Lazy singleton over ``TONY_FAULT_PLAN`` for ``throttle_io`` —
    called from the batch-serving paths (io/reader.py's batch iterator
    and the train CLI's synthetic corpus), so chaos plans can starve the
    input side of any train loop without touching the script."""
    global _io_faults
    if _io_faults is not False:
        return _io_faults
    plan, task_id, session = _user_process_plan()
    _io_faults = (
        IoFaults(plan, task_id, session)
        if plan is not None and any(
            s.action == THROTTLE_IO for s in plan.specs
        ) else None
    )
    return _io_faults


_env_plan: "tuple[FaultPlan | None, str | None, int] | None" = None


def _user_process_plan() -> "tuple[FaultPlan | None, str | None, int]":
    """Parse ``TONY_FAULT_PLAN`` plus the task identity env — the shared
    entry for every user-process fault consumer. Parsed once per
    process (the env is immutable for the process lifetime): a
    malformed plan logs its warning once, not once per consumer."""
    global _env_plan
    if _env_plan is not None:
        return _env_plan
    raw = os.environ.get(constants.TONY_FAULT_PLAN)
    if not raw:
        _env_plan = (None, None, 1)
        return _env_plan
    task_id = None
    if constants.JOB_NAME in os.environ and constants.TASK_INDEX in os.environ:
        task_id = (f"{os.environ[constants.JOB_NAME]}:"
                   f"{os.environ[constants.TASK_INDEX]}")
    try:
        session = int(os.environ.get(constants.SESSION_ID, "1"))
    except ValueError:
        session = 1
    try:
        _env_plan = (FaultPlan.parse(raw), task_id, session)
    except FaultPlanError:
        log.warning("ignoring unparseable %s", constants.TONY_FAULT_PLAN,
                    exc_info=True)
        _env_plan = (None, None, session)
    return _env_plan


def checkpoint_faults_from_env() -> CheckpointFaults | None:
    """Lazy singleton over ``TONY_FAULT_PLAN`` — called from the
    checkpoint manager's persist stage on every write, so the env parse
    happens once per process."""
    global _ckpt_faults
    if _ckpt_faults is not False:
        return _ckpt_faults
    plan, task_id, session = _user_process_plan()
    _ckpt_faults = (
        CheckpointFaults(plan, task_id, session)
        if plan is not None else None
    )
    return _ckpt_faults


def _reset_singletons() -> None:
    """Forget every parsed plan and consumer of this process, so that the
    next ``*_from_env()`` reads the environment again (tests and the smoke
    script run several plans in one process)."""
    global _env_plan, _ckpt_faults, _io_faults, _step_faults
    _env_plan = None
    _ckpt_faults = _io_faults = _step_faults = False
