"""The port's fault injection held against the JAX package on the CPU.

``FaultPlan.parse`` gives JAX's specs on every example plan of
``tony_tpu/resilience/faults.py`` and JAX's error lists on malformed
plans; ``CheckpointFaults``, ``IoFaults`` and ``StepFaults`` take JAX's
decisions call by call for the same plan, task, session and incarnation;
the env singletons agree. Then the seams: the checkpoint manager under
delayed, failed and partial writes leaves JAX's step files, the reader's
throttle sleeps inside ``next()``, the train CLI obeys ``throttle_io`` and
``degrade_task``, and a ``--framework pytorch`` job whose plan fails a
checkpoint write in session 1 resumes in session 2 from the last complete
step."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.checkpoint import CheckpointManager as JaxManager
from tony_tpu.resilience import faults as jax_faults
from tony_tpu_torch import constants
from tony_tpu_torch import train as train_cli
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.io import ShardedRecordReader
from tony_tpu_torch.resilience import faults

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

# Every entry of the example plan in tony_tpu/resilience/faults.py.
EXAMPLE_FAULTS = [
    {"action": "crash_coordinator", "phase": "schedule", "session": 1},
    {"action": "kill_task", "target": "worker:1", "at": "rendezvous"},
    {"action": "kill_task", "target": "any_non_chief", "after_heartbeats": 3},
    {"action": "kill_task", "target": "worker:1", "after_ms": 1500,
     "session": 1},
    {"action": "exit_executor", "target": "worker:0", "at": "pre_register",
     "code": 1},
    {"action": "drop_heartbeats", "target": "worker:0", "count": 10},
    {"action": "delay_heartbeats", "target": "worker:0", "ms": 250,
     "count": 5},
    {"action": "blackout_rpc", "target": "worker:0", "after_ms": 2000,
     "ms": 1500},
    {"action": "kill_task", "target": "worker:1", "after_steps": 5},
    {"action": "fail_checkpoint_write", "step": 10, "count": 1},
    {"action": "fail_checkpoint_write", "step": 10, "mode": "partial"},
    {"action": "delay_checkpoint_write", "ms": 2000, "count": 100},
    {"action": "throttle_io", "target": "worker:0", "ms": 50,
     "after_batches": 4, "count": 100},
    {"action": "degrade_task", "target": "worker:2", "ms": 400,
     "after_steps": 2, "count": 100},
    {"action": "crash_scheduler", "at": "post-journal"},
    {"action": "partition_scheduler", "after_ms": 1000, "ms": 2000},
]

MALFORMED = [
    "not json",
    "[1, 2]",
    json.dumps({"seed": "7", "faults": []}),
    json.dumps({"seed": True}),
    json.dumps({"faults": {}, "extra": 1}),
    json.dumps({"faults": [3, {"action": "nope"}]}),
    json.dumps({"faults": [{"action": "kill_task"}]}),
    json.dumps({"faults": [{"action": "kill_task", "target": "w1",
                            "at": "later", "after_ms": 5}]}),
    json.dumps({"faults": [{"action": "kill_task", "target": "any_non_chief",
                            "after_steps": 0}]}),
    json.dumps({"faults": [{"action": "exit_executor", "target":
                            "any_non_chief", "code": 0}]}),
    json.dumps({"faults": [{"action": "crash_coordinator", "phase": "x",
                            "typo": 1}]}),
    json.dumps({"faults": [{"action": "fail_checkpoint_write", "step": -1,
                            "mode": "torn"}]}),
    json.dumps({"faults": [{"action": "fail_checkpoint_write", "step": 1,
                            "target": "any_non_chief"}]}),
    json.dumps({"faults": [{"action": "delay_checkpoint_write", "ms": 0}]}),
    json.dumps({"faults": [{"action": "throttle_io", "ms": 5,
                            "after_batches": -2, "count": 0}]}),
    json.dumps({"faults": [{"action": "degrade_task", "target": "",
                            "ms": True}]}),
    json.dumps({"faults": [{"action": "degrade_task", "target": "worker:0",
                            "ms": 5, "session": 0, "after_steps": 1.5}]}),
    json.dumps({"faults": [{"action": "crash_scheduler", "at": "never"},
                           {"action": "partition_scheduler"}]}),
    json.dumps({"faults": [{"action": "blackout_rpc", "ms": 10,
                            "after_ms": -1, "code": 3}]}),
]


@pytest.fixture
def fresh_singletons(monkeypatch):
    """Both packages' fault singletons cleared, and cleared again after
    the test: each reads the environment anew."""
    for name, value in (("_env_plan", None), ("_ckpt_faults", False),
                        ("_io_faults", False), ("_step_faults", False)):
        monkeypatch.setattr(jax_faults, name, value)
        monkeypatch.setattr(faults, name, value)
    for key in (constants.TONY_FAULT_PLAN, constants.JOB_NAME,
                constants.TASK_INDEX, constants.SESSION_ID,
                constants.TONY_TASK_INCARNATION):
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


def _arm(monkeypatch, plan: dict, **env) -> None:
    monkeypatch.setenv(constants.TONY_FAULT_PLAN, json.dumps(plan))
    for key, value in env.items():
        monkeypatch.setenv(key, str(value))


# -- parsing ---------------------------------------------------------------

def _parsed(mod, text: str):
    """("ok", seed, specs as dicts, raw) or ("refused", errors, message)."""
    try:
        plan = mod.FaultPlan.parse(text)
    except mod.FaultPlanError as exc:
        assert isinstance(exc, ValueError)
        return ("refused", exc.errors, str(exc))
    return ("ok", plan.seed, [dataclasses.asdict(s) for s in plan.specs],
            plan.raw)


@pytest.mark.parametrize("i", range(len(EXAMPLE_FAULTS)))
def test_each_example_fault_parses_as_jax_s(i):
    text = json.dumps({"seed": i, "faults": [EXAMPLE_FAULTS[i]]})
    got = _parsed(faults, text)
    assert got == _parsed(jax_faults, text)
    # The docstring's heartbeat kill of any_non_chief is refused by JAX's
    # own parser (any_non_chief needs at='rendezvous'); the rest parse.
    assert got[0] == ("refused" if i == 2 else "ok")


def test_the_whole_example_plan_parses_as_jax_s():
    text = json.dumps({"seed": 7, "faults": EXAMPLE_FAULTS})
    assert _parsed(faults, text) == _parsed(jax_faults, text)
    valid = [f for i, f in enumerate(EXAMPLE_FAULTS) if i != 2]
    text = json.dumps({"seed": 7, "faults": valid})
    got = _parsed(faults, text)
    assert got == _parsed(jax_faults, text)
    assert got[0] == "ok" and len(got[2]) == len(valid)
    # The constants the specs name are JAX's.
    for name in ("FAIL_CHECKPOINT_WRITE", "DELAY_CHECKPOINT_WRITE",
                 "THROTTLE_IO", "DEGRADE_TASK", "ANY_NON_CHIEF",
                 "COORDINATOR_PHASES", "SCHEDULER_PHASES"):
        assert getattr(faults, name) == getattr(jax_faults, name)
    assert faults._FIELDS == jax_faults._FIELDS


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_plans_fail_with_jax_s_errors(text):
    got = _parsed(faults, text)
    assert got == _parsed(jax_faults, text)
    assert got[0] == "refused"


# -- decisions -------------------------------------------------------------

CKPT_PLAN = {"faults": [
    {"action": "fail_checkpoint_write", "step": 4},
    {"action": "fail_checkpoint_write", "step": 6, "mode": "partial",
     "count": 2},
    {"action": "fail_checkpoint_write", "step": 8, "target": "worker:1"},
    {"action": "delay_checkpoint_write", "ms": 200, "count": 3},
    {"action": "delay_checkpoint_write", "ms": 500, "step": 6, "count": 2},
    {"action": "delay_checkpoint_write", "ms": 70, "session": 2},
    {"action": "fail_checkpoint_write", "step": 2, "session": 2},
]}
IO_PLAN = {"faults": [
    {"action": "throttle_io", "ms": 50, "after_batches": 2, "count": 3},
    {"action": "throttle_io", "ms": 80, "after_batches": 4,
     "target": "worker:0"},
    {"action": "throttle_io", "ms": 10, "session": 2, "count": 20},
]}
STEP_PLAN = {"faults": [
    {"action": "degrade_task", "target": "worker:0", "ms": 150,
     "after_steps": 2},
    {"action": "degrade_task", "target": "worker:0", "ms": 40,
     "after_steps": 0, "count": 4},
    {"action": "degrade_task", "target": "worker:1", "ms": 90,
     "after_steps": 5, "count": 100, "session": 1},
]}
WHO = [(None, 1), ("worker:0", 1), ("worker:1", 1), ("worker:1", 2)]


def _ckpt_trace(mod, task, session) -> list:
    plan = mod.FaultPlan.parse(json.dumps(CKPT_PLAN))
    cf = mod.CheckpointFaults(plan, task, session)
    out = []
    for step in [2, 4, 4, 6, 6, 6, 8, 8, 10, 2]:
        delay = cf.write_delay_ms(step)
        try:
            cf.maybe_fail_write(step)
            failed = None
        except OSError as exc:
            failed = str(exc)
        out.append((step, delay, failed, cf.partial_write(step)))
    return out


@pytest.mark.parametrize("task,session", WHO)
def test_checkpoint_faults_decide_as_jax_s(task, session):
    got = _ckpt_trace(faults, task, session)
    assert got == _ckpt_trace(jax_faults, task, session)
    assert any(d or f or p for _, d, f, p in got)


def _io_trace(mod, task, session) -> list:
    slept = []
    io_f = mod.IoFaults(mod.FaultPlan.parse(json.dumps(IO_PLAN)), task,
                        session, sleep=slept.append)
    marks = []
    for batch in range(12):
        io_f.maybe_throttle()
        marks.append((batch, list(slept)))
    return [io_f.active, marks]


@pytest.mark.parametrize("task,session", WHO)
def test_io_faults_decide_as_jax_s(task, session):
    assert _io_trace(faults, task, session) == _io_trace(jax_faults, task,
                                                         session)


def _step_trace(mod, task, session, incarnation) -> list:
    slept = []
    sf = mod.StepFaults(mod.FaultPlan.parse(json.dumps(STEP_PLAN)), task,
                        session, incarnation=incarnation, sleep=slept.append)
    marks = []
    for step in range(1, 12):
        sf.maybe_degrade(step)
        marks.append((step, list(slept)))
    return [sf.active, marks]


@pytest.mark.parametrize("incarnation", [0, 1])
@pytest.mark.parametrize("task,session", WHO)
def test_step_faults_decide_as_jax_s(task, session, incarnation):
    got = _step_trace(faults, task, session, incarnation)
    assert got == _step_trace(jax_faults, task, session, incarnation)
    if incarnation:
        assert got[0] is False


@pytest.mark.parametrize("plan,env", [
    (CKPT_PLAN, {}),
    (IO_PLAN, {"JOB_NAME": "worker", "TASK_INDEX": "0"}),
    (STEP_PLAN, {"JOB_NAME": "worker", "TASK_INDEX": "0",
                 "TONY_TASK_INCARNATION": "0"}),
    (STEP_PLAN, {"JOB_NAME": "worker", "TASK_INDEX": "0",
                 "TONY_TASK_INCARNATION": "2"}),
    (STEP_PLAN, {"JOB_NAME": "worker", "TASK_INDEX": "1",
                 "SESSION_ID": "2"}),
    ({"faults": []}, {"SESSION_ID": "junk"}),
    (None, {}),
])
def test_env_singletons_match_jax_s(fresh_singletons, plan, env):
    if plan is not None:
        _arm(fresh_singletons, plan, **env)
    else:
        fresh_singletons.setenv(constants.TONY_FAULT_PLAN, "{not json")
    for name in ("checkpoint_faults_from_env", "io_faults_from_env",
                 "step_faults_from_env"):
        got, want = getattr(faults, name)(), getattr(jax_faults, name)()
        assert (got is None) == (want is None), name
        if got is not None:
            assert type(got).__name__ == type(want).__name__
            assert ([dataclasses.asdict(s) for _, s in got._specs]
                    == [dataclasses.asdict(s) for _, s in want._specs])
        assert getattr(faults, name)() is got  # one per process
    got_plan, want_plan = faults._user_process_plan(), \
        jax_faults._user_process_plan()
    assert got_plan[1:] == want_plan[1:]


def test_reset_singletons_rereads_the_environment(fresh_singletons):
    _arm(fresh_singletons, IO_PLAN)
    first = faults.io_faults_from_env()
    assert first is not None and faults.step_faults_from_env() is None
    _arm(fresh_singletons, STEP_PLAN, JOB_NAME="worker", TASK_INDEX="0")
    assert faults.io_faults_from_env() is first  # parsed once
    faults._reset_singletons()
    assert faults.io_faults_from_env() is None
    assert faults.step_faults_from_env() is not None


# -- the checkpoint manager's persist stage --------------------------------

def _port_state(v: float) -> dict:
    return {"step": torch.tensor(int(v), dtype=torch.int32),
            "params": {"w": torch.full((8, 4), v),
                       "b": torch.full((4,), v / 2.0)}}


def _jax_state(v: float) -> dict:
    return {"step": jnp.asarray(int(v), jnp.int32),
            "params": {"w": jnp.full((8, 4), v),
                       "b": jnp.full((4,), v / 2.0)}}


def _files(root: Path) -> dict[str, list[str]]:
    return {d.name: sorted(p.name for p in d.iterdir())
            for d in sorted(root.iterdir()) if d.is_dir()}


@pytest.mark.parametrize("fault", [
    {"action": "delay_checkpoint_write", "ms": 30, "count": 2},
    {"action": "fail_checkpoint_write", "step": 2},
    {"action": "fail_checkpoint_write", "step": 2, "mode": "partial"},
    {"action": "fail_checkpoint_write", "step": 3, "mode": "partial",
     "count": 2},
])
def test_manager_leaves_jax_s_step_files(fresh_singletons, tmp_path, fault):
    _arm(fresh_singletons, {"faults": [fault]})
    outcomes = {}
    for name, mgr_cls, state in (("jax", JaxManager, _jax_state),
                                 ("port", CheckpointManager, _port_state)):
        root = tmp_path / name
        mgr = mgr_cls(root, max_to_keep=5)
        raised = []
        t0 = time.monotonic()
        for step in (1, 2, 3):
            try:
                mgr.save(step, state(float(step)))
                mgr.wait()
            except RuntimeError as exc:
                raised.append((step, repr(exc.__cause__)))
        # The final save of a run: blocking, like the train CLI's.
        mgr.save(3, state(3.0), blocking=True)
        outcomes[name] = (_files(root), raised, mgr.latest_step(),
                          time.monotonic() - t0)
        # Fresh singletons for the other package's run: each counts its
        # own fired faults, as two processes would.
        for mod in (faults, jax_faults):
            mod._env_plan = None
            mod._ckpt_faults = False
    (jf, jr, jl, jt), (pf, pr, pl, pt) = outcomes["jax"], outcomes["port"]
    assert pf == jf and pl == jl and pr == jr
    # Each package's latest_step reads the other's directory alike.
    assert JaxManager(tmp_path / "port").latest_step() == jl
    assert CheckpointManager(tmp_path / "jax").latest_step() == pl
    if fault["action"] == "delay_checkpoint_write":
        assert pt >= 0.06 and jt >= 0.06
    if fault.get("mode") == "partial":
        torn = f"step_{fault['step']}"
        assert pf[torn] == ["process_0.npz"]


def test_a_failed_write_gives_its_buffers_back(fresh_singletons, tmp_path):
    _arm(fresh_singletons, {"faults": [
        {"action": "fail_checkpoint_write", "step": 2}]})
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _port_state(1.0), blocking=True)
    assert len(mgr._buffers._free) == 1
    mgr.save(2, _port_state(2.0))
    with pytest.raises(RuntimeError) as info:
        mgr.wait()
    assert "fault injection" in str(info.value.__cause__)
    assert len(mgr._buffers._free) == 1  # handed back despite the raise
    # The next save after a surfaced failure is full and commits.
    mgr.save(3, _port_state(3.0), blocking=True)
    assert mgr.latest_step() == 3
    assert json.loads((tmp_path / "step_3" / "process_0.json").read_text()
                      )["kind"] == "full"


def test_delay_stays_off_the_save_call(fresh_singletons, tmp_path):
    _arm(fresh_singletons, {"faults": [
        {"action": "delay_checkpoint_write", "ms": 300, "count": 1}]})
    mgr = CheckpointManager(tmp_path)
    t0 = time.monotonic()
    mgr.save(1, _port_state(1.0))
    call_s = time.monotonic() - t0
    mgr.wait()
    assert call_s < 0.25 <= time.monotonic() - t0


# -- the reader and the train CLI ------------------------------------------

def test_the_reader_throttle_sleeps_inside_next(fresh_singletons, tmp_path):
    _arm(fresh_singletons, {"faults": [
        {"action": "throttle_io", "ms": 100, "after_batches": 1,
         "count": 2}]})
    path = tmp_path / "c.tokens"
    np.arange(10 * 4, dtype=np.uint16).tofile(path)
    io_f = faults.io_faults_from_env()
    served = []
    io_f._sleep = lambda s: served.append((len(got), s))
    got = []
    with ShardedRecordReader([str(path)], fmt="tokens", record_len=4,
                             dtype=np.uint16, batch_size=2) as reader:
        it = iter(reader)
        for _ in range(5):
            got.append(next(it))  # the sleep happens inside this next()
    # Batches 2 and 3 are throttled: each sleep lands in the next() that
    # returns it, after the batches before it were handed out.
    assert served == [(1, 0.1), (2, 0.1)]
    assert np.array_equal(np.concatenate(got).reshape(-1), np.arange(40))


TINY = ["--device", "cpu", "--batch", "2", "--seq", "16", "--d-model", "32",
        "--n-layers", "1", "--n-heads", "2", "--n-kv-heads", "1", "--vocab",
        "64", "--lr", "3e-3"]


def test_train_cli_obeys_throttle_and_degrade(fresh_singletons, tmp_path):
    _arm(fresh_singletons, {"faults": [
        {"action": "throttle_io", "ms": 100, "after_batches": 1, "count": 2},
        {"action": "degrade_task", "target": "worker:0", "ms": 150,
         "after_steps": 2},
    ]}, JOB_NAME="worker", TASK_INDEX="0")
    events = []
    io_f, step_f = faults.io_faults_from_env(), faults.step_faults_from_env()
    # The throttle sleeps on the loop's own thread, inside its next(), not
    # on the device prefetcher's thread.
    io_f._sleep = lambda s: events.append(
        ("throttle", s) if threading.current_thread() is
        threading.main_thread() else ("throttle off the loop", s))
    # A real sleep, so that the step's wall reads it.
    step_f._sleep = lambda s: (events.append(("degrade", s)),
                               time.sleep(0.05))
    reports = []
    real_report = train_cli.observability.report
    fresh_singletons.setattr(
        train_cli.observability, "report",
        lambda **kw: (reports.append(kw), events.append(("step",
                                                         kw["step"])),
                      real_report(**kw)))
    assert train_cli.main(TINY + ["--steps", "5", "--ckpt-dir",
                                  str(tmp_path / "ck")]) == 0
    assert [e for e in events if e[0] != "step"] == [
        ("throttle", 0.1), ("throttle", 0.1), ("degrade", 0.15)]
    # The degrade sleep follows step 3's loss readback and precedes its
    # report; its wall is inside the step's time.
    assert events.index(("degrade", 0.15)) == events.index(("step", 3)) - 1
    walls = [2 * 16 / r["tokens_per_sec"] for r in reports]
    assert walls[2] >= 0.05


@pytest.mark.parametrize("source", ["synthetic", "tokens", "jblk"])
def test_the_loop_throttles_each_source_once_a_batch(fresh_singletons,
                                                     tmp_path, source):
    """The loop's ``throttled`` counts each batch once, whatever the
    corpus: the file sources bypass the reader's own seam."""
    _arm(fresh_singletons, {"faults": [
        {"action": "throttle_io", "ms": 20, "after_batches": 2,
         "count": 2}]})
    slept = []
    io_f = faults.io_faults_from_env()
    io_f._sleep = slept.append
    argv = list(TINY)
    rows = np.tile(np.arange(17, dtype=np.uint16), (12, 1))
    if source == "tokens":
        rows.tofile(tmp_path / "c.tokens")
        argv += ["--data", str(tmp_path / "c.tokens")]
    elif source == "jblk":
        from tony_tpu_torch.io import write_jsonl_blocks

        write_jsonl_blocks(str(tmp_path / "c.jblk"),
                           ({"tokens": r.tolist()} for r in rows))
        argv += ["--data", str(tmp_path / "c.jblk")]
    args = train_cli.parse_args(argv)
    batches = train_cli.throttled(train_cli.corpus_batches(args, 0, 1), io_f)
    for i in range(8):  # past the 6-batch epoch of the file corpora
        assert next(batches).shape == (2, 17)
        assert len(slept) == min(max(i - 1, 0), 2)
        assert io_f._served == i + 1
    assert slept == [0.02, 0.02]


# -- one orchestrated chaos run --------------------------------------------

def test_a_failed_write_is_retried_and_resumed(tmp_path):
    """A --framework pytorch train job whose plan fails the step-6 write in
    session 1, every write of that session delayed 300 ms: the failure
    surfaces at the final save's drain whenever the persist thread runs,
    the session fails and is retried, and session 2 resumes from step 4,
    the last complete step the coordinator probed, and trains to 6."""
    # One 8-token motif repeated: the loss falls step after step, so each
    # session's run descends and exits 0 once it reaches step 6.
    data = tmp_path / "c.tokens"
    motif = np.random.default_rng(0).integers(1, 64, 8)
    np.tile(np.tile(motif, 3)[:17], (8, 1)).astype(np.uint16).tofile(data)
    ck = tmp_path / "ck"
    plan = {"seed": 3, "faults": [
        {"action": "fail_checkpoint_write", "step": 6, "session": 1},
        {"action": "delay_checkpoint_write", "ms": 300, "count": 100,
         "session": 1}]}
    out = tmp_path / "train.out"
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    params = TINY + ["--data", str(data), "--steps", "6",
                     "--checkpoint-every", "2", "--ckpt-dir", str(ck),
                     f">> {out} 2>&1"]
    proc = subprocess.run(
        [sys.executable, "-m", "tony_tpu.client.cli", "local",
         "--executes", str(REPO / "tony_tpu_torch" / "train.py"),
         "--framework", "pytorch",
         "--python_binary_path", sys.executable,
         "--conf", "tony.worker.instances=1",
         "--conf", "tony.ps.instances=0",
         "--conf", f"tony.fault.plan={json.dumps(plan)}",
         "--conf", f"tony.checkpoint.location={ck}",
         "--conf", "tony.am.retry-count=1",
         "--conf", "tony.am.retry-backoff-base=100",
         "--conf", "tony.am.retry-backoff-max=200",
         "--task_params", " ".join(params)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    log = out.read_text() if out.exists() else ""
    assert proc.returncode == 0, (proc.stderr[-2000:], log[-3000:])
    assert "fault injection: checkpoint write failed at step 6" in log
    assert "RuntimeError: async checkpoint write failed" in log
    assert log.count("resumed from step") == 1
    assert "resumed from step 4" in log and "done: loss" in log
    # Session 2 wrote step 6 anew: every step is complete now.
    mgr = CheckpointManager(ck)
    assert mgr.latest_step() == 6
    assert sorted(p.name for p in ck.glob("step_*")) == [
        "step_2", "step_4", "step_6"]
