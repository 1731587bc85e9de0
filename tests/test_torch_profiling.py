"""The port's profiling plane on the CPU, held against the JAX package.

* ``tony_tpu_torch.observability.profiling``: ``clamp_duration_ms``,
  ``user_process_hbm``, ``ProfileBroker`` and ``ExecutorProfiler`` give what
  the JAX package's give on the same inputs and one scripted heartbeat
  sequence; ``run_capture`` writes an artifact with JAX's keys (here, with
  no CUDA, the host snapshot); the HBM monitor writes JAX's gauge keys and
  values from the same fake devices, patched into ``jax.local_devices`` and
  into the port's stats seam; without CUDA neither the monitor nor
  ``runtime.initialize`` starts a thread.
* ``tony_tpu_torch.profiling``: the cases of ``tests/test_profiling.py`` on
  CPU activities (``trace``, its default dir, ``StepProfiler``'s window and
  ``close``, the server without ``PROFILER_PORT``), the one-profiler rule,
  and the profiler-server deviation pinned: with the port set, an HTTP
  endpoint whose ``/profile`` route runs a capture.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import pytest
import torch

from tony_tpu.observability import metrics as jax_metrics
from tony_tpu.observability import profiling as jax_prof
from tony_tpu_torch import constants, profiling, runtime
from tony_tpu_torch.observability import metrics as port_metrics
from tony_tpu_torch.observability import profiling as port_prof

PACKAGES = {"jax": jax_prof, "port": port_prof}


def _work():
    x = torch.ones(64, 64)
    return float((x @ x).sum())


def _traces(root: Path) -> list[Path]:
    return sorted(root.rglob("*.pt.trace.json"))


# -- tests/test_profiling.py's cases, on the port -----------------------------

def test_trace_writes_capture(tmp_path):
    with profiling.trace(str(tmp_path)):
        _work()
    captured = _traces(tmp_path)
    assert len(captured) == 1
    names = {e.get("name") for e in json.loads(
        captured[0].read_text())["traceEvents"]}
    assert "aten::mm" in names


def test_trace_defaults_to_tony_log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(constants.TONY_LOG_DIR, str(tmp_path))
    assert profiling.default_trace_dir() == str(tmp_path / "profile")
    with profiling.trace():
        _work()
    assert _traces(tmp_path / "profile")


def test_step_profiler_window(tmp_path):
    prof = profiling.StepProfiler(start=2, num=2, log_dir=str(tmp_path))
    seen = []
    for step in range(6):
        prof.before_step(step)
        seen.append(prof._active)
        with profiling.annotate("step"):
            _work()
        prof.after_step(step)
    assert seen == [False, False, True, True, False, False]
    assert not prof._active
    (path,) = _traces(tmp_path)
    assert prof.trace_path == str(path)
    events = json.loads(path.read_text())["traceEvents"]
    # Two annotated steps inside the window, none outside it.
    assert sum(e.get("name") == "step" and e.get("cat") == "user_annotation"
               for e in events) == 2


def test_step_profiler_resumed_mid_window_still_profiles(tmp_path):
    prof = profiling.StepProfiler(start=2, num=3, log_dir=str(tmp_path))
    prof.before_step(3)  # a loop resumed at step 3, inside the window
    assert prof._active
    _work()
    prof.after_step(3)
    assert prof._active
    prof.before_step(4)
    prof.after_step(4)
    assert not prof._active and len(_traces(tmp_path)) == 1


def test_step_profiler_close_mid_window(tmp_path):
    prof = profiling.StepProfiler(start=0, num=100, log_dir=str(tmp_path))
    prof.before_step(0)
    _work()
    prof.close()
    assert not prof._active
    assert len(_traces(tmp_path)) == 1
    prof.close()  # idempotent


def test_maybe_start_profiler_server_no_env(monkeypatch):
    monkeypatch.delenv(constants.PROFILER_PORT, raising=False)
    assert profiling.maybe_start_profiler_server() is None
    assert constants.PROFILER_PORT == "PROFILER_PORT"
    assert constants.TONY_PROFILE_HBM_INTERVAL_MS == \
        "TONY_PROFILE_HBM_INTERVAL_MS"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_profiler_server_deviation_serves_a_capture(tmp_path, monkeypatch):
    """Pinned deviation: PyTorch has no jax.profiler.start_server, so the
    reserved port serves an HTTP endpoint whose /profile route runs
    run_capture in this process and answers with the summary."""
    port = _free_port()
    monkeypatch.setenv(constants.PROFILER_PORT, str(port))
    monkeypatch.setenv(constants.TONY_LOG_DIR, str(tmp_path))
    monkeypatch.setenv(constants.JOB_NAME, "worker")
    monkeypatch.setenv(constants.TASK_INDEX, "3")
    try:
        assert profiling.maybe_start_profiler_server() == port
        assert profiling.maybe_start_profiler_server() == port  # once
        url = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{url}/profile?duration_ms=10**9",
                                    timeout=30) as resp:
            summary = json.loads(resp.read())
        # An unparsable duration takes the default; a capture's keys.
        assert summary["duration_ms"] == port_prof.DEFAULT_DURATION_MS
        assert summary["task"] == "worker:3"
        assert summary["snapshot"]["source"] == "host"  # no CUDA here
        assert summary["trace_dir"] is None
        assert (tmp_path / "profile" / summary["artifact"]).is_file()
        with urllib.request.urlopen(f"{url}/profile?duration_ms=5",
                                    timeout=30) as resp:
            assert json.loads(resp.read())["duration_ms"] == 5
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{url}/start_trace", timeout=30)
        assert err.value.code == 404
    finally:
        profiling.stop_profiler_server()


def test_one_profiler_at_a_time(tmp_path, monkeypatch):
    prof = profiling.StepProfiler(start=0, num=2, log_dir=str(tmp_path))
    prof.before_step(0)
    try:
        with pytest.raises(RuntimeError, match="only one may run"):
            with profiling.trace(str(tmp_path / "other")):
                pass
        # A capture while a profiler runs: as in the JAX package, the
        # summary carries a trace_error and the snapshot still ships.
        monkeypatch.setattr(port_prof, "_loaded_torch", lambda: torch)
        summary = port_prof.run_capture("r1", 1, tmp_path / "cap", "w:0")
        assert "already active" in summary["trace_error"]
        assert summary["trace_dir"] is None
        assert isinstance(summary["snapshot"], dict)
    finally:
        prof.close()
    # Free again: a capture in a process with CUDA up traces its window.
    summary = port_prof.run_capture("r2", 1, tmp_path / "cap", "w:0")
    assert "trace_error" not in summary
    assert _traces(Path(summary["trace_dir"]))


def test_concurrent_starts_open_one_profiler(tmp_path):
    """Many threads racing to open a trace: exactly one opens it, the
    others are refused; only the thread that opened it may stop it, and
    the process can trace again after."""
    import sys

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    opened, refused, stopped = [], [], []
    raced = threading.Barrier(16)
    done = threading.Barrier(16)

    def race(i):
        raced.wait(timeout=30)
        try:
            prof = port_prof.start_trace(f"racer {i}")
        except RuntimeError:
            refused.append(i)
            prof = None
        else:
            opened.append(prof)
        done.wait(timeout=30)
        if prof is not None:
            stopped.append(port_prof.stop_trace(prof, tmp_path))

    try:
        threads = [threading.Thread(target=race, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert len(opened) == 1 and len(refused) == 15 and len(stopped) == 1
    assert port_prof._trace_owner is None
    prof = port_prof.start_trace("main")
    other = threading.Thread(target=lambda: refused.append(
        pytest.raises(RuntimeError, port_prof.stop_trace, prof, tmp_path)))
    other.start()
    other.join(timeout=30)
    assert "thread that started it" in str(refused[-1].value)
    port_prof.stop_trace(prof, tmp_path / "again")
    assert _traces(tmp_path / "again")


# -- observability.profiling against the JAX package's -------------------------

@pytest.mark.parametrize("raw,default", [
    ("abc", None), (10**9, None), (None, 500), (-5, None), (0, None),
    ("250", None), (2.9, None), (60_000, None), (60_001, None), ([], 7),
])
def test_clamp_duration_ms_equals_jax(raw, default):
    kw = {} if default is None else {"default": default}
    assert port_prof.clamp_duration_ms(raw, **kw) == \
        jax_prof.clamp_duration_ms(raw, **kw)


@pytest.mark.parametrize("snap", [
    None, {}, {"gauges": "x"},
    {"gauges": {
        'tony_device_hbm_bytes{device="0",kind="bytes_in_use"}': 5,
        'tony_device_hbm_bytes{device="0",kind="bytes_limit"}': "8e9",
        'tony_device_hbm_bytes{device="1",kind="peak"}': "nan?",
        "tony_serving_queue_depth": 3, "train_step": 9}},
])
def test_user_process_hbm_equals_jax(snap):
    assert port_prof.user_process_hbm(snap) == jax_prof.user_process_hbm(snap)


def _heartbeat_script(mod, tmp_path: Path, monkeypatch) -> list:
    """One scripted heartbeat sequence through a broker and two executor
    agents; the normalized record of every command and result."""
    if mod is jax_prof:
        monkeypatch.setattr(jax_prof, "_loaded_jax", lambda: None)
    out_dir = tmp_path / mod.__name__
    broker = mod.ProfileBroker(clock_ms=lambda: 1000)
    agents = {t: mod.ExecutorProfiler(t, out_dir, session_id="1")
              for t in ("w:0", "w:1")}
    record = []
    req = broker.start(agents, duration_ms="20")
    record.append(("start", req))
    for task, agent in agents.items():
        cmd = broker.command_for(task)
        record.append(("command", task, cmd))
        record.append(("again", task, broker.command_for(task)))
        record.append(("handled", task, agent.handle_command(cmd)))
        record.append(("dedupe", task, agent.handle_command(cmd)))
    record.append(("not-a-command", agents["w:0"].handle_command({"x": 1})))
    for task, agent in agents.items():
        deadline = time.monotonic() + 30
        result = None
        while result is None and time.monotonic() < deadline:
            result = agent.take_result()
            time.sleep(0.01)
        assert result is not None
        record.append(("one-shot", agent.take_result()))
        record.append(("result-keys", sorted(result),
                       sorted(result["snapshot"]),
                       result["snapshot"]["source"], result["artifact"]))
        record.append(("recorded", task, broker.record_result(task, result)))
    record.append(("stale", broker.record_result("w:0", {"req_id": "old"})))
    record.append(("failed", broker.record_result(
        "w:1", {"req_id": req, "error": "capture failed"})))
    status = broker.status()
    for t in status["tasks"].values():
        t["summary"] = sorted(t["summary"] or {})
    record.append(("status", status))
    record.append(("second", broker.start(["w:0"])))
    record.append(("profiles", [p.name for p in mod.find_profiles(
        out_dir, None, tmp_path / "absent")]))
    return record


def test_broker_and_executor_agree_with_jax(tmp_path, monkeypatch):
    got = _heartbeat_script(port_prof, tmp_path, monkeypatch)
    want = _heartbeat_script(jax_prof, tmp_path, monkeypatch)
    assert got == want
    status = next(r[1] for r in got if r[0] == "status")
    assert (status["req_id"], status["duration_ms"], status["done"]) == \
        ("prof-1000-1", 20, True)
    assert {t: v["state"] for t, v in status["tasks"].items()} == {
        "w:0": "captured", "w:1": "failed"}


def test_run_capture_artifact_has_jax_keys(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_prof, "_loaded_jax", lambda: None)

    def metrics_source():
        return {"gauges": {
            'tony_device_hbm_bytes{device="0",kind="bytes_in_use"}': 7.0}}

    docs = {}
    for name, mod in PACKAGES.items():
        out = tmp_path / name
        # Neither traces (no CUDA here, no jax backend), so the clamped
        # window is recorded but not slept.
        summary = mod.run_capture("req/1", 10**7, out, "worker:0",
                                  session_id="2",
                                  metrics_source=metrics_source)
        assert summary["duration_ms"] == 60_000
        (artifact,) = mod.find_profiles(out)
        assert artifact.name == summary["artifact"] == \
            "profile-worker_0-s2-req_1.json"
        docs[name] = json.loads(artifact.read_text())
    port, jx = docs["port"], docs["jax"]
    assert sorted(port) == sorted(jx)
    assert sorted(port["snapshot"]) == sorted(jx["snapshot"])
    assert port["snapshot"]["source"] == jx["snapshot"]["source"] == "host"
    assert port["snapshot"]["user_device_hbm_bytes"] == \
        jx["snapshot"]["user_device_hbm_bytes"]
    assert port["trace_dir"] is None and jx["trace_dir"] is None
    assert port["snapshot"]["host"]["max_rss_bytes"] > 0


class _FakeDevice:
    def __init__(self, i: int, stats) -> None:
        self.id = i
        self.platform = "gpu"
        self._stats = stats

    def memory_stats(self):
        return self._stats


_FAKE_STATS = [
    {"bytes_in_use": 1 << 20, "peak_bytes_in_use": 3 << 20,
     "bytes_limit": 80 << 30, "num_allocs": 12},
    {"bytes_in_use": 5, "bytes_limit": 9},
]


def _fake_devices():
    return [_FakeDevice(i, s) for i, s in enumerate(_FAKE_STATS)]


def test_hbm_monitor_writes_jax_gauge_keys(monkeypatch):
    monkeypatch.setattr(jax, "local_devices", _fake_devices)
    monkeypatch.setattr(jax_prof, "_hbm_monitor_started", False)
    monkeypatch.setattr(port_prof, "_local_devices", _fake_devices)
    monkeypatch.setattr(port_prof, "_hbm_monitor_started", False)
    regs = {"jax": jax_metrics.MetricsRegistry(),
            "port": port_metrics.MetricsRegistry()}
    for name, mod in PACKAGES.items():
        thread = mod.start_device_memory_monitor(registry=regs[name],
                                                 interval_s=60.0)
        assert thread is not None and thread.daemon
        # Idempotent per process.
        assert mod.start_device_memory_monitor(registry=regs[name]) is None
    gauges = {n: r.snapshot()["gauges"] for n, r in regs.items()}
    assert gauges["port"] == gauges["jax"] == {
        'tony_device_hbm_bytes{device="0",kind="bytes_in_use"}': 1 << 20,
        'tony_device_hbm_bytes{device="0",kind="peak_bytes_in_use"}':
            3 << 20,
        'tony_device_hbm_bytes{device="0",kind="bytes_limit"}': 80 << 30,
        'tony_device_hbm_bytes{device="1",kind="bytes_in_use"}': 5,
        'tony_device_hbm_bytes{device="1",kind="bytes_limit"}': 9,
    }
    # The capture snapshot reads the same devices.
    monkeypatch.setattr(jax_prof, "_loaded_jax", lambda: jax)
    port_snap, jax_snap = port_prof.capture_snapshot(), \
        jax_prof.capture_snapshot()
    assert port_snap["source"] == "cuda" and jax_snap["source"] == "jax"
    assert port_snap["devices"] == jax_snap["devices"] == [
        {"id": 0, "platform": "gpu", "bytes_in_use": 1 << 20,
         "peak_bytes_in_use": 3 << 20, "bytes_limit": 80 << 30},
        {"id": 1, "platform": "gpu", "bytes_in_use": 5, "bytes_limit": 9}]


def _hbm_threads() -> int:
    return sum(t.name == "hbm-monitor" for t in threading.enumerate())


def test_without_cuda_no_monitor_starts(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    monkeypatch.setattr(port_prof, "_hbm_monitor_started", False)
    before = _hbm_threads()
    assert port_prof._local_devices() == []
    assert port_prof.start_device_memory_monitor() is None
    monkeypatch.setenv(constants.TONY_PROFILE_HBM_INTERVAL_MS, "500")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    ctx = runtime.initialize(device="cpu")
    assert ctx.device == "cpu"
    monkeypatch.setenv(constants.TONY_PROFILE_HBM_INTERVAL_MS, "bogus")
    runtime.initialize(device="cpu")
    assert _hbm_threads() == before
    assert not port_prof._hbm_monitor_started
    snap = port_prof.capture_snapshot()
    assert snap["source"] == "host" and snap["devices"] == []


def test_cuda_device_reads_the_allocator(monkeypatch):
    """The seam's CUDA device maps torch.cuda's allocator counters onto
    JAX's keys (allocated bytes, not reserved; total_memory the limit)."""
    calls = []

    class Props:
        total_memory = 80 << 30

    class Cuda:
        @staticmethod
        def memory_stats(i):
            calls.append(i)
            return {"allocated_bytes.all.current": 10,
                    "allocated_bytes.all.peak": 25,
                    "reserved_bytes.all.current": 4096}

        @staticmethod
        def get_device_properties(i):
            return Props

    class FakeTorch:
        cuda = Cuda

    dev = port_prof._CudaDevice(FakeTorch, 1)
    assert dev.memory_stats() == {"bytes_in_use": 10,
                                  "peak_bytes_in_use": 25,
                                  "bytes_limit": 80 << 30}
    assert calls == [1] and dev.platform == "gpu"
