"""The port's trace spans (tony_tpu_torch.observability.trace) held against
the JAX package's on the CPU.

Trace files cross over both ways: the port's ``Tracer`` file is read by
JAX's ``read_trace_jsonl`` and merged by JAX's ``merge_job_trace`` into the
same document a JAX tracer's file gives, and the reverse. With the same env,
``default_tracer()`` flushes its spans at exit to the same file name in
both packages (one subprocess each), so the coordinator's job-trace merge
picks a port process's spans up."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tony_tpu.observability import events as jax_events
from tony_tpu.observability import trace as jax_trace
from tony_tpu_torch import observability
from tony_tpu_torch.observability import trace as port_trace

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": jax_trace, "port": port_trace}


def _record(mod, trace_id: str, proc: str):
    tracer = mod.Tracer(trace_id=trace_id, proc=proc)
    with tracer.span("staging", files=3):
        pass
    s = tracer.begin("first_step", step=0)
    s.set(loss=1.5)
    s.end()
    s.end()  # idempotent
    return tracer


def _strip_times(events, *more: str):
    drop = ("ts", "dur", "tid") + more
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_trace_files_cross_over(tmp_path, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    written = _record(w, "abc123", f"user:{writer}:0")
    path = tmp_path / f"trace-user-{writer}-0-s0.jsonl"
    written.write_jsonl(path)
    events = written.to_chrome_events()
    assert [e["name"] for e in events] == ["process_name", "staging",
                                           "first_step"]
    assert events[2]["args"] == {"trace_id": "abc123",
                                 "proc": f"user:{writer}:0",
                                 "step": 0, "loss": 1.5}
    # The other package reads the file back event for event ...
    assert r.read_trace_jsonl(path) == events
    # ... and merges it beside its own spans as it merges its own
    # package's file.
    own = _record(r, "abc123", f"coordinator:{reader}")
    merged = r.merge_job_trace(own, tmp_path)
    assert merged["otherData"] == {"trace_id": "abc123"}
    assert merged["displayTimeUnit"] == "ms"
    assert merged["traceEvents"] == own.to_chrome_events() + events
    same = w.merge_job_trace(_record(w, "abc123", f"coordinator:{reader}"),
                             tmp_path)
    assert _strip_times(same["traceEvents"]) == _strip_times(
        merged["traceEvents"])


def test_parse_jsonl_skips_torn_lines_as_jax_does():
    text = ('{"a": 1}\n\n[1, 2]\n{"b": \n  {"c": 3}  \n'
            'not json\n{"d": [4]}')
    assert port_trace.parse_jsonl(text) == jax_events.parse_jsonl(text) \
        == [{"a": 1}, {"c": 3}, {"d": [4]}]


def test_read_of_a_missing_file_is_empty(tmp_path):
    assert port_trace.read_trace_jsonl(tmp_path / "nope.jsonl") == []
    merged = port_trace.merge_job_trace(port_trace.Tracer(proc="c"),
                                        tmp_path / "absent")
    assert merged["traceEvents"] == []


def test_trace_id_helpers_match_jax(monkeypatch):
    monkeypatch.setenv("TONY_TRACE_ID", "feedbeef")
    assert port_trace.TRACE_ID_ENV == jax_trace.TRACE_ID_ENV
    assert port_trace.ambient_trace_id() == jax_trace.ambient_trace_id() \
        == "feedbeef"
    assert port_trace.Tracer().trace_id == "feedbeef"
    monkeypatch.delenv("TONY_TRACE_ID")
    assert port_trace.ambient_trace_id() is None
    minted = port_trace.new_trace_id()
    assert len(minted) == len(jax_trace.new_trace_id()) == 16
    int(minted, 16)
    port_trace.note_rpc_trace("rpc-1")
    assert port_trace.current_rpc_trace() == "rpc-1"


_SPAN_SCRIPT = """
import sys
mod = __import__(sys.argv[1], fromlist=["span"])
with mod.span("load_data", shard=1):
    pass
print(mod.default_tracer().proc)
"""


@pytest.mark.parametrize("env,name", [
    ({"JOB_NAME": "worker", "TASK_INDEX": "1", "SESSION_ID": "2"},
     "trace-user-worker-1-s2.jsonl"),
    ({"JOB_NAME": "ps", "TASK_INDEX": "0"}, "trace-user-ps-0-s0.jsonl"),
])
def test_default_tracer_flushes_to_the_jax_file_name(tmp_path, env, name):
    docs = {}
    for pkg, module in (("jax", "tony_tpu.observability"),
                        ("port", "tony_tpu_torch.observability")):
        log_dir = tmp_path / pkg
        log_dir.mkdir()
        run_env = {k: v for k, v in os.environ.items()
                   if k not in ("JOB_NAME", "TASK_INDEX", "SESSION_ID")}
        run_env.update(env, TONY_LOG_DIR=str(log_dir),
                       TONY_TRACE_ID="job-trace-1", JAX_PLATFORMS="cpu",
                       PYTHONPATH=str(REPO))
        out = subprocess.run([sys.executable, "-c", _SPAN_SCRIPT, module],
                             env=run_env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == f"user:{env['JOB_NAME']}:" \
                                     f"{env['TASK_INDEX']}"
        assert [p.name for p in log_dir.iterdir()] == [name]
        docs[pkg] = jax_trace.read_trace_jsonl(log_dir / name)
    # The same events but for the process id.
    assert _strip_times(docs["port"], "pid") == _strip_times(docs["jax"],
                                                             "pid")
    assert docs["port"][1]["args"] == {"trace_id": "job-trace-1",
                                       "proc": "user:" + env["JOB_NAME"]
                                       + ":" + env["TASK_INDEX"],
                                       "shard": 1}
    # The coordinator's merge (JAX's) picks the port's file up.
    merged = jax_trace.merge_job_trace(jax_trace.Tracer(proc="coordinator"),
                                       tmp_path / "port")
    assert [e["name"] for e in merged["traceEvents"]] == [
        "process_name", "load_data"]


def test_observability_exports_the_trace_names():
    assert observability.span is port_trace.span
    assert observability.Tracer is port_trace.Tracer
    assert observability.default_tracer is port_trace.default_tracer
    assert json.dumps(port_trace.merge_job_trace(
        port_trace.Tracer(proc="x"), None))
