"""Profiler integration for training and serving code: the port's
counterpart of the JAX package's ``profiling.py``, on ``torch.profiler``.

``trace()`` and ``StepProfiler`` record a window with CPU and CUDA
activities and write a Chrome trace into ``log_dir`` (default
``$TONY_LOG_DIR/profile``, next to the task logs), named
``<host>_<pid>.<ns>.pt.trace.json``: loadable in Perfetto or
``chrome://tracing``, and in TensorBoard's PyTorch profiler plugin.
``annotate(name)`` is ``torch.profiler.record_function``: a named range in
the trace. All of them go through ``observability.profiling.start_trace``,
so at most one profiler runs in the process, a capture included.

``annotate_region(name)`` follows a forward range into its backward pass,
and ``annotate_backward(loss, name)`` names a whole backward pass. PyTorch
runs a CUDA backward pass on the autograd engine's own thread, where no
range the forward opened is open: there the region's kernels run under
``bwd:<name>``, opened on that thread by marker nodes the forward inserts
(only while a profiler records: ``recording()``), and the pass under
``name``, opened by a pre-hook on the loss's node (no node).

``maybe_start_profiler_server`` deviates from the JAX package on purpose:
PyTorch has no counterpart of ``jax.profiler.start_server`` (a gRPC server
that an XProf client drives). On the port the executor's reserved
``PROFILER_PORT`` serves a stdlib HTTP endpoint instead: ``GET /profile``
(``?duration_ms=N``, clamped as a capture's duration is) runs
``observability.profiling.run_capture`` for that window in this process and
answers with its summary as JSON.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from tony_tpu_torch import constants
from tony_tpu_torch.observability import profiling as obs_profiling

log = logging.getLogger(__name__)

_server: ThreadingHTTPServer | None = None
_server_lock = threading.Lock()


def _capture_task() -> str:
    job = os.environ.get(constants.JOB_NAME, "")
    idx = os.environ.get(constants.TASK_INDEX, "")
    return f"{job}:{idx}" if job else f"pid-{os.getpid()}"


class _CaptureHandler(BaseHTTPRequestHandler):
    """``GET /profile[?duration_ms=N]``: one capture of this process,
    answered with its summary."""

    def do_GET(self) -> None:  # noqa: N802 — http.server's hook name
        url = urlsplit(self.path)
        if url.path != "/profile":
            self._reply(404, {"error": f"no route {url.path}"})
            return
        query = parse_qs(url.query)
        duration = obs_profiling.clamp_duration_ms(
            (query.get("duration_ms") or [None])[0])
        self.server.requests += 1
        summary = obs_profiling.run_capture(
            f"http-{self.server.requests}", duration, default_trace_dir(),
            _capture_task(),
            session_id=os.environ.get(constants.SESSION_ID, "0"))
        self._reply(200, summary)

    def _reply(self, code: int, obj: dict) -> None:
        body = json.dumps(obj, sort_keys=True).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args) -> None:
        log.debug("profiler server: " + fmt, *args)


def maybe_start_profiler_server() -> int | None:
    """Serve the capture endpoint on the port the executor reserved
    (no-op without PROFILER_PORT, so scripts can call this
    unconditionally). Returns the port, or None. See the module note for
    how this differs from the JAX package's profiler server."""
    global _server
    port = os.environ.get(constants.PROFILER_PORT)
    if not port:
        return None
    with _server_lock:
        if _server is None:
            _server = ThreadingHTTPServer(("", int(port)), _CaptureHandler)
            _server.requests = 0
            threading.Thread(target=_server.serve_forever,
                             name="profiler-server", daemon=True).start()
            log.info("profiler capture endpoint on port %s", port)
    return int(port)


def stop_profiler_server() -> None:
    """Shut the capture endpoint down (tests; a process exit ends it
    anyway)."""
    global _server
    with _server_lock:
        if _server is not None:
            _server.shutdown()
            _server.server_close()
            _server = None


def default_trace_dir() -> str:
    """Traces default to the job's writable scratch (the executor exports
    TONY_LOG_DIR), so captured profiles land next to the task logs that
    task URLs already point at."""
    root = os.environ.get(constants.TONY_LOG_DIR, ".")
    return os.path.join(root, "profile")


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a Chrome trace of the enclosed code into ``log_dir``
    (default: ``$TONY_LOG_DIR/profile``)."""
    prof = obs_profiling.start_trace("profiling.trace")
    try:
        yield
    finally:
        obs_profiling.stop_trace(prof, log_dir or default_trace_dir())


class StepProfiler:
    """Capture a window of training steps: the usual pattern of profiling
    steps [start, start+num) once the kernels are built and the input
    pipeline is warm::

        prof = profiling.StepProfiler(start=10, num=5)
        for step in range(steps):
            prof.before_step(step)
            state, metrics = train_step(state, batch)
            prof.after_step(step)

    No-ops outside the window, so it can stay in production loops. Call it
    between steps, never from inside a step (the profiler's stop
    synchronizes the card)."""

    def __init__(self, start: int = 10, num: int = 5,
                 log_dir: str | None = None) -> None:
        self.start = start
        self.stop = start + num
        self.log_dir = log_dir or default_trace_dir()
        self.trace_path: str | None = None
        self._prof = None

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def before_step(self, step: int) -> None:
        # >= start (not ==): a loop resumed mid-window must still profile
        # its remaining in-window steps.
        if self.start <= step < self.stop and not self._active:
            self._prof = obs_profiling.start_trace(
                f"StepProfiler {self.start}..{self.stop - 1}")
            log.info("profiling steps %d..%d into %s",
                     self.start, self.stop - 1, self.log_dir)

    def after_step(self, step: int) -> None:
        if self._active and step >= self.stop - 1:
            self.close()

    def close(self) -> None:
        """Stop an in-flight trace (e.g. the loop ended inside the
        window)."""
        if self._active:
            self.trace_path = str(obs_profiling.stop_trace(self._prof,
                                                           self.log_dir))
            self._prof = None


def annotate(name: str):
    """Named range in the trace (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)


def recording() -> bool:
    """Whether a profiler records in this process (the flag
    ``torch.profiler`` sets while it runs)."""
    import torch

    return torch.autograd.profiler._is_profiler_enabled


def annotate_region(name: str) -> "_Region":
    """``annotate(name)`` for a region whose backward pass runs under
    ``bwd:<name>`` on the thread that runs it::

        with profiling.annotate_region("moe.experts") as r:
            x = r.enter(x)          # the region's input activations
            out = work(x)
            out = r.leave(out)      # its outputs

    While a profiler records, ``leave`` passes the outputs through one
    identity node whose backward opens ``bwd:<name>``, and ``enter`` the
    inputs through one whose backward closes it. The engine runs the nodes
    created later in the forward first, so every node of the region runs
    between the two, provided all of its differentiable outputs go through
    ``leave``. A weight read inside the region needs no marker: the nodes
    that make its gradient are the region's. Otherwise (no profiler, grad
    off, no input that requires grad) both return their arguments as they
    are and the graph is the one without the markers. ``bwd:`` is a
    prefix, so a reader of the forward's ``<name>`` ranges by prefix does
    not also read the backward's."""
    return _Region(name)


class _Region:
    def __init__(self, name: str) -> None:
        import torch

        self._range = torch.profiler.record_function(name)
        self._bwd = "bwd:" + name
        # [backward range name, its open handle]: shared by the two markers.
        self._slot: list | None = None

    def __enter__(self) -> "_Region":
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)

    def enter(self, *tensors):
        import torch

        self._slot = None
        if recording() and torch.is_grad_enabled():
            marked = [i for i, t in enumerate(tensors) if t.requires_grad]
            if marked:
                self._slot = [self._bwd, None]
                tensors = _through(_markers()[1], self._slot, tensors, marked)
        return tensors[0] if len(tensors) == 1 else tensors

    def leave(self, *tensors):
        if self._slot is not None:
            marked = [i for i, t in enumerate(tensors) if t.requires_grad]
            if marked:
                tensors = _through(_markers()[0], self._slot, tensors, marked)
        return tensors[0] if len(tensors) == 1 else tensors


def _through(marker, slot: list, tensors: tuple, marked: list) -> tuple:
    out = list(tensors)
    for i, t in zip(marked, marker.apply(slot, *(tensors[i] for i in marked))):
        out[i] = t
    return tuple(out)


@functools.cache
def _markers():
    """(RegionOut, RegionIn): the identity nodes ``annotate_region`` puts
    at a region's outputs and inputs (built at first use: this module
    imports without torch)."""
    import torch

    class Marker(torch.autograd.Function):
        @staticmethod
        def forward(ctx, slot, *xs):
            ctx.slot = slot
            ctx.set_materialize_grads(False)
            return tuple(x.view_as(x) for x in xs)

    class RegionOut(Marker):
        @staticmethod
        def backward(ctx, *grads):
            ctx.slot[1] = torch.ops.profiler._record_function_enter_new(
                ctx.slot[0], None)
            return (None, *grads)

    class RegionIn(Marker):
        @staticmethod
        def backward(ctx, *grads):
            handle, ctx.slot[1] = ctx.slot[1], None
            if handle is not None:
                torch.ops.profiler._record_function_exit._RecordFunction(
                    handle)
            return (None, *grads)

    return RegionOut, RegionIn


def annotate_backward(loss, name: str) -> None:
    """Run ``loss``'s backward pass under ``name`` on the thread that runs
    it: a pre-hook on ``loss.grad_fn`` opens the range as the pass starts
    and queues the engine's final callback, which closes it once every
    node has run. Adds no node to the graph."""
    import torch
    from torch.autograd import Variable

    def close(handle) -> None:
        torch.ops.profiler._record_function_exit._RecordFunction(handle)

    def open_range(grad_outputs) -> None:
        handle = torch.ops.profiler._record_function_enter_new(name, None)
        Variable._execution_engine.queue_callback(lambda: close(handle))

    loss.grad_fn.register_prehook(open_range)
