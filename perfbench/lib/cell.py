"""One run of a training cell: set-up, the measured window, the optional
traced steps, then the comparison with the reference.

Set-up builds one train step (``make_train_step``) with its state from
the seed's weights, and drives it through the cell's ``check_steps``
(``limits/<workload>.json``) first steps through the window's own call
and feed; those steps also warm up every shape the window uses. Their readings (each step's loss, the
first clipped gradient's norm a leaf, read from AdamW's first moment, and
each leaf's change, read before the next step overwrites it) are what the
reference is held to once the window has closed and the program's state
is freed. The window then runs the same step on, for ``seconds``.
"""

from __future__ import annotations

import collections
import gc
import subprocess
import sys
import time
from dataclasses import dataclass

from perfbench.lib import (compare, counts, family, feed, trace as trace_lib,
                           weights)
from perfbench.lib.shape import Shape
from perfbench.lib.spec import Cell, metric_reader

GIB = float(1 << 30)
# Steps in flight ahead of the host: the device stays fed and the host
# knows where the window stands.
IN_FLIGHT = 2


@dataclass
class Readings:
    """What the per-layer metric readers read (``metrics/<name>.py``)."""

    shape: Shape
    family: family.Family      # the configuration's: its counts
    traffic: dict
    chips: int
    chip: dict | None          # counts.PEAKS entry of the card, or None
    window_steps: int
    window_s: float
    tokens_per_step: int       # all data ranks
    phases: list               # StepStats phases (ms) of the window steps
    trace: trace_lib.Trace | None


def first_grad_norms(state, beta1: float, torch) -> dict:
    """Per leaf, the norm of the clipped gradient AdamW took in its first
    step: its first moment is then (1 - beta1) g. A leaf the optimizer
    holds no moment for reads 0."""
    out = {}
    for path, p in weights.leaf_items(state.params):
        st = state.opt_state.state.get(p, {})
        m = st.get("exp_avg")
        out[path] = (torch.zeros((), device=p.device) if m is None
                     else m.float().norm() / (1 - beta1))
    return out


def _floats(tree: dict) -> dict:
    return {k: float(v) for k, v in tree.items()}


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


@dataclass
class Program:
    """The train step built for a run, with its state and feed, after the
    set-up steps, and what those steps read."""

    state: object
    step_fn: object
    batches: object
    prefetcher: object
    readings: dict
    readout_s: float

    def close(self, torch) -> None:
        """Drop the program's state and free its device memory."""
        self.prefetcher.close()
        self.state = self.step_fn = None
        self.batches = self.prefetcher = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def set_up(s: Shape, tr: dict, steps: int, seed: int, dev,
           torch) -> Program:
    """Build the train step, its state from the seed's weights and its
    feed, and drive its ``steps`` first steps, reading them
    (``readout_s``: the seconds the readings took, not set-up)."""
    from tony_tpu_torch.io.reader import device_prefetch
    from tony_tpu_torch.models import make_train_step

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    init_fn, step_fn = make_train_step(
        family.of(s).port_config(s), None, device=dev, learning_rate=s.lr,
        weight_decay=s.weight_decay, grad_clip=s.grad_clip)
    params = weights.draw(s, seed, dev)
    state = init_fn(params=params)
    del params
    prefetcher = device_prefetch(feed.batches(tr, s.vocab, seed), dev,
                                 int(tr["prefetch_depth"]))
    batches = step_fn.stepstats.wrap_batches(iter(prefetcher))
    losses, grad = [], None
    readout_s = 0.0
    for i in range(steps):
        state, metrics = step_fn(state, next(batches))
        losses.append(metrics["loss"])
        if i == 0:
            sync()
            t = time.perf_counter()
            grad = first_grad_norms(state, s.beta1, torch)
            sync()
            readout_s += time.perf_counter() - t
    sync()
    t = time.perf_counter()
    change = weights.change_norms(s, seed, state.params)
    readings = {"loss": [float(x) for x in losses],
                "grad": _floats(grad), "change": _floats(change)}
    del grad, change
    sync()
    readout_s += time.perf_counter() - t
    return Program(state, step_fn, batches, prefetcher, readings, readout_s)


def reference_readings(s: Shape, tr: dict, steps: int, seed: int, dev,
                       precision: str = "fp32") -> dict:
    """The reference's readings of the first ``steps`` steps (at
    ``precision``) on the batches the program was fed: the family's
    reference."""
    fed = [feed.batch(tr, s.vocab, seed, i) for i in range(steps)]
    return family.of(s).reference.train(s, seed, fed, dev,
                                        precision=precision)


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        started: float, device: str = "cuda") -> tuple[dict, dict]:
    """Run the cell once. Returns (the result line's object without the
    checks, the checks)."""
    import torch

    from tony_tpu_torch import runtime

    s = cell.family.shape(cell.config)
    tr = cell.traffic
    feed.check(tr)
    ctx = runtime.initialize(device=device)
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    if runtime.build_job_mesh(device=dev) is not None:
        raise ValueError("a cell of more than one card is not run yet")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    steps = int(cell.limits["check_steps"])
    prog = set_up(s, tr, steps, seed, dev, torch)
    step_fn, batches = prog.step_fn, prog.batches
    stats = step_fn.stepstats
    state = prog.state

    # The window.
    reg_gauges = _phase_gauges()
    phases = []
    losses = []
    pending = collections.deque()
    observed = stats.steps_observed
    t0 = time.perf_counter()
    while True:
        if len(pending) >= IN_FLIGHT:
            pending.popleft().synchronize()
        state, metrics = step_fn(state, next(batches))
        losses.append(metrics["loss"])
        # The k-th dispatch observes the step before it: from the second
        # on, a window step.
        if stats.steps_observed > observed:
            observed = stats.steps_observed
            if len(losses) >= 2:
                phases.append({k: g.value for k, g in reg_gauges.items()})
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    t1 = time.perf_counter()
    window_steps = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    setup_s = (t0 - started) - prog.readout_s

    traced = None
    if trace:
        n = int(tr["trace_steps"])

        def traced_steps():
            nonlocal state
            from torch.profiler import record_function

            for _ in range(n):
                with record_function("perfbench.step"):
                    state, _ = step_fn(state, next(batches))
            sync()

        traced = trace_lib.record(traced_steps, n, torch)
        if cuda:
            peak = max(peak, torch.cuda.max_memory_allocated(dev))

    tokens_per_step = int(tr["batch"]) * int(tr["seq"])
    window_s = t1 - t0
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if cuda:
        device_info["power_limit_w"] = power_limit_w()
    result = {"correct": False, "attempted": window_steps, "failed": failed}
    if not trace:
        values = {
            "train_tokens_per_s": window_steps * tokens_per_step / window_s,
            "peak_mem_gib": peak / GIB,
            "setup_s": setup_s,
        }
        metrics_out = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
    else:
        r = Readings(s, cell.family, tr, cell.chips, counts.peaks(name),
                     window_steps, window_s, tokens_per_step, phases, traced)
        metrics_out = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(r)
            if value is not None:
                metrics_out[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.top_ops(),
                               "idle_gaps": traced.gaps}
    result["metrics"] = metrics_out
    result["device"] = device_info

    # Free the program's state, then the reference.
    del state, metrics, step_fn, batches, losses
    prog.close(torch)
    ref = reference_readings(s, tr, steps, seed, dev)
    correct, checks = compare.judge(compare.gaps(prog.readings, ref),
                                    cell.limits)
    result["correct"] = correct and failed == 0
    return result, checks


def _phase_gauges() -> dict:
    """The step anatomy's phase gauges (ms of the last observed step) in
    the process registry, where ``make_train_step``'s recorder writes."""
    from tony_tpu_torch.observability import default_registry
    from tony_tpu_torch.observability.stepstats import (PHASES,
                                                        STEP_PHASE_GAUGE)

    reg = default_registry()
    return {p: reg.gauge(STEP_PHASE_GAUGE, labels={"phase": p})
            for p in PHASES}


def loaded_jax() -> list[str]:
    """Top-level names of loaded modules that the benchmark must never
    load: JAX, its libraries and the JAX package (whole names)."""
    banned = {"jax", "jaxlib", "flax", "tony_tpu"}
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & banned)
