"""The traced window: ``torch.profiler`` over a few train steps, read back
from its Chrome trace into device events, each tied to the host ranges
its launch ran under.

A device event (kernel, memcpy, memset) is tied to its launch (the
runtime call of the same ``correlation``), and the launch to every
``record_function`` range open on its thread at that moment: the port's
``train.forward``, ``train.backward`` and ``train.optimizer``, the
backward's ``bwd:*`` (opened on the autograd engine's thread), ``moe.*``,
``weight_cast`` and ``remat.recompute``; the benchmark's ``perfbench.*``
ones. Busy time is the union of the device events inside the benchmark's
``perfbench.window`` range; an idle gap is named by the innermost host
event open at its middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
TOP = 10
# A kernel's demangled signature, shortened for the breakdown: the
# namespaces dropped, then cut.
NOISE = ("void ", "at::native::", "(anonymous namespace)::", "at::", "std::")
NAME_CHARS = 160


@dataclass
class DeviceEvent:
    name: str
    start_us: float
    dur_us: float
    ranges: tuple = ()


@dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    events: list = field(default_factory=list)
    gaps: list = field(default_factory=list)  # [(host name, seconds)]

    def device_s(self, pred) -> float:
        """Seconds of the device events whose (name, ranges) ``pred``
        accepts."""
        return sum(e.dur_us for e in self.events
                   if pred(e.name, e.ranges)) / 1e6

    def top_ops(self, n: int = TOP) -> list:
        by = {}
        for e in self.events:
            name = short(e.name)
            by[name] = by.get(name, 0.0) + e.dur_us / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def short(name: str) -> str:
    for noise in NOISE:
        name = name.replace(noise, "")
    return name[:NAME_CHARS]


def record(fn, steps: int, torch) -> Trace:
    """Run ``fn()`` (which runs ``steps`` steps and synchronizes) under the
    profiler inside a ``perfbench.window`` range; the Chrome trace goes
    through a temporary file under TMPDIR and is read back."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    return parse(data, steps)


def _spans(events, cat_ok):
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in cat_ok]


def parse(data: dict, steps: int) -> Trace:
    events = data["traceEvents"] if isinstance(data, dict) else data
    host = _spans(events, HOST_CATS)
    window = [e for e in host if e.get("name") == WINDOW]
    if not window:
        raise ValueError(f"the trace holds no {WINDOW!r} range")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    launches = {}
    for e in _spans(events, LAUNCH_CATS):
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launches[corr] = e
    ranges = {}
    for e in _spans(events, ("user_annotation",)):
        ranges.setdefault(e.get("tid"), []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    device = []
    for e in _spans(events, DEVICE_CATS):
        start, dur = float(e["ts"]), float(e["dur"])
        if start + dur <= w0 or start >= w1:
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        names = ()
        if launch is not None:
            t = float(launch["ts"])
            names = tuple(n for a, b, n in ranges.get(launch.get("tid"), ())
                          if a <= t < b)
        device.append(DeviceEvent(e["name"], start, dur, names))
    busy, gaps = _busy_and_gaps(device, w0, w1, host)
    return Trace(steps, (w1 - w0) / 1e6, busy / 1e6, device, gaps)


def _busy_and_gaps(device, w0, w1, host):
    spans = sorted((max(e.start_us, w0), min(e.start_us + e.dur_us, w1))
                   for e in device)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    holes, last = [], w0
    for a, b in merged:
        if a > last:
            holes.append((last, a))
        last = max(last, b)
    if w1 > last:
        holes.append((last, w1))
    holes.sort(key=lambda h: h[0] - h[1])
    starts = sorted(host, key=lambda e: float(e["ts"]))
    keys = [float(e["ts"]) for e in starts]
    gaps = []
    for a, b in holes[:TOP]:
        mid = (a + b) / 2
        name = "no host event"
        best = None
        for e in starts[:bisect.bisect_right(keys, mid)]:
            end = float(e["ts"]) + float(e["dur"])
            if end > mid and e.get("name") != WINDOW and (
                    best is None or float(e["dur"]) < float(best["dur"])):
                best = e
        if best is not None:
            name = best["name"]
        gaps.append([name, (b - a) / 1e6])
    return busy, gaps
