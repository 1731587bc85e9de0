"""The per-layer readers of the train step's ranges, on a synthetic Chrome
trace: each kernel is tied to the ranges open on its launch's thread, the
forward's on the main thread and the backward's on the engine's."""

from types import SimpleNamespace

import pytest

from perfbench.lib import spec, trace

MAIN, ENGINE = 1, 2

# (thread, name, start us, end us)
RANGES = [
    (MAIN, "perfbench.window", 0, 1000),
    (MAIN, "train.forward", 10, 100),
    (MAIN, "moe.experts", 20, 40),
    (MAIN, "weight_cast", 22, 24),
    (MAIN, "train.backward", 105, 108),
    (ENGINE, "train.backward", 110, 690),
    (ENGINE, "bwd:moe.combine", 120, 300),
    (ENGINE, "remat.recompute", 130, 200),
    (ENGINE, "moe.experts", 140, 160),
    (ENGINE, "moe.experts", 210, 220),
    (ENGINE, "bwd:moe.experts", 305, 400),
    (ENGINE, "bwd:weight_cast", 310, 320),
    (MAIN, "train.optimizer", 700, 800),
]

# (thread, launch us, kernel us): what the kernel is
KERNELS = [
    (MAIN, 15, 10),     # the forward outside the layer
    (MAIN, 25, 20),     # the experts' forward
    (MAIN, 23, 30),     # a cast inside the experts' forward
    (ENGINE, 150, 40),  # the experts' recompute inside bwd:moe.combine
    (ENGINE, 135, 50),  # the attention's recompute there
    (ENGINE, 250, 60),  # the combine's backward
    (ENGINE, 315, 70),  # an expert weight's gradient cast back
    (MAIN, 750, 80),    # AdamW
    (ENGINE, 215, 90),  # moe.experts inside bwd:moe.combine, no remat range
    (MAIN, 106, 1),     # backward() on the main thread
]


def _chrome(ranges=RANGES, kernels=KERNELS) -> dict:
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "tid": tid,
               "ts": a, "dur": b - a} for tid, n, a, b in ranges]
    for i, (tid, t, dur) in enumerate(kernels):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "tid": tid, "ts": t,
                       "dur": 0.5, "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{i}",
                       "tid": 7, "ts": t + 1, "dur": dur,
                       "args": {"correlation": i}})
    return {"traceEvents": events}


def _read(name, data, experts=8, steps=1):
    r = SimpleNamespace(trace=trace.parse(data, steps),
                        shape=SimpleNamespace(experts=experts))
    return spec.metric_reader(name)(r)


@pytest.mark.parametrize("name,us", [
    ("forward_ms", 10 + 20 + 30),
    ("backward_ms", 40 + 50 + 60 + 70 + 90 + 1),
    ("optimizer_ms", 80),
    ("weight_cast_ms", 30 + 70),
    ("moe_bwd_ms", 60 + 70),
    ("moe_fwd_ms", 20 + 30 + 40 + 90),
])
def test_reader_counts_the_kernels_of_its_ranges(name, us):
    assert _read(name, _chrome()) == pytest.approx(us / 1000.0)
    assert _read(name, _chrome(), steps=2) == pytest.approx(us / 2000.0)


def test_a_recompute_inside_the_backward_counts_once():
    """A kernel under moe.experts and bwd:moe.combine (the recompute)
    counts in moe_fwd_ms and not in moe_bwd_ms; the attention's recompute
    there (remat.recompute, no moe.*) in neither. The two metrics sum to
    the layer, each kernel once."""
    t = trace.parse(_chrome(), 1)
    fwd = {e.name for e in t.events if any(x.startswith("moe.")
                                           for x in e.ranges)}
    bwd_reader = spec.metric_reader("moe_bwd_ms")
    assert {"k3", "k8"} <= fwd
    only = [_chrome(kernels=[KERNELS[i]]) for i in (3, 4, 8)]
    for data in only:
        assert _read("moe_bwd_ms", data) is None
    assert _read("moe_fwd_ms", only[0]) == pytest.approx(0.04)
    assert _read("moe_fwd_ms", only[1]) is None
    assert _read("moe_fwd_ms", only[2]) == pytest.approx(0.09)
    layer = bwd_reader(SimpleNamespace(trace=t,
                                       shape=SimpleNamespace(experts=8)))
    assert layer + _read("moe_fwd_ms", _chrome()) == pytest.approx(
        (20 + 30 + 40 + 90 + 60 + 70) / 1000.0)


@pytest.mark.parametrize("name", ["forward_ms", "backward_ms",
                                  "optimizer_ms", "weight_cast_ms",
                                  "moe_bwd_ms"])
def test_reader_reads_nothing_without_its_range(name):
    """A program without the ranges (the parent's) gives no reading, and
    does not raise; moe_bwd_ms reads nothing of a dense trunk."""
    bare = _chrome(ranges=[RANGES[0]])
    assert _read(name, bare) is None
    r = SimpleNamespace(trace=None, shape=SimpleNamespace(experts=8))
    assert spec.metric_reader(name)(r) is None
    if name == "moe_bwd_ms":
        assert _read(name, _chrome(), experts=0) is None
