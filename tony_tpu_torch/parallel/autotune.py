"""Measured program autotuner: the port of the JAX package's
``parallel/autotune.py``.

``plan_for`` picks the mesh; this module tunes the program on it, over the
knobs the planner takes as fixed:

* the flash-attention tile knob ``(block_q, block_k)``: which of the bf16
  instances of B1, B2 (query rows a block) and B3 (keys a block) run
  (``ops/attention.TILES``; one each is built today), decided by the wall time of forward and
  backward through the public ``flash_attention``
  (``flash_wall_measure``): per-kernel times miss what overlaps between
  the kernels;
* the remat policy ("full" or "dots"): what is recomputed, never what is
  computed;
* the pipeline's microbatch count;
* state donation (kept for the record format; the port's step updates in
  place whatever it says);
* the serving side's KV storage mode (``kv_quant``, int8 or not);
* ``xla_flags``, kept in the record and read back so the two packages
  share a format; the port has no XLA, so nothing applies them (the JAX
  package's ``apply_xla_flags`` has no counterpart here).

Results persist as one JSON record per tune key in ``tony-tune-records/``
beside the compile cache (``plan.configure_compile_cache``), in the JAX
package's format (version 1), with its degrade-to-miss rules: a missing,
torn, corrupt or stale-keyed record reads as "never searched". The tune
key rides ``plan_cache_key``, so a torch or CUDA version, a device, a
topology or an edited kernel source invalidates a record. A retry or a
resume finds the record and reuses its winner with no trial; the step
anatomy's calibration (``observability/stepstats.py``) folds live best
step walls into it (``note_step_time``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

from tony_tpu_torch import constants
from tony_tpu_torch.parallel import plan as plan_lib

# Metric names, registered lazily like plan.py's compile-cache counters.
TUNE_SEARCH_TRIALS_COUNTER = "tony_tune_search_trials_total"
TUNE_RECORD_HITS_COUNTER = "tony_tune_record_hits_total"
TUNE_RECORD_MISSES_COUNTER = "tony_tune_record_misses_total"
TUNE_SEARCH_MS_HISTOGRAM = "tony_tune_search_ms"

# Searches run seconds to minutes.
_SEARCH_BUCKETS = (
    100.0, 500.0, 1000.0, 5000.0, 15000.0, 60000.0, 300000.0, 1800000.0,
)

# Subdirectory holding one JSON record per tune key, beside the cache.
_TUNE_DIR = "tony-tune-records"
_RECORD_VERSION = 1

# KV-cache quantization modes the serving engine accepts
# (tony.tune.kv-quant / TONY_TUNE_KV_QUANT).
KV_QUANT_MODES = ("none", "int8")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, "") or default


def enabled() -> bool:
    """Consumption switch (``tony.tune.enabled``): when off, ``lookup``
    always misses. The search entry points stay callable."""
    return plan_lib._env_bool(constants.TONY_TUNE_ENABLED, True)


def default_trial_budget() -> int:
    return max(1, _env_int(constants.TONY_TUNE_TRIAL_BUDGET, 12))


def default_kv_quant() -> str:
    """The serving engine's KV storage mode when the caller passes none
    (``tony.tune.kv-quant``). Unknown values degrade to ``none``: a typo in
    the conf must not crash a serving fleet at engine construction."""
    mode = _env_str(constants.TONY_TUNE_KV_QUANT, "none").strip().lower()
    return mode if mode in KV_QUANT_MODES else "none"


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Knobs:
    """One point of the tuning space. ``None`` leaves the stack's default:
    a record whose winner is all-None is a measured confirmation that the
    defaults win. ``xla_flags`` is stored for the record format only."""

    block_q: int | None = None
    block_k: int | None = None
    remat_policy: str | None = None
    microbatches: int | None = None
    pipeline_schedule: str | None = None
    donate_state: bool | None = None
    kv_quant: str | None = None
    xla_flags: tuple = ()

    def describe(self) -> dict[str, Any]:
        """Only the knobs this point sets."""
        out = {
            k: v for k, v in dataclasses.asdict(self).items()
            if v is not None and v != ()
        }
        if "xla_flags" in out:
            out["xla_flags"] = list(out["xla_flags"])
        return out


def knobs_from_dict(raw: Mapping[str, Any] | None) -> Knobs:
    """A ``Knobs`` from a record's dict, ignoring unknown fields (an older
    reader of a newer record must not crash)."""
    if not isinstance(raw, Mapping):
        return Knobs()
    fields = {f.name for f in dataclasses.fields(Knobs)}
    kept = {k: v for k, v in raw.items() if k in fields}
    if isinstance(kept.get("xla_flags"), list):
        kept["xla_flags"] = tuple(kept["xla_flags"])
    try:
        return Knobs(**kept)
    except TypeError:
        return Knobs()


# ---------------------------------------------------------------------------
# Records (degrade-to-miss, like plan-measurements.json)
# ---------------------------------------------------------------------------


def tune_key(
    label: str,
    *,
    config: Any = None,
    mesh=None,
    extra: Mapping[str, Any] | None = None,
    backend: Mapping[str, Any] | None = None,
) -> str:
    """The identity a record is valid for: (label, model config, mesh
    topology, backend fingerprint, caller extras), through
    ``plan_cache_key``."""
    return plan_lib.plan_cache_key(
        label, config=config, mesh=mesh, extra=extra, backend=backend
    )


def record_dir(cache_dir: str | None = None) -> str | None:
    """Where records live: ``tony.tune.record-dir`` when set, else beside
    the active (or default) compile cache; a remote URI gets the local
    sidecar. None when the directory cannot be made (degrade to miss)."""
    base = cache_dir or _env_str(constants.TONY_TUNE_RECORD_DIR, "")
    if not base:
        base = plan_lib.active_cache_dir() or plan_lib.default_cache_dir()
    base = os.path.expanduser(base)
    if plan_lib._is_remote_uri(base):
        base = plan_lib._local_sidecar_dir(base)
    path = os.path.join(base, _TUNE_DIR)
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    return path


def _record_path(key: str, cache_dir: str | None = None) -> str | None:
    base = record_dir(cache_dir)
    if base is None or not key:
        return None
    return os.path.join(base, f"{key}.json")


def load_record(key: str, *,
                cache_dir: str | None = None) -> dict[str, Any] | None:
    """The record for ``key``, or None. Every failure (absent file, torn
    write, corrupt JSON, an embedded key that disagrees, another version)
    reads as a miss."""
    path = _record_path(key, cache_dir)
    if path is None:
        return None
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict):
        return None
    if data.get("key") != key or data.get("version") != _RECORD_VERSION:
        return None
    if not isinstance(data.get("best"), dict):
        return None
    return data


def save_record(record: Mapping[str, Any], *,
                cache_dir: str | None = None) -> None:
    """Atomic tmp + rename write; an unwritable dir leaves the result
    unpersisted (the next process searches again)."""
    path = _record_path(str(record.get("key", "")), cache_dir)
    if path is None:
        return
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(dict(record), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def list_records(cache_dir: str | None = None) -> list[dict[str, Any]]:
    """Every valid record in the dir (invalid files skipped)."""
    base = record_dir(cache_dir)
    if base is None:
        return []
    out: list[dict[str, Any]] = []
    try:
        names = sorted(os.listdir(base))
    except OSError:
        return []
    for name in names:
        if not name.endswith(".json") or ".tmp." in name:
            continue
        rec = load_record(name[:-len(".json")], cache_dir=cache_dir)
        if rec is not None:
            out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Search core
# ---------------------------------------------------------------------------


def _registry():
    from tony_tpu_torch import observability

    return observability.default_registry()


# Re-entrancy guard: a trial builds a real train step, and make_train_step
# consults lookup(): a trial must measure the candidate, not a record.
_IN_SEARCH = False


def search(
    label: str,
    candidates: Sequence[Knobs],
    measure: Callable[[Knobs], float],
    *,
    key: str,
    trial_budget: int | None = None,
    cache_dir: str | None = None,
    force: bool = False,
    margin: Callable[[Knobs], float] | None = None,
) -> dict[str, Any]:
    """The search loop every stage shares: a persisted record is a hit
    (returned with ``trials_this_run == 0``); else measure up to
    ``trial_budget`` candidates and persist the winner.

    ``candidates[0]`` is the default point (``Knobs()``), measured first so
    every record carries ``default_ms``. A trial that raises or returns a
    non-finite or non-positive wall is kept as a failed trial and takes no
    part in the ranking. With ``margin`` (a port extension; None: the JAX
    package's rule), a point other than the default wins only where its
    wall is below the default's by more than ``margin(point)`` ms, which
    keeps a noise win out of the record."""
    global _IN_SEARCH
    if trial_budget is None:
        trial_budget = default_trial_budget()
    trial_budget = max(1, int(trial_budget))
    reg = _registry()
    if not force:
        rec = load_record(key, cache_dir=cache_dir)
        if rec is not None:
            reg.counter(TUNE_RECORD_HITS_COUNTER).inc()
            rec = dict(rec)
            rec["trials_this_run"] = 0
            return rec
    reg.counter(TUNE_RECORD_MISSES_COUNTER).inc()

    trials: list[dict[str, Any]] = []
    best_ms = math.inf
    best = Knobs()
    default_ms: float | None = None
    t_search = time.perf_counter()
    was_in_search, _IN_SEARCH = _IN_SEARCH, True
    try:
        for knobs in list(candidates)[:trial_budget]:
            reg.counter(TUNE_SEARCH_TRIALS_COUNTER).inc()
            try:
                ms = float(measure(knobs))
            except Exception as exc:  # a failed point is data, not a crash
                trials.append({"knobs": knobs.describe(),
                               "error": f"{type(exc).__name__}: {exc}"[:200]})
                continue
            if not math.isfinite(ms) or ms <= 0:
                trials.append({"knobs": knobs.describe(), "error": "non-finite"})
                continue
            trials.append({"knobs": knobs.describe(), "ms": round(ms, 3)})
            if default_ms is None:
                default_ms = ms
            if margin is not None and default_ms is not None \
                    and knobs != Knobs() and ms >= default_ms - margin(knobs):
                continue
            if ms < best_ms:
                best_ms, best = ms, knobs
    finally:
        _IN_SEARCH = was_in_search
    search_ms = (time.perf_counter() - t_search) * 1000.0
    reg.histogram(
        TUNE_SEARCH_MS_HISTOGRAM, buckets=_SEARCH_BUCKETS
    ).observe(search_ms)

    record: dict[str, Any] = {
        "version": _RECORD_VERSION,
        "key": key,
        "label": label,
        "backend": plan_lib._canonical(plan_lib.backend_fingerprint()),
        "best": dataclasses.asdict(best) | {
            "xla_flags": list(best.xla_flags)
        },
        "best_ms": round(best_ms, 3) if math.isfinite(best_ms) else None,
        "default_ms": (
            round(default_ms, 3) if default_ms is not None else None
        ),
        "trials": trials,
        "search_ms": round(search_ms, 1),
        "ts_ms": int(time.time() * 1000),
    }
    if math.isfinite(best_ms):
        save_record(record, cache_dir=cache_dir)
    record["trials_this_run"] = len(trials)
    return record


def lookup(
    label: str,
    *,
    config: Any = None,
    mesh=None,
    extra: Mapping[str, Any] | None = None,
    cache_dir: str | None = None,
) -> Knobs | None:
    """The winning knobs for this (label, config, topology, backend), or
    None on any miss, while a search is measuring, or when tuning is off.
    One small JSON read."""
    if _IN_SEARCH or not enabled():
        return None
    rec = load_record(
        tune_key(label, config=config, mesh=mesh, extra=extra),
        cache_dir=cache_dir,
    )
    reg = _registry()
    if rec is None:
        reg.counter(TUNE_RECORD_MISSES_COUNTER).inc()
        return None
    reg.counter(TUNE_RECORD_HITS_COUNTER).inc()
    return knobs_from_dict(rec.get("best"))


def note_step_time(
    label: str,
    *,
    config: Any = None,
    mesh=None,
    extra: Mapping[str, Any] | None = None,
    step_ms: float,
    cache_dir: str | None = None,
) -> None:
    """Fold a live best step wall into the record's ``live_best_ms`` (the
    step anatomy's calibration calls it). Telemetry: every failure is
    silent, and a record that does not exist stays absent."""
    if not math.isfinite(step_ms) or step_ms <= 0:
        return
    key = tune_key(label, config=config, mesh=mesh, extra=extra)
    rec = load_record(key, cache_dir=cache_dir)
    if rec is None:
        return
    prev = rec.get("live_best_ms")
    if isinstance(prev, (int, float)) and step_ms >= float(prev):
        return
    rec["live_best_ms"] = round(float(step_ms), 3)
    save_record(rec, cache_dir=cache_dir)


# ---------------------------------------------------------------------------
# Stage: the flash-attention tile knob
# ---------------------------------------------------------------------------


def flash_block_candidates(d: int = 64) -> list[Knobs]:
    """``Knobs()`` (each kernel's shipped instance) first, then every
    (block_q, block_k) pair of built instances at head_dim ``d`` (None
    where no value is built for both B1 and B2). Unlike the JAX package's
    block grid, no point is clamped to the sequence: every instance takes
    any length."""
    from tony_tpu_torch.ops import attention

    built_q, built_k = attention.built_blocks(d)
    points = [Knobs(block_q=bq, block_k=bk) for bq in built_q or (None,)
              for bk in built_k or (None,)]
    return [Knobs()] + [k for k in points if k != Knobs()]


def _fence(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def flash_wall_measure(
    seq: int, bh: int = 32, d: int = 64, *,
    heads: int = 8, kv_heads: int | None = None,
    iters: int = 10, windows: int = 3, device="cuda",
    warm: Sequence[Knobs] = (),
) -> Callable[[Knobs], float]:
    """The wall of forward and backward through the public
    ``flash_attention`` (causal, bf16, the gradient of a sum): q
    [bh / heads, seq, heads, d], k/v with ``kv_heads`` heads (default
    ``heads``), from numpy's seed 0; the median of ``windows`` windows of
    ``iters`` calls, each window fenced with ``torch.cuda.synchronize``.
    Returns ms per call. Before its first window the measure runs every
    point of ``warm`` (the tuner's candidates) and then its own once, so
    no point pays the first calls' costs in its windows; every later point
    is run once before its windows too. ``measure.spread[knobs]`` keeps the
    max minus the min of a point's windows, in ms per call."""
    import numpy as np
    import torch

    from tony_tpu_torch.device import resolve_device
    from tony_tpu_torch.ops import flash_attention

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    b = max(1, bh // heads)
    kv_heads = kv_heads or heads

    def make(h):
        return torch.from_numpy(
            rng.standard_normal((b, seq, h, d), dtype=np.float32)
        ).to(device=device, dtype=torch.bfloat16).requires_grad_()

    q, k, v = make(heads), make(kv_heads), make(kv_heads)

    def call(knobs: Knobs):
        out = flash_attention(q, k, v, block_q=knobs.block_q,
                              block_k=knobs.block_k)
        return torch.autograd.grad(out.float().sum(), (q, k, v))

    pending_warm = list(warm)

    def measure(knobs: Knobs) -> float:
        for point in pending_warm:
            call(point)
        pending_warm.clear()
        call(knobs)
        _fence(device)
        walls = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(iters):
                call(knobs)
            _fence(device)
            walls.append((time.perf_counter() - t0) / iters * 1e3)
        measure.spread[knobs] = max(walls) - min(walls)
        return statistics.median(walls)

    measure.spread = {}
    return measure


def tune_flash_blocks(
    seq: int, bh: int = 32, d: int = 64, *,
    heads: int = 8, kv_heads: int | None = None,
    iters: int = 10, windows: int = 3,
    trial_budget: int | None = None,
    cache_dir: str | None = None,
    force: bool = False,
    device="cuda",
) -> dict[str, Any]:
    """The tile stage: measure every point of ``flash_block_candidates(d)``
    at one attention shape and persist the winner under a shape-keyed
    record (``heads``/``kv_heads`` join the key where they differ from the
    JAX package's 8 heads of q, k and v). Every point is warmed before the
    first is timed, and a point other than ``Knobs()`` wins only where it
    beats ``Knobs()`` by more than the larger spread of the two points'
    windows."""
    candidates = flash_block_candidates(d)
    extra: dict[str, Any] = {"seq": seq, "bh": bh, "d": d}
    if heads != 8 or (kv_heads or heads) != heads:
        extra.update(heads=heads, kv_heads=kv_heads or heads)
    key = tune_key("flash_attention_wall", extra=extra)
    measure = flash_wall_measure(seq, bh, d, heads=heads, kv_heads=kv_heads,
                                 iters=iters, windows=windows, device=device,
                                 warm=candidates)
    return search(
        "flash_attention_wall", candidates, measure,
        key=key, trial_budget=trial_budget or len(candidates),
        cache_dir=cache_dir, force=force,
        margin=lambda knobs: max(measure.spread[Knobs()],
                                 measure.spread[knobs]),
    )


# ---------------------------------------------------------------------------
# Stage: train-step program knobs
# ---------------------------------------------------------------------------


def apply_knobs_to_config(cfg, knobs: Knobs):
    """A config with the knob-controlled fields swapped in (the remat
    policy): what is recomputed changes, never what is computed."""
    if knobs.remat_policy and getattr(cfg, "remat_policy", None) is not None \
            and knobs.remat_policy != cfg.remat_policy:
        return dataclasses.replace(cfg, remat_policy=knobs.remat_policy)
    return cfg


def train_knob_candidates(
    cfg, *, microbatch_options: Sequence[int | None] = (None,),
) -> list[Knobs]:
    """The train-step grid: ``Knobs()`` first, the other remat policy, and
    each microbatch count above 1 (GPipe). The JAX package's "1f1b"
    schedule has no counterpart in the port and is not a candidate."""
    out = [Knobs()]
    for policy in ("full", "dots"):
        if policy != getattr(cfg, "remat_policy", "full"):
            out.append(Knobs(remat_policy=policy))
    for mb in microbatch_options:
        if mb is not None and mb > 1:
            out.append(Knobs(microbatches=mb))
    return out


def measure_train_step(
    cfg, mesh, knobs: Knobs, *,
    global_batch: int, seq: int,
    steps: int = 2, warmup: int = 1, device="cuda",
) -> float:
    """One trial: build the step with the candidate knobs (its tile knob
    pinned for the trial), run ``warmup`` steps, then time ``steps``,
    fenced by reading the loss back. Returns mean step ms. A schedule the
    port does not run (the JAX package's "1f1b") fails the trial where
    ``make_train_step`` refuses it."""
    import numpy as np
    import torch

    from tony_tpu_torch.models.train import make_train_step
    from tony_tpu_torch.ops import attention as attention_lib

    kwargs: dict[str, Any] = {}
    if knobs.microbatches is not None:
        kwargs["pipeline_microbatches"] = knobs.microbatches
    if knobs.pipeline_schedule:
        kwargs["pipeline_schedule"] = knobs.pipeline_schedule
    kcfg = apply_knobs_to_config(cfg, knobs)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, kcfg.vocab_size, (global_batch, seq + 1)))
    prev_blocks = attention_lib.tuned_blocks()
    try:
        attention_lib.set_tuned_blocks(knobs.block_q, knobs.block_k)
        init_fn, step_fn = make_train_step(kcfg, mesh, device=device,
                                           **kwargs)
        state = init_fn(0)
        metrics = None
        for _ in range(warmup):
            state, metrics = step_fn(state, tokens)
        if metrics is not None:
            float(metrics["loss"])  # readback: the fence
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step_fn(state, tokens)
        float(metrics["loss"])
        dt = time.perf_counter() - t0
    finally:
        attention_lib.set_tuned_blocks(*prev_blocks)
    return dt / steps * 1000.0


def tune_train_step(
    cfg, mesh, *,
    global_batch: int, seq: int,
    candidates: Sequence[Knobs] | None = None,
    steps: int = 2, warmup: int = 1,
    trial_budget: int | None = None,
    cache_dir: str | None = None,
    force: bool = False,
    device="cuda",
) -> dict[str, Any]:
    """The train-step stage: measure the knob grid for (cfg, mesh) and
    persist the winner under the identity ``make_train_step`` looks up
    ((model config, topology, backend); the batch and sequence are not in
    it, since the builder does not know them)."""
    if candidates is None:
        candidates = train_knob_candidates(cfg)
    key = tune_key("lm_train_step", config=cfg, mesh=mesh)

    def measure(knobs: Knobs) -> float:
        return measure_train_step(
            cfg, mesh, knobs, global_batch=global_batch, seq=seq,
            steps=steps, warmup=warmup, device=device,
        )

    return search(
        "lm_train_step", candidates, measure, key=key,
        trial_budget=trial_budget, cache_dir=cache_dir, force=force,
    )
