"""Sharding plans, the planner and its measurement table, and the compile
cache: the port of the JAX package's ``parallel/plan.py``.

* ``Plan``: a declarative description of one train step: the mesh spec
  (+ slice count), microbatching for the pipeline trunk, and the
  schedule/virtual-stage knobs. ``make_train_step(plan=)`` takes one;
  ``plan_from_mesh`` gives the Plan of a mesh ``build_mesh`` made.
* The planner: ``candidate_plans`` enumerates every legal factoring of a
  device count over (dp, pp, ep, sp, tp) for a model config; ``plan_for``
  ranks them with the analytic cost model (``estimate_cost``,
  ``estimate_phases``) refined by measured step times
  (``record_step_time`` keeps the best wall per plan in
  ``plan-measurements.json``, in the JAX package's format, so a table one
  package writes the other reads); ``calibration_residuals`` says how far
  each measured plan sits from the model; ``shrink_plans`` plans a
  shrunken topology without a config.
* The compile cache. The port has no XLA cache: what a process compiles
  and a retry can reuse are the kernel libraries. ``configure_compile_cache``
  points ``kernels.py``'s build directory, the plan-key index and the
  measurement table at ``TONY_COMPILE_CACHE_DIR`` (``tony.compile.*``
  conf through the executor's env; unset, the package's gitignored
  ``_build/``). ``timed_compile``/``instrument_jit`` time each first call
  of a step (kernel builds or loads, the CUDA context, library handles:
  what a retry pays) into ``tony_compile_ms`` and count it as a hit or a
  miss against the key index, and with the jit sanitizer armed classify
  every dispatch and run it in a ``step_region``.

A plan cache key digests the model config, the mesh topology, the torch
and CUDA versions, the device and the kernel sources: what must
invalidate a compiled artefact. Corrupt or partial markers and tables
degrade to a miss, never a crash.

The cost constants are the JAX package's (TPU interconnect units, not
times). Recalibrating them for NVLink and NCCL needs several cards'
measurements; until then the ranking is the reference's, and the
measurement table re-anchors it where a plan has been run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Mapping

from tony_tpu_torch.parallel.mesh import AXES, MeshSpec, build_mesh, mesh_spec

# Metric names (rendered on /metrics). Registered lazily so importing this
# module never touches the registry.
_CACHE_HITS_COUNTER = "tony_compile_cache_hits_total"
_CACHE_MISSES_COUNTER = "tony_compile_cache_misses_total"
_COMPILE_MS_HISTOGRAM = "tony_compile_ms"

# First-call walls run seconds (kernel builds), not milliseconds.
_COMPILE_BUCKETS = (
    50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
    30000.0, 60000.0, 120000.0,
)

# Subdirectory of the cache dir holding the plan-key index (one JSON marker
# per compiled plan key), and the measured step-time table beside it.
_KEY_INDEX_DIR = "tony-plan-keys"
_MEASUREMENTS_FILE = "plan-measurements.json"

# The cache dir configure_compile_cache resolved (None: not configured or
# disabled, every first call a miss).
_ACTIVE_CACHE_DIR: str | None = None


def _is_remote_uri(path: str) -> bool:
    return "://" in path


def _local_sidecar_dir(cache_dir: str) -> str:
    """Where the key index and measurement table live for a remote
    (gs://) cache dir, which the port cannot write with open(): a local
    mirror under the default cache dir keyed by the URI."""
    digest = hashlib.sha256(cache_dir.encode()).hexdigest()[:16]
    return os.path.join(default_cache_dir(), "plan-sidecar", digest)


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Plan:
    """A declarative plan: how one train step is sharded.

    ``microbatches=None`` selects the plain trunk; any integer selects the
    pipeline trunk (``forward_pipeline``). ``donate_state`` is kept for the
    plan's identity; the port's train step updates its state in place
    whatever it says."""

    mesh_spec: MeshSpec
    num_slices: int = 1
    microbatches: int | None = None
    pipeline_schedule: str = "gpipe"
    pipeline_virtual: int = 1
    donate_state: bool = True

    @property
    def trunk(self) -> str:
        return "pipeline" if self.microbatches is not None else "gspmd"

    @property
    def num_devices(self) -> int:
        return self.mesh_spec.num_devices

    def build_mesh(self, device="cuda", **kwargs):
        return build_mesh(self.mesh_spec, device,
                          num_slices=self.num_slices, **kwargs)

    def train_step_kwargs(self) -> dict[str, Any]:
        """kwargs for ``make_train_step`` implied by this plan."""
        return {
            "pipeline_microbatches": self.microbatches,
            "pipeline_schedule": self.pipeline_schedule,
            "pipeline_virtual": self.pipeline_virtual,
        }

    def key(self) -> str:
        """Short stable id for measurement tables and log lines."""
        s = self.mesh_spec
        parts = [f"dp{s.dp}", f"pp{s.pp}", f"ep{s.ep}", f"sp{s.sp}",
                 f"tp{s.tp}"]
        if self.num_slices > 1:
            parts.append(f"x{self.num_slices}sl")
        if self.microbatches is not None:
            parts.append(f"mb{self.microbatches}")
            if self.pipeline_schedule != "gpipe":
                parts.append(f"{self.pipeline_schedule}{self.pipeline_virtual}")
        return ".".join(parts)

    def describe(self) -> dict[str, Any]:
        return {
            "mesh": dict(zip(AXES, self.mesh_spec.shape)),
            "num_slices": self.num_slices,
            "trunk": self.trunk,
            "microbatches": self.microbatches,
            "schedule": self.pipeline_schedule,
            "virtual": self.pipeline_virtual,
        }


# ---------------------------------------------------------------------------
# Cache keying
# ---------------------------------------------------------------------------


def _canonical(obj: Any) -> Any:
    """JSON-stable form: dataclasses to dicts, tuples to lists, sets
    sorted. Unknown objects fall back to repr."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            "__dataclass__": type(obj).__name__,
            **{k: _canonical(v)
               for k, v in dataclasses.asdict(obj).items()},
        }
    if isinstance(obj, Mapping):
        return {str(k): _canonical(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(repr(v) for v in obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def backend_fingerprint(mesh=None) -> dict[str, Any]:
    """The backend a compiled artefact is valid for: the torch and CUDA
    versions, the platform, the device's name and count (the mesh's when
    given), and the digest of the kernel sources."""
    import torch

    from tony_tpu_torch import kernels

    fp: dict[str, Any] = {"torch": torch.__version__,
                          "cuda": torch.version.cuda,
                          "kernels": kernels.sources_digest()}
    if mesh is not None:
        fp["platform"] = mesh.device_type
        fp["num_devices"] = mesh_spec(mesh).num_devices
    elif torch.cuda.is_available():
        fp["platform"] = "cuda"
        fp["num_devices"] = torch.cuda.device_count()
    else:
        fp["platform"] = "cpu"
        fp["num_devices"] = 1
    fp["device_kind"] = (torch.cuda.get_device_name()
                         if fp["platform"] == "cuda" else "cpu")
    return fp


def plan_cache_key(
    label: str,
    *,
    config: Any = None,
    mesh=None,
    plan: Plan | None = None,
    extra: Mapping[str, Any] | None = None,
    backend: Mapping[str, Any] | None = None,
) -> str:
    """Digest everything whose change must invalidate a compiled artefact:
    the step label, the model config, the mesh topology (axis names and
    sizes: ``build_mesh``'s five axes), the plan knobs, the backend
    identity and any caller extras."""
    payload: dict[str, Any] = {
        "label": label,
        "backend": _canonical(
            dict(backend) if backend is not None
            else backend_fingerprint(mesh)
        ),
    }
    if config is not None:
        payload["config"] = _canonical(config)
    if mesh is not None:
        payload["mesh"] = {
            "axes": list(AXES),
            "shape": list(mesh_spec(mesh).shape),
        }
    if plan is not None:
        payload["plan"] = _canonical(plan)
    if extra:
        payload["extra"] = _canonical(dict(extra))
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# The compile cache
# ---------------------------------------------------------------------------


def default_cache_dir() -> str:
    """The cache dir when ``tony.compile.cache-dir`` is empty: the
    package's own gitignored build directory, where the kernels are built
    without a configured cache."""
    return str(Path(__file__).resolve().parent.parent / "_build")


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def configure_compile_cache(
    cache_dir: str | None = None,
    enabled: bool | None = None,
) -> str | None:
    """Point the kernel build directory, the plan-key index and the
    measurement table at ``cache_dir``.

    Arguments default from the executor's env (``TONY_COMPILE_CACHE_DIR``
    / ``_ENABLED``, the ``tony.compile.*`` conf); unset, the dir is
    ``default_cache_dir()``. The JAX package's minimum entry size has no
    counterpart: the port caches whole kernel libraries. A remote URI
    keeps the kernels in the default dir and the index in a local
    sidecar. Returns the resolved dir, or None when disabled or
    unwritable (every first call is then a miss). Idempotent."""
    global _ACTIVE_CACHE_DIR
    from tony_tpu_torch import constants, kernels

    if enabled is None:
        enabled = _env_bool(constants.TONY_COMPILE_CACHE_ENABLED, True)
    if not enabled:
        _ACTIVE_CACHE_DIR = None
        return None
    if cache_dir is None:
        cache_dir = os.environ.get(constants.TONY_COMPILE_CACHE_DIR, "")
    cache_dir = os.path.expanduser(cache_dir) if cache_dir \
        else default_cache_dir()
    if not _is_remote_uri(cache_dir):
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError:
            _ACTIVE_CACHE_DIR = None
            return None  # unwritable: run cold, don't crash
        kernels.BUILD_DIR = Path(cache_dir)
    _ACTIVE_CACHE_DIR = cache_dir
    return cache_dir


def active_cache_dir() -> str | None:
    """The cache dir ``configure_compile_cache`` set (None = cold)."""
    return _ACTIVE_CACHE_DIR


class CompileCache:
    """The plan-key index beside the kernel libraries.

    ``seen(key)``: was this plan's first call made against this cache dir
    before? ``commit(key, meta)``: record that it now has been. Every
    failure (missing dir, corrupt or truncated marker, permissions) reads
    as "not seen"."""

    def __init__(self, cache_dir: str | None) -> None:
        self.cache_dir = cache_dir
        if cache_dir and _is_remote_uri(cache_dir):
            cache_dir = _local_sidecar_dir(cache_dir)
        self._index = (
            os.path.join(cache_dir, _KEY_INDEX_DIR) if cache_dir else None
        )

    @classmethod
    def active(cls) -> "CompileCache":
        return cls(active_cache_dir())

    @property
    def enabled(self) -> bool:
        return self._index is not None

    def _marker(self, key: str) -> str | None:
        if self._index is None or not key:
            return None
        return os.path.join(self._index, f"{key}.json")

    def seen(self, key: str) -> bool:
        marker = self._marker(key)
        if marker is None:
            return False
        try:
            with open(marker) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return False  # absent / torn / corrupt => miss, never a crash
        return isinstance(data, dict) and data.get("key") == key

    def commit(self, key: str, meta: Mapping[str, Any] | None = None) -> None:
        marker = self._marker(key)
        if marker is None:
            return
        try:
            os.makedirs(self._index, exist_ok=True)
            payload = {"key": key, "ts_ms": int(time.time() * 1000)}
            if meta:
                payload.update(_canonical(dict(meta)))
            tmp = f"{marker}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(json.dumps(payload))
            os.replace(tmp, marker)
        except OSError:
            pass  # a cache that cannot record stays a cache that misses


def _registry():
    from tony_tpu_torch import observability

    return observability.default_registry()


def _count_compile(hit: bool, wall_ms: float) -> None:
    reg = _registry()
    if hit:
        reg.counter(_CACHE_HITS_COUNTER).inc()
    else:
        reg.counter(_CACHE_MISSES_COUNTER).inc()
    reg.histogram(_COMPILE_MS_HISTOGRAM, buckets=_COMPILE_BUCKETS).observe(
        wall_ms)


@contextmanager
def timed_compile(key: str, cache: CompileCache | None = None,
                  meta: Mapping[str, Any] | None = None):
    """Wrap one first-call region: classify hit/miss against the key index
    before the body, time the body into ``tony_compile_ms``, and commit
    the key after it succeeds. The body is a step's first call, whose
    wall holds the kernel builds or loads and one execution: what a retry
    pays. The wall is the host's: the body is not synchronized, so a
    caller that wants the device's share fences inside it."""
    cache = CompileCache.active() if cache is None else cache
    hit = cache.seen(key)
    t0 = time.perf_counter()
    yield
    _count_compile(hit, (time.perf_counter() - t0) * 1000.0)
    if not hit:
        cache.commit(key, meta)


def _leaves(obj):
    """The leaves of nested dicts (by sorted key), lists and tuples (named
    ones too), in order; None is no leaf, as in a JAX pytree."""
    if isinstance(obj, Mapping):
        for k in sorted(obj, key=str):
            yield from _leaves(obj[k])
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)
    elif obj is not None:
        yield obj


def _args_signature(args, kwargs) -> list[str]:
    """Shape/dtype summary of every tensor-like leaf (numpy scalars too),
    the repr of every other: two calls of one step with different batch
    shapes run different kernel grids and allocations, so the key must
    see the shapes, which exist only at the first call."""
    out: list[str] = []
    for leaf in _leaves((args, kwargs)):
        shape = getattr(leaf, "shape", None)
        if shape is not None:
            out.append(f"{getattr(leaf, 'dtype', '?')}{tuple(shape)}")
        else:
            out.append(repr(leaf))
    return out


def instrument_jit(jit_fn, key: str, *, cache: CompileCache | None = None,
                   meta: Mapping[str, Any] | None = None):
    """Wrap a step callable so its first call runs under ``timed_compile``
    (hit/miss and first-call wall) with ``key`` extended by the call's
    argument shapes; later calls pass straight through.

    With ``TONY_JIT_SANITIZER`` armed every call is also classified by the
    jit sanitizer: the first signature is the cold call (counted by
    ``tony_compile_cache_*`` as before), a repeated one a hit, a new one
    after the first a retrace (``tony_retraces_total`` only, never the
    miss counter); strict mode raises past the key's retrace budget, and
    the call runs inside ``step_region``, where a synchronizing CUDA
    operation raises. Sanitizer off: no per-call cost but one env read."""
    state = {"first": True}

    def call(*args, **kwargs):
        from tony_tpu_torch.analysis import jit_sanitizer

        sanitized = jit_sanitizer.enabled()
        if sanitized:
            sig = hashlib.sha256(
                json.dumps(_args_signature(args, kwargs)).encode()
            ).hexdigest()
            jit_sanitizer.note_dispatch(key, sig)
        if state["first"]:
            state["first"] = False
            full_key = hashlib.sha256(
                json.dumps([key, _args_signature(args, kwargs)]).encode()
            ).hexdigest()
            with timed_compile(full_key, cache=cache, meta=meta):
                with jit_sanitizer.step_region(key):
                    return jit_fn(*args, **kwargs)
        if sanitized:
            with jit_sanitizer.step_region(key):
                return jit_fn(*args, **kwargs)
        return jit_fn(*args, **kwargs)

    call.__wrapped__ = jit_fn
    call.plan_cache_key = key
    return call


# ---------------------------------------------------------------------------
# Planner: candidate enumeration
# ---------------------------------------------------------------------------


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def candidate_plans(
    cfg,
    num_devices: int,
    *,
    num_slices: int = 1,
    global_batch: int | None = None,
    seq: int | None = None,
    max_candidates: int = 64,
    require: Mapping[str, int] | None = None,
) -> list[Plan]:
    """Every legal Plan for ``cfg`` on ``num_devices`` devices, cheapest
    (``estimate_cost``) first.

    Legality is the set of constraints the trunks enforce:

    * tp divides n_heads (and n_kv_heads): whole heads per shard;
    * pp divides n_layers; the pipeline trunk needs microbatches;
    * sp divides the sequence (when known): the ring walks equal chunks;
    * ep > 1 only with experts, and ep divides n_experts;
    * dp * ep (and, pipelined, * microbatches) divides the global batch
      when known;
    * several slices: dp % num_slices == 0 (only dp crosses slices).

    ``require`` pins axes (e.g. ``{"pp": 2}``, ``{"microbatches": 0}``)."""
    require = dict(require or {})
    n_heads = getattr(cfg, "n_heads", 1)
    n_kv = getattr(cfg, "n_kv_heads", 0) or n_heads
    n_layers = getattr(cfg, "n_layers", 1)
    n_experts = getattr(cfg, "n_experts", 0)
    seq = seq if seq is not None else getattr(cfg, "max_seq", None)

    def ok(axis: str, size: int) -> bool:
        if axis in require and require[axis] != size:
            return False
        if axis == "tp":
            return n_heads % size == 0 and n_kv % size == 0
        if axis == "pp":
            return n_layers % size == 0
        if axis == "sp":
            return size == 1 or (seq is None or seq % size == 0)
        if axis == "ep":
            return size == 1 or (n_experts > 0 and n_experts % size == 0)
        return True  # dp

    plans: list[Plan] = []
    for tp in _divisors(num_devices):
        if not ok("tp", tp):
            continue
        for sp in _divisors(num_devices // tp):
            if not ok("sp", sp):
                continue
            for ep in _divisors(num_devices // (tp * sp)):
                if not ok("ep", ep):
                    continue
                for pp in _divisors(num_devices // (tp * sp * ep)):
                    if not ok("pp", pp):
                        continue
                    dp = num_devices // (tp * sp * ep * pp)
                    if not ok("dp", dp):
                        continue
                    if num_slices > 1 and dp % num_slices:
                        continue
                    spec = MeshSpec(dp=dp, pp=pp, ep=ep, sp=sp, tp=tp)
                    if pp == 1:
                        if "microbatches" in require and \
                                require["microbatches"]:
                            continue
                        plans.append(Plan(spec, num_slices=num_slices))
                        continue
                    for m in _microbatch_options(
                        pp, dp, ep, global_batch, require
                    ):
                        plans.append(Plan(
                            spec, num_slices=num_slices, microbatches=m,
                        ))
    plans.sort(key=lambda p: estimate_cost(
        p, cfg, global_batch=global_batch, seq=seq
    ))
    return plans[:max_candidates]


def _microbatch_options(
    pp: int, dp: int, ep: int, global_batch: int | None,
    require: Mapping[str, int],
) -> list[int]:
    """pp and 2 pp microbatches, the points the schedules favour, kept
    where they divide a known batch (none then: a plan the batch cannot
    split is no plan)."""
    if "microbatches" in require:
        m = require["microbatches"]
        return [m] if m else []
    opts = [pp, 2 * pp]
    if global_batch is not None:
        return [m for m in opts if global_batch % (m * dp * ep) == 0]
    return opts


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------

# The reference's relative cost units, copied as they are: they were set
# for TPU interconnect (ICI links, DCN between slices) and are not times.
# Recalibrating them for NVLink and NCCL needs several cards' step times
# (see the module note).
# Relative per-byte cost of a collective on each axis; dp crossing slices
# costs _DCN_PENALTY times more.
_COMM_COST = {"tp": 1.0, "sp": 1.3, "ep": 1.8, "pp": 0.6, "dp": 0.4}
_DCN_PENALTY = 12.0

# Flop-equivalents per communicated element.
_ELEM_UNIT = 8000.0

# Fixed launch overhead per collective hop, in the same flop-equivalent
# units as the compute term.
_HOP_LATENCY = {"tp": 1.0, "sp": 1.5, "ep": 2.0, "pp": 1.0, "dp": 0.5}
_HOP_UNIT = 1e6


def estimate_phases(
    plan: Plan,
    cfg,
    *,
    global_batch: int | None = None,
    seq: int | None = None,
) -> dict[str, Any]:
    """The cost model's compute/communication decomposition for one
    plan: ``{"compute": units, "collective": units, "comm_bytes":
    {axis: bytes/step}}``. Units are arbitrary but shared, so the share
    (collective / total) and the bytes are meaningful without a
    measurement. A pipeline axis without microbatching reads as infinite
    compute."""
    s = plan.mesh_spec
    d_model = getattr(cfg, "d_model", 512)
    d_ff = getattr(cfg, "d_ff", 4 * d_model)
    n_layers = getattr(cfg, "n_layers", 1)
    n_heads = getattr(cfg, "n_heads", 8)
    head_dim = getattr(cfg, "head_dim", 64)
    n_kv = getattr(cfg, "n_kv_heads", 0) or n_heads
    seq = seq or getattr(cfg, "max_seq", 1024)
    batch = global_batch or max(s.dp * s.ep, 1)

    # Model flops per step (PaLM 6N counting + causal attention term).
    n_params = n_layers * (
        d_model * (n_heads + 2 * n_kv) * head_dim
        + n_heads * head_dim * d_model
        + 3 * d_model * d_ff
    ) + 2 * getattr(cfg, "vocab_size", 32000) * d_model
    flops = 6.0 * n_params * batch * seq \
        + 6.0 * n_layers * batch * seq * seq * n_heads * head_dim
    compute = flops / plan.num_devices

    # Fill penalty: each tp-split matmul contraction below 128 lanes
    # leaves the matrix unit proportionally idle.
    def fill(dim: int) -> float:
        return max(1.0, 128.0 / max(dim, 1)) ** 0.5

    compute *= fill(d_ff // s.tp) * fill((n_heads // s.tp) * head_dim)

    # Pipeline bubble (gpipe): (pp-1) of (m + pp - 1) ticks are idle.
    if plan.microbatches:
        m = plan.microbatches
        compute *= (m + s.pp - 1) / m
    elif s.pp > 1:
        compute = math.inf

    # Communication volumes per axis, in elements.
    act = batch * seq * d_model / max(s.dp * s.ep * s.sp, 1)
    elems: dict[str, float] = {}
    if s.tp > 1:  # 4 (ag + rs) pairs per layer on the megatron split
        elems["tp"] = 4 * n_layers * act * (s.tp - 1) / s.tp
    if s.sp > 1:  # ring K/V pass per layer
        kv = batch * seq * n_kv * head_dim / max(s.dp * s.ep, 1)
        elems["sp"] = 2 * n_layers * kv * (s.sp - 1) / s.sp
    if s.ep > 1:  # token all_to_all both ways per layer
        elems["ep"] = 2 * n_layers * act * (s.ep - 1) / s.ep
    if s.pp > 1:  # stage-boundary activations across pp-1 boundaries
        elems["pp"] = act * (s.pp - 1)
    if s.dp > 1:  # gradient mean over the sharded params
        elems["dp"] = 2 * n_params * (s.dp - 1) / s.dp
    comm = sum(
        _COMM_COST[ax] * (
            _DCN_PENALTY if ax == "dp" and plan.num_slices > 1 else 1.0
        ) * v
        for ax, v in elems.items()
    )
    # Fixed launch overhead: (axis_size - 1) hops per collective round.
    hops = sum(
        _HOP_LATENCY[ax] * (getattr(s, ax) - 1) * n_layers
        for ax in ("tp", "sp", "ep", "pp")
    ) + _HOP_LATENCY["dp"] * (s.dp - 1)
    elem_bytes = 2.0 if "16" in str(getattr(cfg, "dtype", "")) else 4.0
    return {
        "compute": compute,
        "collective": comm * _ELEM_UNIT + hops * _HOP_UNIT,
        "comm_bytes": {ax: v * elem_bytes for ax, v in elems.items()},
    }

def estimate_cost(
    plan: Plan,
    cfg,
    *,
    global_batch: int | None = None,
    seq: int | None = None,
) -> float:
    """Relative step-time estimate (arbitrary units; only the order of the
    candidates matters, measured step times recalibrate the scale): the
    compute and collective terms of ``estimate_phases`` summed."""
    est = estimate_phases(plan, cfg, global_batch=global_batch, seq=seq)
    return est["compute"] + est["collective"]


# ---------------------------------------------------------------------------
# Planner: measured refinement and selection
# ---------------------------------------------------------------------------


def _measurements_path(cache_dir: str | None = None) -> str | None:
    cache_dir = cache_dir or active_cache_dir()
    if not cache_dir:
        return None
    if _is_remote_uri(cache_dir):
        cache_dir = _local_sidecar_dir(cache_dir)
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError:
            return None
    return os.path.join(cache_dir, _MEASUREMENTS_FILE)


def _model_bucket(cfg, num_devices: int, global_batch: int | None,
                  seq: int | None) -> str:
    """Measurements compare only at equal work: one (model config, device
    count, global batch, sequence) bucket per table entry."""
    blob = json.dumps(
        {"cfg": _canonical(cfg), "n": num_devices,
         "batch": global_batch, "seq": seq},
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def record_step_time(
    plan: Plan, cfg, step_time_ms: float, *,
    global_batch: int | None = None, seq: int | None = None,
    cache_dir: str | None = None,
) -> None:
    """Persist one measured step time for (cfg, plan) beside the compile
    cache, keeping the best (minimum) per plan key. Pass the
    ``global_batch``/``seq`` a later ``plan_for`` will ask with: they key
    the bucket."""
    path = _measurements_path(cache_dir)
    if path is None or not math.isfinite(step_time_ms) or step_time_ms <= 0:
        return
    table = load_measurements(cache_dir=cache_dir)
    bucket = table.setdefault(
        _model_bucket(cfg, plan.num_devices, global_batch, seq), {}
    )
    prev = bucket.get(plan.key())
    if prev is None or step_time_ms < prev:
        bucket[plan.key()] = round(float(step_time_ms), 3)
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def load_measurements(cache_dir: str | None = None) -> dict[str, dict]:
    path = _measurements_path(cache_dir)
    if path is None:
        return {}
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return {}  # a corrupt table is no refinement, never a crash
    return table if isinstance(table, dict) else {}


def plan_for(
    cfg,
    num_devices: int,
    *,
    num_slices: int = 1,
    global_batch: int | None = None,
    seq: int | None = None,
    cache_dir: str | None = None,
    require: Mapping[str, int] | None = None,
) -> Plan:
    """The Plan for ``cfg`` on this topology: the cheapest candidate by the
    cost model, or, where the measurement table holds step times for this
    bucket, by measured milliseconds for the measured plans and estimates
    scaled by the mean measured/estimated ratio for the rest."""
    plans = candidate_plans(
        cfg, num_devices, num_slices=num_slices,
        global_batch=global_batch, seq=seq, require=require,
    )
    if not plans:
        raise ValueError(
            f"no legal plan for {num_devices} devices with config {cfg!r}"
        )
    measured = load_measurements(cache_dir=cache_dir).get(
        _model_bucket(cfg, num_devices, global_batch, seq), {}
    )
    if not measured:
        return plans[0]
    est = {
        p.key(): estimate_cost(p, cfg, global_batch=global_batch, seq=seq)
        for p in plans
    }
    ratios = [
        measured[k] / est[k]
        for k in measured
        if k in est and math.isfinite(est[k]) and est[k] > 0
    ]
    scale = sum(ratios) / len(ratios) if ratios else 1.0

    def cost(p: Plan) -> float:
        k = p.key()
        return measured[k] if k in measured else est[k] * scale

    return min(plans, key=cost)


def shrink_plans(
    num_devices: int,
    *,
    num_slices: int = 1,
    cfg=None,
    require: Mapping[str, int] | None = None,
    max_candidates: int = 8,
) -> list[Plan]:
    """Candidate plans for a shrunken topology (the elastic-shrink oracle,
    which knows no model config): ``cfg=None`` plans topology only, every
    model-shape check at its permissive default, so pin what is known with
    ``require``. Ranked as ``candidate_plans`` ranks."""
    return candidate_plans(
        cfg if cfg is not None else SimpleNamespace(),
        max(num_devices, 1),
        num_slices=max(num_slices, 1),
        require=require,
        max_candidates=max_candidates,
    )


def plan_from_mesh(mesh, *, microbatches: int | None = None,
                   num_slices: int = 1, **kwargs) -> Plan:
    """The Plan implied by a mesh ``build_mesh`` made: axis sizes come
    from the mesh's shape."""
    return Plan(mesh_spec(mesh), num_slices=num_slices,
                microbatches=microbatches, **kwargs)


def calibration_residuals(
    cfg,
    num_devices: int,
    *,
    num_slices: int = 1,
    global_batch: int | None = None,
    seq: int | None = None,
    cache_dir: str | None = None,
) -> dict[str, float]:
    """Per-plan calibration residuals of one measurement bucket:
    measured/estimated, normalized by the bucket's mean ratio (the scale
    ``plan_for`` applies to unmeasured plans). 1.0: the cost model ranks
    the plan as the calibration predicts; the spread across plans is model
    error, drift on one plan the hardware or input changing. Published as
    ``tony_plan_residual{plan=}``."""
    measured = load_measurements(cache_dir=cache_dir).get(
        _model_bucket(cfg, num_devices, global_batch, seq), {}
    )
    if not measured:
        return {}
    try:
        plans = candidate_plans(
            cfg, num_devices, num_slices=num_slices,
            global_batch=global_batch, seq=seq,
        )
    except Exception:
        return {}
    est = {
        p.key(): estimate_cost(p, cfg, global_batch=global_batch, seq=seq)
        for p in plans
    }
    ratios = {
        k: measured[k] / est[k]
        for k in measured
        if k in est and math.isfinite(est[k]) and est[k] > 0
    }
    if not ratios:
        return {}
    scale = sum(ratios.values()) / len(ratios)
    if scale <= 0:
        return {}
    return {k: r / scale for k, r in ratios.items()}
