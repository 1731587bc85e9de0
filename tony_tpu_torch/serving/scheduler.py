"""Host half of the continuous-batching serving engine.

``ServingEngine`` owns the request queue and the slot pool and drives the two
device calls of ``serving/engine.py`` from a single loop thread. Each
iteration:

1. **admit** — pop queued requests into freed slots (a slot is a lane of
   the fixed slot batch plus its KV-cache row);
2. **prefill** — one bounded chunk for every pending slot, batched
   ``prefill_batch`` slots per call (chunking bounds how long a long prompt
   can stall the in-flight decode streams);
3. **decode** — a ``decode_window`` for every slot; read the sampled tokens
   back, append them to each active request, and retire sequences at EOS (or
   their token budget), returning the slot to the pool.

Greedy parity contract: a request decoded through the slot engine yields
token for token the same output as a single-request
``models.decode.generate(..., eos_id=)`` call.

The metrics registry, trace spans, compile-plan and autotune hooks of the
JAX package's engine wait for a later slice of the port; the engine keeps
its own tallies (``stats()``) and raw latency samples.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Callable

import numpy as np
import torch

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.decode import fused_on
from tony_tpu_torch.models.transformer import TransformerConfig
from tony_tpu_torch.serving import engine as _engine

log = logging.getLogger(__name__)


class ServingQueueFull(RuntimeError):
    """Admission backpressure: the bounded request queue is at
    ``max_queue`` — callers should shed load (HTTP 429), not buffer."""


class ServingRequest:
    """One in-flight generation request: prompt, token budget,
    per-request sampling temperature and EOS id; filled in by the engine
    loop and resolved through ``result()``."""

    def __init__(self, request_id: str, prompt: np.ndarray,
                 max_new_tokens: int, temperature: float,
                 eos_id: int | None, model: str = "default") -> None:
        self.id = request_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_id = eos_id
        self.model = model
        # Disaggregation: a prefill-only request exports its slot's K/V
        # rows instead of decoding; an inject request enters decode
        # directly from shipped rows.
        self.prefill_only = False
        self.kv: tuple[np.ndarray, np.ndarray] | None = None
        self._inject: tuple[np.ndarray, np.ndarray, int, int] | None = None
        self.tokens: list[int] = []
        self.error: str | None = None
        self.t_submit = time.perf_counter()
        self.t_first_token: float | None = None
        self.t_done: float | None = None
        self._done = threading.Event()
        # Chunk plan [(start, n_valid), ...] filled at admission.
        self._chunks: list[tuple[int, int]] = []
        self._chunk_i = 0

    @property
    def ttft_ms(self) -> float | None:
        if self.t_first_token is None:
            return None
        return (self.t_first_token - self.t_submit) * 1000.0

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> dict:
        """Block until the request retires; returns the response dict
        (tokens, length, ttft_ms, wall_ms). Raises on engine-side failure
        or timeout."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not done in {timeout}s")
        if self.error:
            raise RuntimeError(f"request {self.id}: {self.error}")
        return {
            "id": self.id,
            "tokens": list(self.tokens),
            "length": len(self.tokens),
            "ttft_ms": round(self.ttft_ms or 0.0, 3),
            "wall_ms": round(
                ((self.t_done or self.t_submit) - self.t_submit) * 1000.0, 3
            ),
        }


def _chunk_plan(prompt_len: int, chunk: int) -> list[tuple[int, int]]:
    """(start, n_valid) chunks covering a prompt. Prompts shorter than one
    chunk pad (garbage K/V past ``n_valid`` is overwritten before it is
    ever unmasked); longer prompts emit full chunks with an OVERLAPPED
    final chunk at ``P - chunk``, re-writing identical K/V for the overlap
    instead of padding."""
    if prompt_len <= chunk:
        return [(0, prompt_len)]
    full = prompt_len // chunk
    plan = [(i * chunk, chunk) for i in range(full)]
    if prompt_len % chunk:
        plan.append((prompt_len - chunk, chunk))
    return plan


class ServingEngine:
    """Continuous-batching engine over a fixed slot batch on ``device``.

    ``params`` may be raw training params or the fused ``decode_weights``
    layout (a ``DecodeSession.params``); fusion runs once here either way.
    ``max_len`` sizes each slot's KV row (default ``cfg.max_seq``);
    admission requires ``len(prompt) + max_new_tokens <= max_len``.
    """

    def __init__(
        self,
        params: dict,
        cfg: TransformerConfig,
        *,
        device="cuda",
        slots: int = 8,
        max_len: int | None = None,
        prefill_chunk: int = 32,
        prefill_batch: int = 4,
        decode_window: int = 1,
        max_queue: int = 1024,
        max_resident_models: int = 4,
        seed: int = 0,
    ) -> None:
        self.device = resolve_device(device)
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if decode_window < 1:
            raise ValueError(
                f"decode_window must be >= 1, got {decode_window}"
            )
        max_len = int(max_len or cfg.max_seq)
        if not 0 < max_len <= cfg.max_seq:
            raise ValueError(
                f"max_len {max_len} must be in (0, cfg.max_seq="
                f"{cfg.max_seq}] — RoPE tables are sized by cfg.max_seq"
            )
        prefill_chunk = min(int(prefill_chunk), max_len)
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.cfg = cfg
        self.slots = int(slots)
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.decode_window = int(decode_window)
        self.prefill_batch = max(1, int(prefill_batch))
        self.max_queue = int(max_queue)
        self._k, self._v = _engine.init_slot_cache(
            cfg, self.slots, max_len, device=self.device
        )
        self.params = fused_on(params, cfg, self.device)
        # Model multiplexing: named fused-weight sets share the engine;
        # ``_resident`` is the LRU of fused params, evicted models re-fuse
        # from their registered loader on the next swap.
        self.max_resident_models = max(1, int(max_resident_models))
        self._model = "default"
        self._resident: OrderedDict[str, dict] = OrderedDict(
            [("default", self.params)]
        )
        self._model_loaders: dict[str, Callable[[], dict]] = {}
        self._pos = np.zeros(self.slots, np.int32)
        self._active = np.zeros(self.slots, bool)
        self._last = np.zeros(self.slots, np.int32)
        self._temp = np.zeros(self.slots, np.float32)
        self._slot_req: list[ServingRequest | None] = [None] * self.slots
        self._queue: deque[ServingRequest] = deque()
        self._pf: deque[tuple[ServingRequest, int]] = deque()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._draining = False
        self._thread: threading.Thread | None = None
        self._iter = 0
        self._decode_calls = 0
        self._pf_draws = 0
        self._n_requests = 0
        self._n_retired = 0
        self._n_tokens = 0
        self._ids = itertools.count()
        self._seed = int(seed)
        # Raw latency samples for percentile reporting.
        self.inter_token_ms_samples: deque[float] = deque(maxlen=8192)
        self.ttft_ms_samples: deque[float] = deque(maxlen=8192)

    # -- client surface ----------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        eos_id: int | None = None,
        request_id: str | None = None,
        model: str | None = None,
        _prefill_only: bool = False,
    ) -> ServingRequest:
        """Enqueue one request; returns a handle whose ``result()`` blocks
        until EOS/budget retirement. Thread-safe; raises
        ``ServingQueueFull`` past ``max_queue``. ``model`` targets a
        registered checkpoint (``add_model``); None serves whatever is
        currently loaded."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the slot KV capacity "
                f"({self.max_len})"
            )
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        req = ServingRequest(
            request_id or f"req-{next(self._ids)}", prompt,
            int(max_new_tokens), float(temperature), eos_id,
            model=self._resolve_model(model),
        )
        req.prefill_only = bool(_prefill_only)
        self._enqueue(req)
        return req

    def _enqueue(self, req: ServingRequest) -> None:
        with self._cond:
            if self._stop.is_set():
                raise RuntimeError("engine is shut down")
            if self._draining:
                raise RuntimeError("engine is draining")
            if len(self._queue) >= self.max_queue:
                raise ServingQueueFull(
                    f"serving queue at max_queue={self.max_queue}"
                )
            self._queue.append(req)
            self._n_requests += 1
            self._cond.notify_all()

    def _resolve_model(self, model: str | None) -> str:
        with self._cond:
            if model is None:
                return self._model
            if (model not in self._resident
                    and model not in self._model_loaders):
                raise ValueError(f"unknown model {model!r}")
            return model

    def add_model(self, name: str, params: dict | None = None, *,
                  loader: Callable[[], dict] | None = None) -> None:
        """Register a named checkpoint for multiplexed serving. With
        ``params`` the fused weights become resident immediately (evicting
        the LRU model past ``max_resident_models``); with ``loader``
        fusion is deferred to the first swap. Swaps happen only at an idle
        batch boundary, so greedy parity survives multiplexing."""
        if (params is None) == (loader is None):
            raise ValueError("add_model needs exactly one of "
                             "params/loader")
        if params is not None:
            params = fused_on(params, self.cfg, self.device)
            with self._cond:
                self._resident[name] = params
                self._evict_lru_locked()
        else:
            with self._cond:
                self._model_loaders[name] = loader

    def _evict_lru_locked(self) -> None:
        while len(self._resident) > self.max_resident_models:
            for old in self._resident:
                if old != self._model and old in self._model_loaders:
                    self._resident.pop(old)
                    break
            else:
                return  # nothing evictable (no loader to bring it back)

    def _switch_model(self, name: str) -> None:
        """Make ``name`` the live weights. Called from the loop thread at
        an idle batch boundary; the loader runs outside the condition."""
        with self._cond:
            params = self._resident.get(name)
        if params is None:
            params = fused_on(self._model_loaders[name](), self.cfg,
                              self.device)
        with self._cond:
            self._resident[name] = params
            self._resident.move_to_end(name)
            self._model = name
            self.params = params
            self._evict_lru_locked()

    def prefill_only(
        self,
        prompt,
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        eos_id: int | None = None,
        request_id: str | None = None,
        model: str | None = None,
    ) -> ServingRequest:
        """Disaggregated prefill: run the prompt through chunked prefill,
        sample the first token, then EXPORT the slot's K/V rows
        (``req.kv``, float32) and free the slot instead of decoding."""
        return self.submit(prompt, max_new_tokens,
                           temperature=temperature, eos_id=eos_id,
                           request_id=request_id, model=model,
                           _prefill_only=True)

    def submit_with_kv(
        self,
        kv_k,
        kv_v,
        last_token: int,
        pos: int,
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        eos_id: int | None = None,
        request_id: str | None = None,
        model: str | None = None,
    ) -> ServingRequest:
        """Disaggregated decode: admit a request whose prefill ran on
        another replica. ``kv_k``/``kv_v`` are its exported rows
        ``[L, pos, Hkv, Dh]``, ``last_token`` its sampled first token."""
        kv_k = np.asarray(kv_k)
        kv_v = np.asarray(kv_v)
        pos = int(pos)
        if pos < 1 or kv_k.shape[1] != pos or kv_v.shape[1] != pos:
            raise ValueError(
                f"kv rows must be [L, pos={pos}, Hkv, Dh]; got "
                f"{kv_k.shape} / {kv_v.shape}"
            )
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if pos + max_new_tokens > self.max_len:
            raise ValueError(
                f"pos ({pos}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the slot KV capacity ({self.max_len})"
            )
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        req = ServingRequest(
            request_id or f"req-{next(self._ids)}",
            np.zeros(pos, np.int32), int(max_new_tokens),
            float(temperature), eos_id,
            model=self._resolve_model(model),
        )
        req._inject = (kv_k, kv_v, pos, int(last_token))
        self._enqueue(req)
        return req

    @property
    def tokens_generated(self) -> int:
        """Tokens sampled and accepted by this engine."""
        return self._n_tokens

    def stats(self) -> dict:
        with self._cond:
            return {
                "slots": self.slots,
                "active_slots": int(self._active.sum()),
                "queue_depth": len(self._queue),
                "prefilling": len(self._pf),
                "iterations": self._iter,
                "requests": self._n_requests,
                "retired": self._n_retired,
                "draining": bool(self._draining),
                "kv_quant": "none",
                "model": self._model,
                "models": sorted(set(self._resident)
                                 | set(self._model_loaders)),
                "device": str(self.device),
            }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServingEngine":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="serving-engine", daemon=True
        )
        self._thread.start()
        return self

    def drain(self, timeout: float = 60.0) -> bool:
        """Stop ADMITTING (submit raises) and wait for everything queued
        or in flight to retire. Returns False if the timeout expired with
        work still in flight."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self._stop.is_set():
            s = self.stats()
            if (s["queue_depth"] == 0 and s["active_slots"] == 0
                    and s["prefilling"] == 0):
                return True
            time.sleep(0.05)
        return False

    def close(self) -> None:
        """Stop the loop and fail whatever is still in flight — a served
        request must never hang a client past engine teardown. Call
        ``drain()`` first for a graceful stop."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._fail_pending("engine shut down")

    def _fail_pending(self, error: str) -> None:
        with self._cond:
            pending = list(self._queue) + [
                r for r in self._slot_req if r is not None
            ] + [r for r, _ in self._pf]
            self._queue.clear()
            self._pf.clear()
            self._slot_req = [None] * self.slots
        for req in pending:
            if not req.done():
                req.error = error
                req._done.set()

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                if not self.step():
                    with self._cond:
                        if not self._queue and not self._stop.is_set():
                            self._cond.wait(timeout=0.05)
        except Exception as exc:  # noqa: BLE001 — the loop IS the engine
            # A dying loop must never look healthy: fail every request
            # instead of letting clients long-poll to their timeout.
            log.exception("serving engine loop died")
            self._stop.set()
            self._fail_pending(f"engine loop failed: {exc}")

    # -- the iteration -----------------------------------------------------
    @torch.no_grad()
    def step(self) -> bool:
        """One engine iteration (admit -> prefill chunk(s) -> decode window
        for all slots -> retire). Public so tests can drive the loop
        without threads. Returns False when fully idle."""
        t0 = time.perf_counter()
        self._admit()
        did_prefill = self._prefill_some()
        decoded = False
        if self._active.any():
            w = self.decode_window
            # Inactive lanes park their write at Tmax-1 (the wpos
            # contract): writing at their stale pos would clobber a
            # concurrent prefill into the same slot.
            wpos = np.where(self._active, self._pos,
                            np.int32(self.max_len - 1)).astype(np.int32)
            # Decode draws live in [0, 2**30), prefill draws in
            # [2**30, 2**31).
            self._k, self._v, window = _engine.decode_window(
                self.params, self._k, self._v, self._pos, wpos,
                self._last, self._temp, self._seed,
                (self._decode_calls * w) % 2**30,
                cfg=self.cfg, steps=w,
            )
            self._decode_calls += 1
            toks = window.cpu().numpy()  # the per-window sync point
            wall_ms = (time.perf_counter() - t0) * 1000.0
            # Recorded per token (wall / window): the sustained per-stream
            # gap is what capacity planning reads.
            self.inter_token_ms_samples.append(wall_ms / w)
            n_new = 0
            for s in np.flatnonzero(self._active):
                req = self._slot_req[s]
                for j in range(w):
                    tok = int(toks[s, j])
                    req.tokens.append(tok)
                    n_new += 1
                    if ((req.eos_id is not None and tok == req.eos_id)
                            or len(req.tokens) >= req.max_new_tokens):
                        # Mid-window retirement: the lane's later tokens
                        # are discarded and the slot frees now.
                        self._retire(s)
                        break
                else:
                    self._pos[s] += w
                    self._last[s] = int(toks[s, -1])
            self._n_tokens += n_new
            decoded = True
        self._iter += 1
        return did_prefill or decoded

    def _next_admissible_locked(self) -> ServingRequest | None:
        """First queued request served by the CURRENT weights; within one
        model, order stays FIFO."""
        for i, req in enumerate(self._queue):
            if req.model == self._model:
                del self._queue[i]
                return req
        return None

    def _admit(self) -> None:
        injects: list[tuple[ServingRequest, int]] = []
        switch_to: str | None = None
        with self._cond:
            for s in range(self.slots):
                if not self._queue:
                    break
                if self._slot_req[s] is not None:
                    continue
                req = self._next_admissible_locked()
                if req is None:
                    break
                self._slot_req[s] = req
                self._pos[s] = 0
                self._active[s] = False
                self._temp[s] = req.temperature
                if req._inject is not None:
                    injects.append((req, s))
                else:
                    req._chunks = _chunk_plan(req.prompt.size,
                                              self.prefill_chunk)
                    req._chunk_i = 0
                    self._pf.append((req, s))
            # Idle batch boundary + only foreign-model work queued: swap
            # weights (nothing in flight can straddle two checkpoints).
            if (self._queue and not self._pf
                    and not self._active.any()
                    and all(r is None for r in self._slot_req)):
                switch_to = self._queue[0].model
        for req, s in injects:
            self._inject_kv(req, s)
        if switch_to is not None and switch_to != self._model:
            self._switch_model(switch_to)

    def _inject_kv(self, req: ServingRequest, slot: int) -> None:
        """Write shipped KV rows into the slot and enter decode directly."""
        kv_k, kv_v, pos, last = req._inject
        _engine.cache_inject_rows(self._k, slot, kv_k)
        _engine.cache_inject_rows(self._v, slot, kv_v)
        self._pos[slot] = pos
        self._last[slot] = last
        self._active[slot] = True

    def _prefill_some(self) -> bool:
        """Run one prefill ROUND: one chunk for every pending slot,
        batched ``prefill_batch`` slots per call and padded by duplicating
        entry 0 (an idempotent rewrite)."""
        with self._cond:
            if not self._pf:
                return False
            budget = len(self._pf)
        while budget > 0:
            with self._cond:
                n = min(self.prefill_batch, budget, len(self._pf))
                entries = [self._pf.popleft() for _ in range(n)]
            if not entries:
                break
            budget -= n
            pb = self.prefill_batch
            toks = np.zeros((pb, self.prefill_chunk), np.int32)
            slots_a = np.zeros(pb, np.int32)
            starts = np.zeros(pb, np.int32)
            n_valids = np.ones(pb, np.int32)
            temps = np.zeros(pb, np.float32)
            finals = []
            for i, (req, slot) in enumerate(entries):
                start, n_valid = req._chunks[req._chunk_i]
                toks[i, :n_valid] = req.prompt[start:start + n_valid]
                slots_a[i] = slot
                starts[i] = start
                n_valids[i] = n_valid
                temps[i] = req.temperature
                finals.append(req._chunk_i == len(req._chunks) - 1)
                req._chunk_i += 1
            for i in range(n, pb):  # pad by duplicating row 0
                toks[i] = toks[0]
                slots_a[i] = slots_a[0]
                starts[i] = starts[0]
                n_valids[i] = n_valids[0]
                temps[i] = temps[0]
            self._pf_draws += 1
            self._k, self._v, first_toks, _ = _engine.prefill_chunks(
                self.params, self._k, self._v, toks, slots_a, starts,
                n_valids, temps, self._seed,
                2**30 + self._pf_draws % 2**30, cfg=self.cfg,
            )
            firsts = first_toks.cpu().numpy()  # the per-round sync point
            now = time.perf_counter()
            requeue: list[tuple[ServingRequest, int]] = []
            for i, (req, slot) in enumerate(entries):
                if not finals[i]:
                    # More chunks to go: back of the queue (round-robin).
                    requeue.append((req, slot))
                    continue
                first = int(firsts[i])
                req.t_first_token = now
                self.ttft_ms_samples.append((now - req.t_submit) * 1000.0)
                self._pos[slot] = req.prompt.size
                self._last[slot] = first
                req.tokens.append(first)
                self._n_tokens += 1
                if req.prefill_only:
                    # Export the slot's freshly written KV rows and free
                    # the slot; the decode replica injects them.
                    n_rows = int(req.prompt.size)
                    req.kv = (
                        _engine.cache_export_rows(
                            self._k, slot, n_rows).cpu().numpy(),
                        _engine.cache_export_rows(
                            self._v, slot, n_rows).cpu().numpy(),
                    )
                    self._retire(slot)
                elif ((req.eos_id is not None and first == req.eos_id)
                        or req.max_new_tokens <= 1):
                    self._retire(slot)
                else:
                    self._active[slot] = True
            if requeue:
                with self._cond:
                    self._pf.extend(requeue)
        return True

    def _retire(self, slot: int) -> None:
        req = self._slot_req[slot]
        self._active[slot] = False
        self._slot_req[slot] = None
        # Reset the lane temperature: a stale hot value would keep the
        # slot batch paying for random draws while the slot sits empty.
        self._temp[slot] = 0.0
        self._n_retired += 1
        req.t_done = time.perf_counter()
        req._done.set()
