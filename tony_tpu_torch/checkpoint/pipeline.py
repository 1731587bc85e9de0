"""The staged save pipeline: snapshot/encode thread → persist worker(s).

The DevicePrefetcher pattern (io/device_prefetch) run in reverse: where
the input pipeline overlaps H2D transfers with the running step behind a
depth-bounded queue, this overlaps checkpoint *persistence* with
training. ``submit`` is the only thing the train loop ever waits on, and
it blocks only when ``depth`` saves are already in flight (backpressure:
a wedged store must throttle saving, not grow an unbounded host-memory
queue of snapshots).

Stage 1 (one thread, strictly ordered): materialize/encode the host
tree, hash leaves, and plan the differential — diff chains require the
saves to be planned in submission order, so this stage is deliberately
singular. Stage 2 (``workers`` threads): the byte-heavy part — serialize
+ upload shard files and commit markers; several steps may be uploading
concurrently, each step's commit independent.

Failures never vanish: the first error is held and re-raised from
``drain()`` (or the manager's next ``save``), and every queued job behind
a failed one still runs — only the caller decides whether to stop
checkpointing on a broken disk.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Any, Callable

log = logging.getLogger(__name__)


class SavePipeline:
    def __init__(
        self,
        encode_fn: Callable[[Any], Any],
        persist_fn: Callable[[Any], None],
        depth: int = 2,
        workers: int = 1,
        on_depth: Callable[[int], None] | None = None,
    ) -> None:
        self._encode_fn = encode_fn
        self._persist_fn = persist_fn
        self.depth = max(int(depth), 1)
        self.workers = max(int(workers), 1)
        self._on_depth = on_depth
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._encode_q: collections.deque = collections.deque()
        self._persist_q: collections.deque = collections.deque()
        self._inflight = 0
        self._errors: list[BaseException] = []
        self._threads: list[threading.Thread] = []
        self._closed = False

    # -- producer side -------------------------------------------------------
    def submit(self, job: Any) -> None:
        """Enqueue one save. Blocks while ``depth`` saves are in flight."""
        with self._cond:
            if self._closed:
                raise RuntimeError("checkpoint pipeline is closed")
            if not self._threads:
                self._start_threads_locked()
            while self._inflight >= self.depth and not self._closed:
                self._cond.wait(timeout=1.0)
            self._inflight += 1
            self._encode_q.append(job)
            self._cond.notify_all()
        self._report_depth()

    def drain(self) -> None:
        """Block until every submitted save has persisted (or failed);
        re-raise the first failure. A wedged storage backend logs every
        minute instead of hanging silently (TONY-T006)."""
        with self._cond:
            while self._inflight > 0:
                if not self._cond.wait(timeout=60.0) and self._inflight:
                    log.warning(
                        "async checkpoint pipeline still has %d save(s) "
                        "in flight after 60s — storage backend slow or "
                        "wedged", self._inflight,
                    )
        self.raise_pending()

    def raise_pending(self) -> None:
        with self._lock:
            if not self._errors:
                return
            exc, self._errors = self._errors[0], []
        raise RuntimeError("async checkpoint write failed") from exc

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def close(self, timeout: float = 5.0) -> None:
        """Stop the threads once their queues are empty and join them
        (each for up to ``timeout`` s); a later ``submit`` raises."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout)

    # -- worker side ---------------------------------------------------------
    def _start_threads_locked(self) -> None:
        t = threading.Thread(
            target=self._encode_loop, name="ckpt-snapshot", daemon=True
        )
        t.start()
        self._threads.append(t)
        for i in range(self.workers):
            t = threading.Thread(
                target=self._persist_loop, name=f"ckpt-persist-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _encode_loop(self) -> None:
        while True:
            with self._cond:
                while not self._encode_q and not self._closed:
                    self._cond.wait(timeout=1.0)
                if self._closed and not self._encode_q:
                    return
                job = self._encode_q.popleft()
            try:
                payload = self._encode_fn(job)
            except BaseException as exc:
                self._finish_one(exc)
                continue
            with self._cond:
                self._persist_q.append(payload)
                self._cond.notify_all()

    def _persist_loop(self) -> None:
        while True:
            with self._cond:
                while not self._persist_q and not self._closed:
                    self._cond.wait(timeout=1.0)
                if self._closed and not self._persist_q:
                    return
                payload = self._persist_q.popleft()
            try:
                self._persist_fn(payload)
            except BaseException as exc:
                self._finish_one(exc)
                continue
            self._finish_one(None)

    def _finish_one(self, exc: BaseException | None) -> None:
        with self._cond:
            self._inflight -= 1
            if exc is not None:
                self._errors.append(exc)
                log.warning("async checkpoint save failed", exc_info=exc)
            self._cond.notify_all()
        self._report_depth()

    def _report_depth(self) -> None:
        if self._on_depth is None:
            return
        try:
            self._on_depth(self.inflight())
        except Exception:
            pass
