"""HTTP front end for the serving engine — what a ``serving`` task runs
behind the proxy tunnel. The port's own copy of the JAX package's server:
the same routes, bodies and status codes.

Deliberately minimal (stdlib ``ThreadingHTTPServer``, one thread per
in-flight client like the rest of the control plane):

* ``POST /generate`` — body ``{"prompt": [ids], "max_new_tokens": n,
  "temperature": t?, "eos_id": id?, "model": name?}``; blocks until the
  request retires (long-poll — continuous batching means admission is
  immediate once a slot frees) and returns ``{"tokens": [...],
  "length": n, "ttft_ms": ..., "wall_ms": ...}``. 400 on a malformed
  body; 429 with ``Retry-After`` when the bounded queue sheds load (a
  distinguishable shed signal — the fleet router retries another
  replica on 429, but treats 503 as a replica failure).
* ``POST /prefill`` — disaggregated prefill: same request body as
  ``/generate``; returns the first sampled token plus the slot's K/V
  rows as base64 float32 (``{"kv": {"k": ..., "v": ..., "shape": ...},
  "last_token": t, "pos": p}``) for ``/inject`` on a decode replica.
* ``POST /inject`` — disaggregated decode: body carries a ``/prefill``
  response's ``kv``/``last_token``/``pos`` plus ``max_new_tokens``;
  long-polls the decode exactly like ``/generate``.
* ``GET /healthz`` — engine stats JSON (``active_slots``,
  ``queue_depth``, ``draining``, ``models``, ...) plus any
  ``extra_health`` fields (the fleet layer adds the replica role);
  the one endpoint the router/autoscaler read readiness from.
* ``POST /shutdown`` — graceful stop: the serve loop returns, so a
  tony-launched serving task exits 0 and the session SUCCEEDs.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tony_tpu_torch.serving.scheduler import ServingEngine, ServingQueueFull

log = logging.getLogger(__name__)


def encode_kv(kv_k: np.ndarray, kv_v: np.ndarray) -> dict:
    """Wire format for shipped KV rows: base64 float32 (bf16 -> f32 is
    exact)."""
    k = np.asarray(kv_k, np.float32)
    v = np.asarray(kv_v, np.float32)
    return {
        "k": base64.b64encode(k.tobytes()).decode("ascii"),
        "v": base64.b64encode(v.tobytes()).decode("ascii"),
        "shape": list(k.shape),
    }


def decode_kv(obj: dict) -> tuple[np.ndarray, np.ndarray]:
    shape = tuple(int(x) for x in obj["shape"])
    k = np.frombuffer(base64.b64decode(obj["k"]),
                      np.float32).reshape(shape)
    v = np.frombuffer(base64.b64decode(obj["v"]),
                      np.float32).reshape(shape)
    return k, v


class ServingServer:
    """Binds ``port`` (0 = ephemeral) on ``host`` and serves the engine
    until ``/shutdown`` or ``stop()``."""

    def __init__(self, engine: ServingEngine, port: int = 0,
                 host: str = "0.0.0.0",
                 request_timeout_s: float = 600.0,
                 extra_health: dict | None = None) -> None:
        self.engine = engine
        self.extra_health = dict(extra_health or {})
        self._shutdown = threading.Event()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet: the engine has metrics
                pass

            def _reply(self, code: int, obj: dict,
                       headers: dict | None = None) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    health = outer.engine.stats()
                    health.update(outer.extra_health)
                    self._reply(200, health)
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def _read_body(self) -> bytes:
                n = int(self.headers.get("Content-Length", "0"))
                return self.rfile.read(n)

            def do_POST(self):
                # Every route reads the whole body before it replies: a
                # socket closed with request bytes unread is reset, and the
                # reset can discard the reply before the client reads it.
                try:
                    raw = self._read_body()
                except ValueError as exc:
                    self._reply(400, {"error": f"bad request: {exc}"})
                    return
                if self.path == "/shutdown":
                    self._reply(200, {"ok": True})
                    outer._shutdown.set()
                    return
                if self.path not in ("/generate", "/prefill", "/inject"):
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    body = json.loads(raw or b"{}")
                    max_new = int(body["max_new_tokens"])
                    temperature = float(body.get("temperature", 0.0))
                    eos = body.get("eos_id")
                    eos_id = None if eos is None else int(eos)
                    model = body.get("model")
                    if self.path == "/inject":
                        kv_k, kv_v = decode_kv(body["kv"])
                        last = int(body["last_token"])
                        pos = int(body["pos"])
                    else:
                        prompt = body["prompt"]
                except (KeyError, TypeError, ValueError) as exc:
                    self._reply(400, {"error": f"bad request: {exc}"})
                    return
                try:
                    if self.path == "/generate":
                        req = outer.engine.submit(
                            prompt, max_new, temperature=temperature,
                            eos_id=eos_id, model=model,
                        )
                        self._reply(200,
                                    req.result(timeout=request_timeout_s))
                    elif self.path == "/prefill":
                        req = outer.engine.prefill_only(
                            prompt, max_new, temperature=temperature,
                            eos_id=eos_id, model=model,
                        )
                        out = req.result(timeout=request_timeout_s)
                        out["kv"] = encode_kv(*req.kv)
                        out["last_token"] = int(req.tokens[0])
                        out["pos"] = int(req.prompt.size)
                        self._reply(200, out)
                    else:  # /inject
                        req = outer.engine.submit_with_kv(
                            kv_k, kv_v, last, pos, max_new,
                            temperature=temperature, eos_id=eos_id,
                            model=model,
                        )
                        self._reply(200,
                                    req.result(timeout=request_timeout_s))
                except ServingQueueFull as exc:
                    # Overload, not failure: the caller should back off
                    # (or the router should try another replica).
                    self._reply(429, {"error": str(exc)},
                                headers={"Retry-After": "1"})
                except ValueError as exc:  # truly the client's fault
                    self._reply(400, {"error": str(exc)})
                except TimeoutError as exc:
                    # Server capacity, not a malformed request: retryable.
                    self._reply(504, {"error": str(exc)})
                except RuntimeError as exc:  # engine shutdown/failure
                    self._reply(503, {"error": str(exc)})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> int:
        """Serve in a background thread; returns the bound port."""
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="serving-http",
            daemon=True,
        )
        self._thread.start()
        log.info("serving engine listening on :%d", self.port)
        return self.port

    def wait_shutdown(self, timeout: float | None = None) -> bool:
        """Block until ``POST /shutdown`` (or ``stop()``)."""
        return self._shutdown.wait(timeout)

    def stop(self) -> None:
        self._shutdown.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
