"""The port's continuous-batching engine (tony_tpu_torch.serving) on the CPU.

The load-bearing pin is greedy parity, as in the JAX package's serving
tests: staggered mixed-length requests pushed through the slot engine —
chunked prefill, per-slot positions, the wpos parking contract, EOS
retirement, slot reuse — each equal token for token to a single-request
``generate`` of the port AND of the JAX package on the same weights."""

from __future__ import annotations

import json
import socket
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models import generate as jax_generate
from tony_tpu.models import init_params as jax_init_params
from tony_tpu_torch.interop import params_from_numpy
from tony_tpu_torch.models import TransformerConfig, generate
from tony_tpu_torch.serving import ServingEngine, ServingQueueFull
from tony_tpu_torch.serving import engine as t_engine
from tony_tpu_torch.serving.http import ServingServer, decode_kv, encode_kv
from tony_tpu_torch.serving.scheduler import _chunk_plan

torch.set_num_threads(1)

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=64, max_seq=96, dtype="float32", remat=False)

LENS = (3, 7, 12, 20, 5, 11, 17, 9, 6, 14)
BUDGETS = (6, 8, 9, 4, 12, 3, 8, 6, 10, 5)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig(**TINY)
    cfg = TransformerConfig(**TINY)
    jparams = jax_init_params(jax.random.key(0), jcfg)
    params = params_from_numpy(jax.device_get(jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def staggered(setup):
    """Prompts, budgets, EOS ids (half taken from the plain greedy
    continuation, so retirement before the budget is exercised) and the
    JAX references, computed once for both window settings."""
    jcfg, jparams, cfg, params = setup
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in LENS]
    eos_ids, refs = [], []
    for i, (p, n) in enumerate(zip(prompts, BUDGETS)):
        if i % 2 == 0 and n >= 4:
            # The EOS id comes from the port's greedy continuation (cheap);
            # the reference itself is JAX's.
            plain = generate(params, p[None], cfg, n, device="cpu")[0]
            eos = int(plain[n // 2])
            ref = jax_generate(jparams, jnp.asarray(p)[None], jcfg, n,
                               eos_id=eos)
            length = int(np.asarray(ref.lengths)[0])
            eos_ids.append(eos)
            refs.append(np.asarray(ref.tokens)[0][:length])
        else:
            eos_ids.append(None)
            refs.append(np.asarray(jax_generate(
                jparams, jnp.asarray(p)[None], jcfg, n))[0])
    return prompts, eos_ids, refs


@pytest.mark.parametrize("prompt_len,chunk,plan", [
    (3, 8, [(0, 3)]),
    (16, 8, [(0, 8), (8, 8)]),
    (20, 8, [(0, 8), (8, 8), (12, 8)]),
])
def test_chunk_plan(prompt_len, chunk, plan):
    assert _chunk_plan(prompt_len, chunk) == plan


class TestSubmitValidation:
    def test_rejects_bad_requests(self, setup):
        _, _, cfg, params = setup
        eng = ServingEngine(params, cfg, device="cpu", slots=2, max_len=32)
        with pytest.raises(ValueError, match="empty prompt"):
            eng.submit([], 4)
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.submit([1, 2], 0)
        with pytest.raises(ValueError, match="KV capacity"):
            eng.submit(list(range(30)), 8)
        with pytest.raises(ValueError, match="temperature"):
            eng.submit([1, 2], 4, temperature=-1.0)
        with pytest.raises(ValueError, match="unknown model"):
            eng.submit([1, 2], 4, model="nope")

    def test_queue_backpressure_sheds(self, setup):
        _, _, cfg, params = setup
        eng = ServingEngine(params, cfg, device="cpu", slots=1, max_queue=2)
        for _ in range(2):
            eng.submit([1, 2], 2)
        with pytest.raises(ServingQueueFull):
            eng.submit([1, 2], 2)

    def test_rejects_oversized_max_len_and_int8(self, setup):
        """An oversized max_len is refused; int8 is a KV mode the engine
        takes now, and an unknown mode is refused."""
        _, _, cfg, params = setup
        with pytest.raises(ValueError, match="max_seq"):
            ServingEngine(params, cfg, device="cpu", max_len=cfg.max_seq + 1)
        k, v = t_engine.init_slot_cache(cfg, 2, 16, kv_quant="int8",
                                        device="cpu")
        assert isinstance(k, t_engine.QuantizedKV)
        assert k.data.dtype == torch.int8 and v.scale.dtype == torch.float32
        eng = ServingEngine(params, cfg, device="cpu", slots=2, max_len=32,
                            kv_quant="int8")
        assert eng.stats()["kv_quant"] == "int8"
        with pytest.raises(ValueError, match="kv_quant must be one of"):
            ServingEngine(params, cfg, device="cpu", kv_quant="int4")
        with pytest.raises(ValueError, match="unknown kv_quant"):
            t_engine.init_slot_cache(cfg, 2, 16, kv_quant="int4",
                                     device="cpu")


class TestEngineParity:
    @pytest.mark.parametrize("window,prefill_batch", [(1, 1), (4, 3)])
    def test_staggered_mixed_length_requests_match_references(
        self, setup, staggered, window, prefill_batch
    ):
        _, _, cfg, params = setup
        prompts, eos_ids, refs = staggered
        eng = ServingEngine(params, cfg, device="cpu", slots=3,
                            prefill_chunk=5, decode_window=window,
                            prefill_batch=prefill_batch)
        assert eng.slots < len(prompts)  # slot reuse is forced
        with eng:  # the loop thread runs; submissions are staggered
            reqs = []
            for i, (p, n, e) in enumerate(zip(prompts, BUDGETS, eos_ids)):
                reqs.append(eng.submit(p, n, eos_id=e))
                if i % 3 == 2:
                    time.sleep(0.05)
            results = [r.result(timeout=120) for r in reqs]
        for p, n, e, ref, res in zip(prompts, BUDGETS, eos_ids, refs,
                                     results):
            # Equal to JAX's single-request generate ...
            np.testing.assert_array_equal(np.asarray(res["tokens"]), ref)
            # ... and to the port's.
            ours = generate(params, p[None], cfg, n, eos_id=e, device="cpu")
            if e is None:
                np.testing.assert_array_equal(ours[0].numpy(), ref)
            else:
                length = int(ours.lengths[0])
                np.testing.assert_array_equal(ours.tokens[0, :length].numpy(),
                                              ref)
        stats = eng.stats()
        assert stats["retired"] == len(prompts)
        assert stats["active_slots"] == 0 and stats["queue_depth"] == 0
        assert len(eng.ttft_ms_samples) == len(prompts)
        assert len(eng.inter_token_ms_samples) > 0
        assert eng.tokens_generated == sum(len(r["tokens"]) for r in results)

    def test_temperature_request_runs_and_differs_from_greedy(self, setup):
        _, _, cfg, params = setup
        prompt = np.arange(8, dtype=np.int32)
        eng = ServingEngine(params, cfg, device="cpu", slots=2, seed=5)
        hot = eng.submit(prompt, 16, temperature=1.5)
        cold = eng.submit(prompt, 16)
        for _ in range(500):
            if hot.done() and cold.done():
                break
            eng.step()
        greedy = generate(params, prompt[None], cfg, 16, device="cpu")[0]
        np.testing.assert_array_equal(
            np.asarray(cold.result(1)["tokens"]), greedy.numpy())
        assert not np.array_equal(np.asarray(hot.result(1)["tokens"]),
                                  greedy.numpy())

    def test_multiplexed_model_swaps_at_idle_boundary(self, setup):
        _, _, cfg, params = setup
        from tony_tpu_torch.models import init_params

        other = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
        prompt = np.arange(1, 8, dtype=np.int32)
        eng = ServingEngine(params, cfg, device="cpu", slots=2)
        eng.add_model("b", loader=lambda: other)
        with eng:
            got_b = eng.submit(prompt, 6, model="b").result(timeout=60)
            got_a = eng.submit(prompt, 6, model="default").result(timeout=60)
        for got, p in ((got_b, other), (got_a, params)):
            want = generate(p, prompt[None], cfg, 6, device="cpu")[0]
            np.testing.assert_array_equal(np.asarray(got["tokens"]),
                                          want.numpy())


class TestServingHTTP:
    def test_generate_healthz_shutdown(self, setup):
        jcfg, jparams, cfg, params = setup
        eng = ServingEngine(params, cfg, device="cpu", slots=2).start()
        server = ServingServer(eng, port=0, host="127.0.0.1")
        port = server.start()
        try:
            prompt = list(range(1, 7))
            body = json.dumps({"prompt": prompt,
                               "max_new_tokens": 5}).encode()
            with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/generate", data=body,
                headers={"Content-Type": "application/json"},
            ), timeout=120) as resp:
                out = json.loads(resp.read())
            want = np.asarray(jax_generate(
                jparams, jnp.asarray(prompt, jnp.int32)[None], jcfg, 5))[0]
            np.testing.assert_array_equal(np.asarray(out["tokens"]), want)
            assert out["length"] == 5 and out["wall_ms"] >= 0

            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10
            ) as resp:
                health = json.loads(resp.read())
            assert health["slots"] == 2 and health["retired"] == 1
            assert health["device"] == "cpu"

            bad = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate", data=b"{}",
            )
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(bad, timeout=10)
            assert err.value.code == 400

            with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/shutdown", data=b"",
            ), timeout=10) as resp:
                assert json.loads(resp.read())["ok"] is True
            assert server.wait_shutdown(timeout=10)
        finally:
            server.stop()
            eng.close()

    @pytest.mark.parametrize("path", ["/shutdown", "/nowhere", "/generate"])
    def test_post_reads_the_body_before_it_replies(self, path):
        """Every POST route reads its whole body before it replies, so the
        handler never closes a socket with request bytes unread (which
        resets the connection and can discard the reply): with the
        headers sent and the body held back, no reply comes; once the body
        is sent the reply comes whole, then a clean end of stream."""
        server = ServingServer(object(), port=0, host="127.0.0.1")
        port = server.start()
        body = b"{}"
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=10) as s:
                s.sendall(f"POST {path} HTTP/1.1\r\nHost: x\r\n"
                          f"Content-Length: {len(body)}\r\n\r\n".encode())
                s.settimeout(0.3)
                with pytest.raises(socket.timeout):
                    s.recv(1)
                s.settimeout(10)
                s.sendall(body)
                data = b""
                while chunk := s.recv(65536):
                    data += chunk
            head, _, reply = data.partition(b"\r\n\r\n")
            assert head.split(b" ")[1] in (b"200", b"404", b"400")
            assert "ok" in json.loads(reply) or "error" in json.loads(reply)
        finally:
            server.stop()

    def test_queue_full_is_429(self, setup):
        _, _, cfg, params = setup
        eng = ServingEngine(params, cfg, device="cpu", slots=1, max_queue=1)
        eng.submit([1, 2, 3], 4)  # never started: the queue stays full
        server = ServingServer(eng, port=0, host="127.0.0.1")
        port = server.start()
        try:
            body = json.dumps({"prompt": [1, 2], "max_new_tokens": 2})
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/generate", data=body.encode(),
                ), timeout=10)
            assert err.value.code == 429
            assert err.value.headers["Retry-After"] == "1"
        finally:
            server.stop()
            eng.close()

    def test_close_fails_pending_requests(self, setup):
        _, _, cfg, params = setup
        eng = ServingEngine(params, cfg, device="cpu", slots=1)
        req = eng.submit([1, 2, 3], 4)  # never stepped
        eng.close()
        with pytest.raises(RuntimeError, match="shut down"):
            req.result(timeout=1)

    def test_drain_completes_inflight_then_blocks_admission(self, setup):
        _, _, cfg, params = setup
        eng = ServingEngine(params, cfg, device="cpu", slots=2)
        with eng:
            reqs = [eng.submit(np.arange(1, 6, dtype=np.int32), 6)
                    for _ in range(4)]
            assert eng.drain(timeout=60.0)
            for r in reqs:
                assert r.result(1)["length"] == 6
            with pytest.raises(RuntimeError, match="draining"):
                eng.submit([1, 2], 2)


def test_prefill_only_then_submit_with_kv_round_trip(setup):
    jcfg, jparams, cfg, params = setup
    prompt = list(range(2, 11))
    total_new = 6
    want = np.asarray(jax_generate(
        jparams, jnp.asarray(prompt, jnp.int32)[None], jcfg, total_new))[0]

    rng = np.random.default_rng(3)
    kk = rng.standard_normal((2, 4, 2, 16)).astype(np.float32)
    vv = rng.standard_normal((2, 4, 2, 16)).astype(np.float32)
    rk, rv = decode_kv(encode_kv(kk, vv))
    np.testing.assert_array_equal(rk, kk)
    np.testing.assert_array_equal(rv, vv)

    pre = ServingEngine(params, cfg, device="cpu", slots=2).start()
    dec = ServingEngine(params, cfg, device="cpu", slots=2).start()
    try:
        req = pre.prefill_only(prompt, total_new)
        first = req.result(timeout=60)["tokens"]
        assert first == [int(want[0])]
        kv_k, kv_v = decode_kv(encode_kv(*req.kv))
        assert kv_k.shape == (cfg.n_layers, len(prompt), cfg.kv_heads,
                              cfg.head_dim)
        assert pre.stats()["active_slots"] == 0
        out = dec.submit_with_kv(kv_k, kv_v, first[0], len(prompt),
                                 total_new - 1).result(timeout=60)
        np.testing.assert_array_equal(
            np.asarray(first + out["tokens"]), want)
    finally:
        pre.close()
        dec.close()


def test_cache_rows_export_inject_round_trip(setup):
    _, _, cfg, _ = setup
    k, _ = t_engine.init_slot_cache(cfg, 3, 16, device="cpu")
    rows = torch.randn(cfg.n_layers, 5, cfg.kv_heads, cfg.head_dim)
    t_engine.cache_inject_rows(k, 1, rows.numpy())
    np.testing.assert_array_equal(
        t_engine.cache_export_rows(k, 1, 5).numpy(), rows.numpy())
    assert torch.all(k[:, 0] == 0) and torch.all(k[:, 2] == 0)
