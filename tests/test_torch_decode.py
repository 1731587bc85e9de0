"""The port's KV-cache decode (tony_tpu_torch.models) held against the JAX
package on the CPU: the same JAX-initialized weights go through
``interop.params_from_numpy``; ``advance`` logits agree at fp32 tolerance
and greedy ``generate`` agrees token for token, plain and with ``eos_id``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models import decode as jax_decode
from tony_tpu.models import init_params as jax_init_params
from tony_tpu_torch.interop import params_from_npz, params_from_numpy
from tony_tpu_torch.models import (
    DecodeSession,
    GenerateResult,
    TransformerConfig,
    advance,
    decode_weights,
    generate,
    init_cache,
    init_params,
)

torch.set_num_threads(1)

# The JAX serving tests' tiny shape, with GQA 4/2.
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=64, max_seq=96, dtype="float32", remat=False)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**TINY)
    tcfg = TransformerConfig(**TINY)
    jparams = jax_init_params(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _prompt(seed, b, t):
    return np.random.default_rng(seed).integers(0, 64, (b, t)).astype(
        np.int32)


def test_config_mirrors_jax_fields_and_errors():
    jcfg, tcfg = JaxConfig(), TransformerConfig()
    for field in ("vocab_size", "d_model", "n_layers", "n_heads", "head_dim",
                  "d_ff", "max_seq", "rope_theta", "n_kv_heads", "dtype"):
        assert getattr(jcfg, field) == getattr(tcfg, field), field
    assert TransformerConfig(dtype="bfloat16").compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="must divide"):
        TransformerConfig(n_heads=4, n_kv_heads=3).kv_heads


def test_init_params_layout_and_scales_match_jax():
    cfg = TransformerConfig(**TINY)
    gen = torch.Generator().manual_seed(1)
    ours = init_params(cfg, gen, device="cpu")
    ref = jax.device_get(jax_init_params(jax.random.key(1), JaxConfig(**TINY)))
    assert ours.keys() == ref.keys()
    assert ours["layers"].keys() == ref["layers"].keys()
    for key in ("embed", "final_norm", "unembed"):
        assert tuple(ours[key].shape) == ref[key].shape
    for key, val in ref["layers"].items():
        assert tuple(ours["layers"][key].shape) == val.shape, key
        assert ours["layers"][key].dtype == torch.float32
        np.testing.assert_allclose(float(ours["layers"][key].std()),
                                   float(np.std(val)), rtol=0.35)


class TestAdvance:
    def test_prefill_then_steps_logits_match_jax(self, models):
        jcfg, jparams, tcfg, tparams = models
        prompt = _prompt(0, 2, 9)
        jcache = jax_decode.init_cache(jcfg, 2, 16)
        tcache = init_cache(tcfg, 2, 16, device="cpu")
        jl, jcache = jax_decode.advance(jparams, jcache, jnp.asarray(prompt),
                                        jcfg, prefill=True)
        tl, tcache = advance(tparams, tcache, torch.from_numpy(prompt), tcfg,
                             prefill=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        for step in range(3):
            tok = np.full((2, 1), 5 + step, np.int32)
            jl, jcache = jax_decode.advance(jparams, jcache, jnp.asarray(tok),
                                            jcfg)
            tl, tcache = advance(tparams, tcache, torch.from_numpy(tok), tcfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                       rtol=1e-4)
        assert tcache["length"] == 12
        # The caches hold the same K/V rows as JAX's.
        np.testing.assert_allclose(tcache["k"][:, :, :12].numpy(),
                                   np.asarray(jcache["k"])[:, :, :12],
                                   atol=1e-4)

    def test_fused_layout_interop_matches_raw(self, models):
        jcfg, jparams, tcfg, tparams = models
        fused = params_from_numpy(
            jax.device_get(jax_decode.decode_weights(jparams, jcfg)), tcfg,
            "cpu")
        assert "qkv" in fused["layers"]
        ours = decode_weights(tparams, tcfg)
        for key, val in fused["layers"].items():
            np.testing.assert_array_equal(ours["layers"][key].numpy(),
                                          val.numpy())

    def test_capacity_and_prefill_checks(self, models):
        _, _, tcfg, tparams = models
        cache = init_cache(tcfg, 1, 8, device="cpu")
        with pytest.raises(ValueError, match="cannot fit"):
            advance(tparams, cache, torch.zeros(1, 9, dtype=torch.long), tcfg)
        _, cache = advance(tparams, cache, torch.zeros(1, 6, dtype=torch.long),
                           tcfg, prefill=True)
        with pytest.raises(ValueError, match="cannot take"):
            advance(tparams, cache, torch.zeros(1, 3, dtype=torch.long), tcfg)
        with pytest.raises(ValueError, match="empty cache"):
            advance(tparams, cache, torch.zeros(1, 1, dtype=torch.long), tcfg,
                    prefill=True)


class TestGenerate:
    @pytest.mark.parametrize("b,t0,n", [(2, 11, 12), (1, 1, 6), (3, 30, 9)])
    def test_greedy_tokens_equal_jax(self, models, b, t0, n):
        jcfg, jparams, tcfg, tparams = models
        prompt = _prompt(b * 100 + t0, b, t0)
        want = np.asarray(jax_decode.generate(jparams, jnp.asarray(prompt),
                                              jcfg, n))
        got = generate(tparams, prompt, tcfg, n, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_eos_id_tokens_and_lengths_equal_jax(self, models):
        jcfg, jparams, tcfg, tparams = models
        prompt = _prompt(21, 3, 7)
        plain = np.asarray(jax_decode.generate(jparams, jnp.asarray(prompt),
                                               jcfg, 10))
        eos = int(plain[0, 4])
        ref = jax_decode.generate(jparams, jnp.asarray(prompt), jcfg, 10,
                                  eos_id=eos)
        got = generate(tparams, prompt, tcfg, 10, eos_id=eos, device="cpu")
        assert isinstance(got, GenerateResult)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(ref.tokens))
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(ref.lengths))

    def test_legacy_eos_token_pads_after_first_eos(self, models):
        jcfg, jparams, tcfg, tparams = models
        prompt = _prompt(5, 2, 6)
        plain = np.asarray(jax_decode.generate(jparams, jnp.asarray(prompt),
                                               jcfg, 8))
        eos = int(plain[1, 2])
        want = np.asarray(jax_decode.generate(
            jparams, jnp.asarray(prompt), jcfg, 8, eos_token=eos,
            pad_token=63))
        got = generate(tparams, prompt, tcfg, 8, eos_token=eos, pad_token=63,
                       device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)

    def test_session_matches_module_generate_and_refresh(self, models):
        _, _, tcfg, tparams = models
        prompt = _prompt(9, 2, 5)
        session = DecodeSession(tparams, tcfg, device="cpu")
        want = generate(tparams, prompt, tcfg, 7, device="cpu")
        np.testing.assert_array_equal(session.generate(prompt, 7).numpy(),
                                      want.numpy())
        other = init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
        session.refresh(other)
        np.testing.assert_array_equal(
            session.generate(prompt, 7).numpy(),
            generate(other, prompt, tcfg, 7, device="cpu").numpy())

    def test_sampling_contract(self, models):
        _, _, tcfg, tparams = models
        prompt = _prompt(2, 2, 6)
        greedy = generate(tparams, prompt, tcfg, 12, device="cpu")

        def sample(seed, **kw):
            return generate(tparams, prompt, tcfg, 12, temperature=1.5,
                            generator=torch.Generator().manual_seed(seed),
                            device="cpu", **kw)

        np.testing.assert_array_equal(sample(4).numpy(), sample(4).numpy())
        assert not np.array_equal(sample(4).numpy(), greedy.numpy())
        # top_k=1 and a vanishing top_p both collapse to the argmax.
        np.testing.assert_array_equal(sample(4, top_k=1).numpy(),
                                      greedy.numpy())
        np.testing.assert_array_equal(sample(4, top_p=1e-6).numpy(),
                                      greedy.numpy())
        top3 = sample(8, top_k=3)
        assert top3.shape == greedy.shape

    def test_argument_errors(self, models):
        _, _, tcfg, tparams = models
        prompt = _prompt(1, 1, 4)
        with pytest.raises(ValueError, match="torch.Generator"):
            generate(tparams, prompt, tcfg, 4, temperature=1.0, device="cpu")
        with pytest.raises(ValueError, match="greedy"):
            generate(tparams, prompt, tcfg, 4, top_k=2, device="cpu")
        with pytest.raises(ValueError, match="max_seq"):
            generate(tparams, prompt, tcfg, 95, device="cpu")
        with pytest.raises(ValueError, match="different contracts"):
            generate(tparams, prompt, tcfg, 4, eos_id=1, eos_token=1,
                     device="cpu")


def test_npz_weights_roundtrip(models, tmp_path):
    jcfg, jparams, tcfg, tparams = models
    tree = jax.device_get(jparams)
    flat = {k: np.asarray(v) for k, v in tree.items() if k != "layers"}
    flat.update({f"layers/{k}": np.asarray(v)
                 for k, v in tree["layers"].items()})
    path = tmp_path / "params.npz"
    np.savez(path, **flat)
    loaded = params_from_npz(path, tcfg, "cpu")
    prompt = _prompt(3, 1, 5)
    np.testing.assert_array_equal(
        generate(loaded, prompt, tcfg, 5, device="cpu").numpy(),
        generate(tparams, prompt, tcfg, 5, device="cpu").numpy())


def test_interop_rejects_wrong_shapes(models):
    jcfg, jparams, _, _ = models
    other = TransformerConfig(**{**TINY, "d_ff": 32})
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(jax.device_get(jparams), other, "cpu")


def test_moe_and_mesh_wait_for_later_slices(models):
    _, _, tcfg, tparams = models
    moe = TransformerConfig(**{**TINY, "n_experts": 2})
    with pytest.raises(NotImplementedError):
        DecodeSession(tparams, moe, device="cpu")
    with pytest.raises(NotImplementedError):
        DecodeSession(tparams, tcfg, device="cpu", mesh=object())
