"""The port's ops (tony_tpu_torch.ops) held against the JAX package's on the
CPU: RMSNorm against the JAX reference and the Pallas kernel in interpret
mode, RoPE with positions, flash attention and its lse against the Pallas
forward in interpret mode and the blockwise JAX path. Inputs come from a
seeded numpy generator and go to both packages as the same arrays. The CUDA
kernels themselves run only on the card (chip_smoke.py holds them against
these plain versions there)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops.attention import (
    _blockwise_attention_jax,
    _flash_attention_pallas,
)
from tony_tpu.ops.norms import _rms_norm_jax, _rms_norm_pallas
from tony_tpu.ops.rope import apply_rope as jax_apply_rope
from tony_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from tony_tpu_torch.ops import (
    apply_rope,
    cached_rope_frequencies,
    flash_attention,
    flash_attention_lse,
    rms_norm,
    rope_frequencies,
)
from tony_tpu_torch.ops import attention as t_attention
from tony_tpu_torch.ops import norms as t_norms

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


class TestRmsNorm:
    @pytest.mark.parametrize("shape", [(300, 32), (2, 5, 64), (1, 8)])
    def test_fp32_matches_jax_and_pallas_interpret(self, shape):
        rng = np.random.default_rng(6)
        x = rng.normal(size=shape).astype(np.float32)
        w = rng.normal(size=shape[-1:]).astype(np.float32)
        got = rms_norm(_t(x), _t(w)).numpy()
        ref = np.asarray(_rms_norm_jax(jnp.asarray(x), jnp.asarray(w), 1e-6))
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
        x2 = x.reshape(-1, shape[-1])
        pallas = np.asarray(_rms_norm_pallas(
            jnp.asarray(x2), jnp.asarray(w), 1e-6, block_rows=128,
            interpret=True,
        ))
        np.testing.assert_allclose(got.reshape(x2.shape), pallas,
                                   atol=1e-5, rtol=1e-5)

    def test_bf16_output_dtype_and_value(self):
        rng = np.random.default_rng(7)
        x = rng.normal(size=(16, 64)).astype(np.float32)
        w = rng.normal(size=(64,)).astype(np.float32)
        got = rms_norm(_t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        ref = _rms_norm_jax(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(w, jnp.bfloat16), 1e-6)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), atol=2e-2)

    def test_weight_is_cast_to_fp32_inside(self):
        # bf16 x with an fp32 weight: the output keeps x's dtype.
        x = torch.randn(4, 32, dtype=torch.bfloat16)
        w = torch.rand(32, dtype=torch.float32) + 0.5
        assert rms_norm(x, w).dtype == torch.bfloat16

    def test_cpu_path_launches_no_kernel(self):
        before = t_norms.launches
        rms_norm(torch.randn(3, 16), torch.ones(16))
        assert t_norms.launches == before

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            t_norms._rms_norm_cuda(torch.randn(2, 16), torch.ones(16), 1e-6)


class TestRope:
    def test_frequencies_match(self):
        cos, sin = rope_frequencies(16, 64, theta=10000.0)
        jcos, jsin = jax_rope_frequencies(16, 64, theta=10000.0)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)

    def test_cached_frequencies_are_built_once(self):
        cos, sin = cached_rope_frequencies(16, 64, theta=500.0, device="cpu")
        again = cached_rope_frequencies(16, 64, theta=500.0,
                                        device=torch.device("cpu"))
        assert again[0] is cos and again[1] is sin
        jcos, jsin = jax_rope_frequencies(16, 64, theta=500.0)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)

    @pytest.mark.parametrize("pos_kind", ["none", "1d", "2d"])
    def test_apply_rope_with_positions(self, pos_kind):
        rng = np.random.default_rng(3)
        b, t, h, d = 2, 7, 3, 16
        x = rng.normal(size=(b, t, h, d)).astype(np.float32)
        positions = {
            "none": None,
            "1d": np.arange(5, 5 + t),
            "2d": rng.integers(0, 60, (b, t)),
        }[pos_kind]
        cos, sin = rope_frequencies(d, 64)
        jcos, jsin = jax_rope_frequencies(d, 64)
        got = apply_rope(
            _t(x), cos, sin,
            positions=None if positions is None else _t(positions),
        ).numpy()
        ref = jax_apply_rope(
            jnp.asarray(x), jcos, jsin,
            positions=None if positions is None else jnp.asarray(positions),
        )
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)

    def test_interleaved_pairs_not_half_split(self):
        # Position 1 rotates the pair (x0, x1) — interleaved layout.
        cos, sin = rope_frequencies(4, 4)
        x = torch.tensor([1.0, 0.0, 0.0, 0.0]).reshape(1, 1, 1, 4)
        out = apply_rope(x, cos, sin, positions=torch.tensor([1]))
        np.testing.assert_allclose(
            out.reshape(-1).numpy(),
            [np.cos(1.0), np.sin(1.0), 0.0, 0.0], atol=1e-6,
        )


def _bhtd(x):
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


# (b, t_q, t_k, h, h_kv, d, causal): self-attention, decode convention
# (t_q < t_k), tail padding past the 16-wide Pallas blocks, GQA, and
# t_q > t_k causal (the first t_q - t_k rows see no key at all).
FLASH_CASES = [
    (2, 24, 24, 4, 4, 8, True),
    (2, 24, 24, 4, 4, 8, False),
    (1, 5, 37, 4, 2, 8, True),
    (2, 19, 41, 4, 1, 16, False),
    (1, 40, 24, 2, 2, 8, True),
]


class TestFlashAttention:
    @pytest.mark.parametrize("b,t_q,t_k,h,h_kv,d,causal", FLASH_CASES)
    def test_out_and_lse_match_pallas_interpret_and_blockwise(
        self, b, t_q, t_k, h, h_kv, d, causal
    ):
        rng = np.random.default_rng(11)
        q = rng.normal(size=(b, t_q, h, d)).astype(np.float32)
        k = rng.normal(size=(b, t_k, h_kv, d)).astype(np.float32)
        v = rng.normal(size=(b, t_k, h_kv, d)).astype(np.float32)
        out, lse = flash_attention_lse(_t(q), _t(k), _t(v), causal=causal)
        out_only = flash_attention(_t(q), _t(k), _t(v), causal=causal)
        np.testing.assert_array_equal(out.numpy(), out_only.numpy())

        group = h // h_kv
        kr = np.repeat(k, group, axis=2)
        vr = np.repeat(v, group, axis=2)
        scale = d ** -0.5
        p_out, p_lse = _flash_attention_pallas(
            _bhtd(q), _bhtd(kr), _bhtd(vr), causal=causal, scale=scale,
            block_q=16, block_k=16, interpret=True, return_lse=True,
        )
        b_out, b_lse = _blockwise_attention_jax(
            _bhtd(q), _bhtd(kr), _bhtd(vr), causal=causal, scale=scale,
            block_k=16, return_lse=True,
        )
        got = out.numpy().transpose(0, 2, 1, 3).reshape(b * h, t_q, d)
        got_lse = lse.numpy().reshape(b * h, t_q)
        for ref_out, ref_lse in ((p_out, p_lse), (b_out, b_lse)):
            np.testing.assert_allclose(got, np.asarray(ref_out), atol=2e-5)
            np.testing.assert_allclose(got_lse, np.asarray(ref_lse),
                                       atol=2e-5)

    def test_fully_masked_rows_give_zero_and_log_floor(self):
        rng = np.random.default_rng(4)
        q = _t(rng.normal(size=(1, 9, 2, 8)).astype(np.float32))
        k = _t(rng.normal(size=(1, 4, 2, 8)).astype(np.float32))
        out, lse = flash_attention_lse(q, k, k, causal=True)
        assert torch.all(out[:, :5] == 0)
        np.testing.assert_allclose(lse[:, :, :5].numpy(), np.log(1e-30),
                                   rtol=1e-6)
        assert torch.all(out[:, 5:].abs().sum(-1) > 0)

    @pytest.mark.parametrize("causal", [True, False])
    def test_plain_blockwise_tail_padding_matches_jax(self, causal):
        # Key length 45 over 16-wide blocks: the last block is padded.
        rng = np.random.default_rng(12)
        q = rng.normal(size=(3, 20, 8)).astype(np.float32)
        k = rng.normal(size=(3, 45, 8)).astype(np.float32)
        v = rng.normal(size=(3, 45, 8)).astype(np.float32)
        out, lse = t_attention._flash_attention_plain(
            _t(q), _t(k), _t(v), causal=causal, scale=0.3, block_k=16,
            return_lse=True,
        )
        ref, ref_lse = _blockwise_attention_jax(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            scale=0.3, block_k=16, return_lse=True,
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                                   atol=2e-5)

    def test_gqa_head_mapping_is_repeat_order(self):
        # Query head h reads KV head h // (H / H_kv), as jnp.repeat lays
        # the heads out — not h % H_kv.
        rng = np.random.default_rng(5)
        q = _t(rng.normal(size=(1, 6, 4, 8)).astype(np.float32))
        k = _t(rng.normal(size=(1, 6, 2, 8)).astype(np.float32))
        v = _t(rng.normal(size=(1, 6, 2, 8)).astype(np.float32))
        out = flash_attention(q, k, v, causal=True)
        for h in range(4):
            one = flash_attention(q[:, :, h:h + 1], k[:, :, h // 2:h // 2 + 1],
                                  v[:, :, h // 2:h // 2 + 1], causal=True)
            np.testing.assert_allclose(out[:, :, h:h + 1].numpy(),
                                       one.numpy(), atol=1e-6)

    def test_rejects_indivisible_heads(self):
        q = torch.zeros(1, 2, 3, 8)
        k = torch.zeros(1, 2, 2, 8)
        with pytest.raises(ValueError, match="multiple"):
            flash_attention(q, k, k)

    def test_cpu_path_launches_no_kernel_and_wrapper_refuses_cpu(self):
        before = t_attention.launches
        x = torch.randn(1, 4, 2, 64)
        flash_attention(x, x, x)
        assert t_attention.launches == before
        with pytest.raises(ValueError, match="CUDA"):
            t_attention._flash_attention_cuda(x, x, x, causal=True,
                                              scale=0.125)
