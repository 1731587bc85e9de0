"""The port's ops (tony_tpu_torch.ops) held against the JAX package's on the
CPU: RMSNorm and its gradients against the JAX reference and the Pallas
kernel in interpret mode, RoPE with positions, the cross-entropy loss, flash
attention and its lse against the Pallas forward in interpret mode and the
blockwise JAX path, and the flash backward (the plain twin of B2/B3, and
autograd through flash_attention and flash_attention_lse) against the Pallas
backward in interpret mode and jax.grad. Inputs come from a seeded numpy
generator and go to both packages as the same arrays. The CUDA kernels
themselves run only on the card (chip_smoke.py holds them against these
plain versions there)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops import flash_attention as jax_flash_attention
from tony_tpu.ops import softmax_cross_entropy as jax_softmax_cross_entropy
from tony_tpu.ops.attention import (
    _blockwise_attention_jax,
    _flash_attention_pallas,
    _flash_attention_pallas_bwd,
)
from tony_tpu.ops.attention import flash_attention_lse as jax_flash_lse
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
    softmax_cross_entropy,
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

    @pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
    def test_gradients_match_jax_grad(self, x_dtype):
        # fp32: the same autodiff of the same plain formula (1e-5). bf16 x
        # under an fp32 master w, as the model runs it: dx comes back in
        # bf16 (one ulp is 2**-8 relative), dw in fp32.
        rng = np.random.default_rng(8)
        x = rng.normal(size=(3, 5, 32)).astype(np.float32)
        w = (1.0 + 0.1 * rng.normal(size=(32,))).astype(np.float32)
        g = rng.normal(size=(3, 5, 32)).astype(np.float32)
        jdt = jnp.float32 if x_dtype == "float32" else jnp.bfloat16
        tdt = getattr(torch, x_dtype)

        def jloss(x, w):
            y = _rms_norm_jax(x, w, 1e-6).astype(jnp.float32)
            return jnp.sum(y * jnp.asarray(g))

        jdx, jdw = jax.grad(jloss, argnums=(0, 1))(
            jnp.asarray(x, jdt), jnp.asarray(w))
        tx = _t(x).to(tdt).requires_grad_()
        tw = _t(w).requires_grad_()
        (rms_norm(tx, tw).float() * _t(g)).sum().backward()
        assert tx.grad.dtype == tdt and tw.grad.dtype == torch.float32
        atol = 1e-5 if x_dtype == "float32" else 3e-2
        np.testing.assert_allclose(tx.grad.float().numpy(),
                                   np.asarray(jdx, np.float32), atol=atol,
                                   rtol=1e-2 if atol > 1e-5 else 1e-5)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                                   atol=atol, rtol=1e-2 if atol > 1e-5
                                   else 1e-5)


class TestCrossEntropy:
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_jax(self, masked):
        rng = np.random.default_rng(13)
        logits = rng.normal(size=(3, 7, 11)).astype(np.float32) * 3
        labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
        where = rng.random((3, 7)) < 0.6 if masked else None
        got = softmax_cross_entropy(
            _t(logits), _t(labels),
            where=None if where is None else _t(where))
        ref = jax_softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            where=None if where is None else jnp.asarray(where))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)

    def test_bf16_logits_upcast_and_all_masked_denominator(self):
        logits = torch.randn(2, 4, 9).to(torch.bfloat16)
        labels = torch.randint(0, 9, (2, 4))
        got = softmax_cross_entropy(logits, labels)
        assert got.dtype == torch.float32
        ref = jax_softmax_cross_entropy(
            jnp.asarray(logits.float().numpy(), jnp.bfloat16),
            jnp.asarray(labels.numpy()))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
        # Nothing selected: the max(sum, 1) denominator gives 0, not NaN.
        none = softmax_cross_entropy(logits, labels,
                                     where=torch.zeros(2, 4, dtype=torch.bool))
        assert float(none) == 0.0

    def test_extreme_logits_stable(self):
        logits = torch.tensor([[1e4, -1e4, 0.0]])
        out = softmax_cross_entropy(logits, torch.tensor([0]))
        assert np.isfinite(float(out))
        ref = jax_softmax_cross_entropy(jnp.asarray(logits.numpy()),
                                        jnp.asarray([0]))
        np.testing.assert_allclose(float(out), float(ref), atol=1e-6)


class TestRope:
    def test_frequencies_match(self):
        cos, sin = rope_frequencies(16, 64, theta=10000.0, device="cpu")
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
        cos, sin = rope_frequencies(d, 64, device="cpu")
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
        cos, sin = rope_frequencies(4, 4, device="cpu")
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


def _from_bhtd(x, b, h):
    """[B*H, T, D] (numpy or jax) -> torch [B, T, H, D]."""
    x = np.asarray(x)
    bh, t, d = x.shape
    return _t(x.reshape(b, h, t, d).transpose(0, 2, 1, 3))


def _to_bhtd(x):
    """torch [B, T, H, D] -> numpy [B*H, T, D]."""
    b, t, h, d = x.shape
    return x.detach().numpy().transpose(0, 2, 1, 3).reshape(b * h, t, d)


class TestFlashBackward:
    """The plain twin of B2/B3 (``_flash_bwd_plain``) and autograd through
    the port's flash attention, against the Pallas backward in interpret
    mode and jax.grad. All fp32: the formulas agree to summation order
    (3e-5 at these sizes; the JAX package's own backward tests allow
    3e-4 against its blockwise VJP)."""

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("t_q,t_k", [(64, 64), (40, 40), (24, 56)])
    def test_plain_bwd_matches_pallas_bwd_interpret(self, causal, t_q, t_k):
        # Exact (64) and partial (40) final 16-wide blocks, and t_q < t_k.
        rng = np.random.default_rng(0)
        b, h, d = 2, 2, 16
        q = rng.normal(size=(b * h, t_q, d)).astype(np.float32)
        k = rng.normal(size=(b * h, t_k, d)).astype(np.float32)
        v = rng.normal(size=(b * h, t_k, d)).astype(np.float32)
        g = rng.normal(size=(b * h, t_q, d)).astype(np.float32)
        scale = d ** -0.5
        out, lse = _flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            scale=scale, block_q=16, block_k=16, interpret=True,
            return_lse=True,
        )
        want = _flash_attention_pallas_bwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
            jnp.asarray(g), causal=causal, scale=scale, block_q=16,
            block_k=16, interpret=True,
        )
        got = t_attention._flash_bwd_plain(
            _from_bhtd(q, b, h), _from_bhtd(k, b, h), _from_bhtd(v, b, h),
            _from_bhtd(out, b, h), _t(np.asarray(lse)).reshape(b, h, t_q),
            _from_bhtd(g, b, h), causal=causal, scale=scale,
        )
        for x, ref in zip(got, want):
            assert x.dtype == torch.float32
            np.testing.assert_allclose(_to_bhtd(x), np.asarray(ref),
                                       atol=3e-5)

    @pytest.mark.parametrize("b,t_q,t_k,h,h_kv,d,causal", [
        (2, 24, 24, 4, 2, 8, True),
        (1, 19, 41, 4, 1, 16, False),
        (1, 40, 24, 2, 2, 8, True),
    ])
    def test_autograd_matches_jax_grad(self, b, t_q, t_k, h, h_kv, d,
                                       causal):
        # GQA K/V as they are, against jax.grad of the JAX entry (which
        # repeats K/V and lets autodiff sum the copies); t_q > t_k has
        # fully masked rows, whose dq must be exactly zero.
        rng = np.random.default_rng(21)
        q = rng.normal(size=(b, t_q, h, d)).astype(np.float32)
        k = rng.normal(size=(b, t_k, h_kv, d)).astype(np.float32)
        v = rng.normal(size=(b, t_k, h_kv, d)).astype(np.float32)
        g = rng.normal(size=(b, t_q, h, d)).astype(np.float32)

        def jloss(q, k, v):
            o = jax_flash_attention(q, k, v, causal=causal, force_jax=True,
                                    block_q=16, block_k=16)
            return jnp.sum(o * jnp.asarray(g))

        want = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
        (flash_attention(tq, tk, tv, causal=causal) * _t(g)).sum().backward()
        for x, ref in zip((tq, tk, tv), want):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref),
                                       atol=3e-5)
        if causal and t_q > t_k:
            assert torch.all(tq.grad[:, :t_q - t_k] == 0)

    @pytest.mark.parametrize("causal", [True, False])
    def test_lse_cotangent_matches_jax_interpret_vjp(self, causal):
        # A non-zero cotangent on lse (ring attention's merge weights)
        # shifts delta by g_lse; matched heads, as the JAX entry needs.
        rng = np.random.default_rng(22)
        b, t, h, d = 2, 40, 2, 16
        q, k, v, g = (rng.normal(size=(b, t, h, d)).astype(np.float32)
                      for _ in range(4))
        g_lse = rng.normal(size=(b, h, t)).astype(np.float32)

        def jloss(q, k, v):
            o, lse = jax_flash_lse(q, k, v, causal=causal, block_q=16,
                                   block_k=16, mode="interpret")
            return jnp.sum(o * jnp.asarray(g)) + jnp.sum(
                lse * jnp.asarray(g_lse))

        want = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
        out, lse = flash_attention_lse(tq, tk, tv, causal=causal)
        ((out * _t(g)).sum() + (lse * _t(g_lse)).sum()).backward()
        for x, ref in zip((tq, tk, tv), want):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref),
                                       atol=3e-5)

    def test_bf16_plain_bwd_rounds_like_the_reference(self):
        # bf16 inputs: gradients come back in the input dtypes, and agree
        # with the JAX interpret backward to bf16 rounding (2**-8 relative
        # at |grad| ~ 1, plus one flipped rounding of a p or ds term).
        rng = np.random.default_rng(23)
        b, t, h, d = 1, 40, 2, 16
        q, k, v, g = (rng.normal(size=(b * h, t, d)).astype(np.float32)
                      for _ in range(4))
        jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g)]
        out, lse = _flash_attention_pallas(
            *jb[:3], causal=True, scale=d ** -0.5, block_q=16, block_k=16,
            interpret=True, return_lse=True)
        want = _flash_attention_pallas_bwd(
            *jb[:3], out, lse, jb[3], causal=True, scale=d ** -0.5,
            block_q=16, block_k=16, interpret=True)

        def tb(x):
            return _from_bhtd(np.asarray(x, np.float32), b, h).to(
                torch.bfloat16)

        got = t_attention._flash_bwd_plain(
            tb(jb[0]), tb(jb[1]), tb(jb[2]), tb(out),
            _t(np.asarray(lse)).reshape(b, h, t), tb(jb[3]), causal=True,
            scale=d ** -0.5)
        for x, ref in zip(got, want):
            assert x.dtype == torch.bfloat16
            np.testing.assert_allclose(_to_bhtd(x.float()),
                                       np.asarray(ref, np.float32),
                                       atol=3e-2, rtol=2e-2)

    def test_cpu_backward_launches_no_kernel_and_wrapper_refuses_cpu(self):
        before = (t_attention.launches_dq, t_attention.launches_dkv)
        x = torch.randn(1, 4, 2, 64, requires_grad=True)
        flash_attention(x, x, x).sum().backward()
        assert (t_attention.launches_dq, t_attention.launches_dkv) == before
        lse = torch.zeros(1, 2, 4)
        with pytest.raises(ValueError, match="CUDA"):
            t_attention._flash_bwd_cuda(x, x, x, x, lse, x, causal=True,
                                        scale=0.125)
