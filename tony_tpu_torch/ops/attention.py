"""Flash attention forward: online-softmax attention that never materializes
the [T_q, T_k] score matrix.

On the card it is the hand-written CUDA kernel ``csrc/flash_fwd.cu``; for
tensors on the CPU it is ``_flash_attention_plain``, a blockwise loop over
key blocks with the same math as the JAX package's blockwise reference.
Public layout is [batch, seq, heads, head_dim]. K/V may have fewer heads
than Q (GQA: query head h uses KV head h // (H / H_kv)), and a different
length: when t_q != t_k the queries sit at the END of the keys (query row i
has position t_k - t_q + i), so decode attends to the full prefix. Fully
masked rows give O = 0 and lse = log(1e-30).

Forward only in this slice: on the card an input that requires grad raises
(the backward kernels come with training).
"""

from __future__ import annotations

import torch

from tony_tpu_torch import kernels

NEG_INF = -1e30

# Kernel launches made by _flash_attention_cuda (read by chip_smoke.py to
# show the generate prefill went through the kernel).
launches = 0


def _plain_block_k(t_q: int, t_k: int) -> int:
    """Key-block size of the plain path: 512 up to 2048 positions, else
    1024, clamped to the key length (the JAX package's default blocks)."""
    return min(512 if max(t_q, t_k) <= 2048 else 1024, max(t_k, 1))


def _flash_attention_plain(q, k, v, *, causal, scale, block_k,
                           return_lse=False):
    """Blockwise online softmax over key blocks. q,k,v: [BH, T, D]. With
    ``return_lse`` also returns the per-row log-sum-exp [BH, T_q] f32."""
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    block_k = min(block_k, t_k)
    n_blocks = -(-t_k // block_k)
    pad = n_blocks * block_k - t_k
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qf = q.float() * scale
    q_pos = (t_k - t_q) + torch.arange(t_q, device=q.device)
    o = torch.zeros(bh, t_q, d, dtype=torch.float32, device=q.device)
    m = torch.full((bh, t_q), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(bh, t_q, dtype=torch.float32, device=q.device)
    for ki in range(n_blocks):
        k_blk = k[:, ki * block_k:(ki + 1) * block_k].float()
        v_blk = v[:, ki * block_k:(ki + 1) * block_k].float()
        s = torch.einsum("btd,bsd->bts", qf, k_blk)
        k_pos = ki * block_k + torch.arange(block_k, device=q.device)
        if pad:
            s = s.masked_fill(~(k_pos < t_k)[None, None, :], NEG_INF)
        if causal:
            visible = q_pos[:, None] >= k_pos[None, :]
            s = s.masked_fill(~visible[None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(s <= NEG_INF / 2, 0.0, p)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bts,bsd->btd", p, v_blk)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = (o / l[..., None]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(m <= NEG_INF / 2, 0.0, m) + torch.log(l)
    return out, lse


def _kernel_readable(x: torch.Tensor) -> bool:
    """The kernel reads 16 bytes at a time along the last dim: it needs
    that dim contiguous, 16-byte aligned rows and an aligned base."""
    vec = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % vec == 0
                    for st, n in zip(x.stride()[:-1], x.shape[:-1]) if n > 1))


def _flash_attention_cuda(q, k, v, *, causal, scale):
    """Launch the kernel. q [B, Tq, H, D], k/v [B, Tk, Hkv, D] (strided
    views allowed; last dim contiguous) -> (out [B, Tq, H, D] in q's
    dtype, lse [B, H, Tq] f32)."""
    global launches
    if not (q.device.type == "cuda" and k.device == q.device
            and v.device == q.device):
        raise ValueError("flash kernel needs q, k, v on one CUDA device")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError("flash_attention on CUDA is forward-only "
                                  "in this slice of the port")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash kernel needs one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    code = kernels.dtype_code(q)
    b, t_q, h, d = q.shape
    _, t_k, h_kv, _ = k.shape
    if d not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash kernel shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _kernel_readable(x):
            raise ValueError(f"flash kernel needs {name} with a contiguous, "
                             f"16-byte aligned last dim, got strides "
                             f"{x.stride()}")
    out = torch.empty(b, t_q, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, t_q, dtype=torch.float32, device=q.device)
    if b * h * t_q == 0:
        return out, lse
    err = kernels.function("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        b, h, h_kv, t_q, t_k, d, float(scale), int(bool(causal)), code,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check_launch("flash_fwd", err)
    launches += 1
    return out, lse


def _flash_plain_bthd(q, k, v, *, causal, scale, return_lse):
    b, t_q, h, d = q.shape
    h_kv = k.shape[2]
    if h_kv != h:
        k = k.repeat_interleave(h // h_kv, dim=2)
        v = v.repeat_interleave(h // h_kv, dim=2)
    t_k = k.shape[1]
    qf = q.transpose(1, 2).reshape(b * h, t_q, d)
    kf = k.transpose(1, 2).reshape(b * h, t_k, d)
    vf = v.transpose(1, 2).reshape(b * h, t_k, d)
    res = _flash_attention_plain(qf, kf, vf, causal=causal, scale=scale,
                                 block_k=_plain_block_k(t_q, t_k),
                                 return_lse=return_lse)
    out, lse = res if return_lse else (res, None)
    out = out.reshape(b, h, t_q, d).transpose(1, 2)
    return out, (None if lse is None else lse.reshape(b, h, t_q))


def _flash(q, k, v, *, causal, scale, return_lse):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    h, h_kv = q.shape[2], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if q.device.type == "cuda":
        return _flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    return _flash_plain_bthd(q, k, v, causal=causal, scale=scale,
                             return_lse=return_lse)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Exact attention. q [B, Tq, H, D], k/v [B, Tk, Hkv, D] with
    H % Hkv == 0 -> [B, Tq, H, D] in q's dtype."""
    return _flash(q, k, v, causal=causal, scale=scale, return_lse=False)[0]


def flash_attention_lse(q, k, v, *, causal: bool,
                        scale: float | None = None):
    """Flash attention returning ``(out, lse)``: out [B, Tq, H, D] (q's
    dtype), lse [B, H, Tq] f32, the log-sum-exp of the scaled scores per
    query row (fully masked rows: log(1e-30))."""
    return _flash(q, k, v, causal=causal, scale=scale, return_lse=True)
