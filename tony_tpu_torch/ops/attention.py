"""Flash attention: online-softmax attention that never materializes the
[T_q, T_k] score matrix, forward and backward.

On the card the forward is the hand-written CUDA kernel ``csrc/flash_fwd.cu``
(B1) and the backward the two passes of ``csrc/flash_bwd.cu`` (B2: dq, B3:
dk/dv), rebuilt from the forward's saved lse. For tensors on the CPU they are
``_flash_attention_plain`` and ``_flash_bwd_plain``, blockwise loops over key
blocks with the same math. ``_FlashFunction`` joins them for autograd, as the
JAX package's ``_flash_core``/``_flash_lse_core`` custom VJPs do, and takes
the cotangent of lse too (``flash_attention_lse``).

Public layout is [batch, seq, heads, head_dim]. K/V may have fewer heads
than Q (GQA: query head h uses KV head h // (H / H_kv)), and a different
length: when t_q != t_k the queries sit at the END of the keys (query row i
has position t_k - t_q + i), so decode attends to the full prefix. Fully
masked rows give O = 0 and lse = log(1e-30), and zero gradients.

The tile knob: JAX's ``(block_q, block_k)`` name the query rows a block of
B1 and of B2 holds and the keys a block of B3 holds, among the bf16
instances the kernels are built with (``TILES``: one each, the shipped
one). ``None`` takes that instance; a tuned pin (``set_tuned_blocks``,
which the autotuner's records drive) fills what the caller left ``None``
where the call's head_dim has it; an explicit value that no built
instance has raises ``ValueError``. The fp32 kernels and the plain twins
have one instance: their results do not depend on the knob beyond the
plain twins' key-block rounding.
"""

from __future__ import annotations

import ctypes

import torch

from tony_tpu_torch import kernels

NEG_INF = -1e30

# Kernel launches made by _flash_attention_cuda (B1) and _flash_bwd_cuda (B2,
# B3), read by chip_smoke.py to show a path went through the kernels.
launches = 0
launches_dq = 0
launches_dkv = 0

# The bf16 instance each kernel is built with, by head_dim, in rows (B1,
# B2) or keys (B3) a block: csrc/flash_fwd.cu's FwdBf16<D>::kM,
# csrc/flash_bwd.cu's DqBf16<D>::kM and DkvBf16<D>::kN. These are the
# values the tile knob may name; each kernel has one instance.
TILES = {
    "flash_fwd": {64: (192,), 128: (128,)},
    "flash_bwd_dq": {64: (192,), 128: (192,)},
    "flash_bwd_dkv": {64: (192,), 128: (128,)},
}


def built_blocks(head_dim: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The (block_q, block_k) values a call at ``head_dim`` may name:
    block_q the query rows both B1 and B2 have an instance of, block_k
    B3's keys."""
    fwd = TILES["flash_fwd"].get(head_dim, ())
    dq = TILES["flash_bwd_dq"].get(head_dim, ())
    return (tuple(sorted(set(fwd) & set(dq))),
            tuple(sorted(TILES["flash_bwd_dkv"].get(head_dim, ()))))


# The autotuner's pin (parallel/autotune.py): a record's winning
# (block_q, block_k), applied process-wide where a call leaves its argument
# None and the value is built at the call's head_dim. None: no pin.
_TUNED_BLOCKS: "tuple[int | None, int | None]" = (None, None)


def set_tuned_blocks(block_q: int | None = None,
                     block_k: int | None = None) -> None:
    global _TUNED_BLOCKS
    _TUNED_BLOCKS = (block_q, block_k)


def clear_tuned_blocks() -> None:
    set_tuned_blocks(None, None)


def tuned_blocks() -> "tuple[int | None, int | None]":
    return _TUNED_BLOCKS


def _default_blocks(head_dim: int, block_q: int | None,
                    block_k: int | None):
    """The (block_q, block_k) a call at ``head_dim`` runs: an explicit
    argument, else the tuned pin where an instance at this head_dim has it
    (a pin another head_dim's instance has is ignored here, as the JAX
    package clamps its pin to the sequence), else None (each kernel's
    shipped instance). An explicit value that no built instance has at
    this head_dim raises ValueError naming the built ones: there is no
    rounding to a near tile."""
    built_q, built_k = built_blocks(head_dim)
    for name, value, built in (("block_q", block_q, built_q),
                               ("block_k", block_k, built_k)):
        if value is not None and value not in built:
            raise ValueError(f"{name} {value} has no flash instance at "
                             f"head_dim {head_dim} (built: {list(built)})")
    tuned_q, tuned_k = _TUNED_BLOCKS
    if block_q is None and tuned_q in built_q:
        block_q = tuned_q
    if block_k is None and tuned_k in built_k:
        block_k = tuned_k
    return block_q, block_k


def _tile(entry: str, code: int, head_dim: int, block) -> int:
    """The C entry point's tile argument: 0 (the built instance) for None
    and for the fp32 kernels, else ``block``, which must be the entry
    point's bf16 instance at ``head_dim``."""
    if block is None or code == kernels.DTYPE_CODES["torch.float32"]:
        return 0
    if block not in TILES[entry].get(head_dim, ()):
        raise ValueError(f"{entry} has no {block} instance at head_dim "
                         f"{head_dim} (built: "
                         f"{list(TILES[entry].get(head_dim, ()))})")
    return int(block)


def _plain_block_k(t_q: int, t_k: int) -> int:
    """Key-block size of the plain path: 512 up to 2048 positions, else
    1024, clamped to the key length (the JAX package's default blocks)."""
    return min(512 if max(t_q, t_k) <= 2048 else 1024, max(t_k, 1))


def _flash_attention_plain(q, k, v, *, causal, scale, block_k):
    """Blockwise online softmax over key blocks. q,k,v: [BH, T, D] ->
    (out [BH, T_q, D] in q's dtype, the per-row log-sum-exp [BH, T_q] f32)."""
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
    lse = torch.where(m <= NEG_INF / 2, 0.0, m) + torch.log(l)
    return out, lse


def _kernel_readable(x: torch.Tensor) -> bool:
    """The kernel reads 16 bytes at a time along the last dim: it needs
    that dim contiguous, 16-byte aligned rows and an aligned base."""
    vec = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % vec == 0
                    for st, n in zip(x.stride()[:-1], x.shape[:-1]) if n > 1))


def _check_kernel_inputs(q, k, v) -> int:
    """The checks every flash kernel wrapper makes; returns the dtype code."""
    if not (q.device.type == "cuda" and k.device == q.device
            and v.device == q.device):
        raise ValueError("flash kernel needs q, k, v on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash kernel needs one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    code = kernels.dtype_code(q)
    b, _, h, d = q.shape
    h_kv = k.shape[2]
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
    return code


def _flash_attention_cuda(q, k, v, *, causal, scale, block_q=None):
    """Launch the kernel. q [B, Tq, H, D], k/v [B, Tk, Hkv, D] (strided
    views allowed; last dim contiguous) -> (out [B, Tq, H, D] in q's
    dtype, lse [B, H, Tq] f32). ``block_q`` picks the bf16 instance of
    that many query rows (None: the shipped one)."""
    global launches
    code = _check_kernel_inputs(q, k, v)
    b, t_q, h, d = q.shape
    tile = _tile("flash_fwd", code, d, block_q)
    _, t_k, h_kv, _ = k.shape
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
        tile, torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check_launch("flash_fwd", err)
    launches += 1
    return out, lse


def _flash_plain_bthd(q, k, v, *, causal, scale, block_q=None, block_k=None):
    """The plain forward in the public layout: (out [B, Tq, H, D],
    lse [B, H, Tq] f32). ``block_k`` is its loop's key block (None: the
    JAX package's default); ``block_q`` changes nothing (every query row
    is in one block)."""
    b, t_q, h, d = q.shape
    h_kv = k.shape[2]
    if h_kv != h:
        k = k.repeat_interleave(h // h_kv, dim=2)
        v = v.repeat_interleave(h // h_kv, dim=2)
    t_k = k.shape[1]
    qf = q.transpose(1, 2).reshape(b * h, t_q, d)
    kf = k.transpose(1, 2).reshape(b * h, t_k, d)
    vf = v.transpose(1, 2).reshape(b * h, t_k, d)
    out, lse = _flash_attention_plain(
        qf, kf, vf, causal=causal, scale=scale,
        block_k=block_k or _plain_block_k(t_q, t_k))
    return out.reshape(b, h, t_q, d).transpose(1, 2), lse.reshape(b, h, t_q)


def _bwd_delta(out, do, g_lse):
    """delta = rowsum(dO * O) - g_lse in fp32, [B, H, Tq], for the plain
    backward (on the card B2 computes it in its prologue)."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def _flash_bwd_plain(q, k, v, out, lse, do, *, causal, scale, g_lse=None,
                     block_q=None, block_k=None):
    """Blockwise backward over key blocks, the same Dao formulas as B2 and
    B3 from the saved lse: p = exp(s - lse), dp = dO V^T,
    ds = p (dp - delta); dq = sum ds K scale, dk = ds^T Q scale,
    dv = p^T dO, with ds rounded to K's (dq) and Q's (dk) dtype and p to
    dO's (dv) before the products, fp32 sums. q/out/do [B, Tq, H, D],
    k/v [B, Tk, Hkv, D], lse [B, H, Tq] -> (dq, dk, dv) in q's, k's and
    v's layout and dtype; GQA dk/dv are summed over each KV head's group.
    ``block_k`` is the loop's key block (None: the JAX package's default);
    ``block_q`` changes nothing."""
    b, t_q, h, d = q.shape
    t_k, h_kv = k.shape[1], k.shape[2]
    group = h // h_kv

    def heads(x):  # [B, T, H', D] -> [B*H, T, D] f32, KV heads repeated
        if x.shape[2] != h:
            x = x.repeat_interleave(group, dim=2)
        return x.transpose(1, 2).reshape(b * h, x.shape[1], d).float()

    qf, kf, vf, dof = heads(q), heads(k), heads(v), heads(do)
    lse_f = lse.reshape(b * h, t_q).float()
    delta = _bwd_delta(out, do, g_lse).reshape(b * h, t_q)
    q_pos = (t_k - t_q) + torch.arange(t_q, device=q.device)
    block_k = min(block_k or _plain_block_k(t_q, t_k), max(t_k, 1))
    dq = torch.zeros(b * h, t_q, d, dtype=torch.float32, device=q.device)
    dk = torch.empty(b * h, t_k, d, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for k0 in range(0, t_k, block_k):
        kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        s = torch.einsum("btd,bsd->bts", qf, kb) * scale
        p = torch.exp(s - lse_f[..., None])
        if causal:
            k_pos = k0 + torch.arange(kb.shape[1], device=q.device)
            p = torch.where(q_pos[:, None] >= k_pos[None], p, 0.0)
        dp = torch.einsum("btd,bsd->bts", dof, vb)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bts,bsd->btd", ds.to(k.dtype).float(), kb) * scale
        dv[:, k0:k0 + block_k] = torch.einsum(
            "bts,btd->bsd", p.to(do.dtype).float(), dof)
        dk[:, k0:k0 + block_k] = torch.einsum(
            "bts,btd->bsd", ds.to(q.dtype).float(), qf) * scale

    def back(x, t, n_heads, dtype):  # [B*H, T, D] -> [B, T, n_heads, D]
        x = x.reshape(b, h, t, d).transpose(1, 2)
        if n_heads != h:
            x = x.reshape(b, t, n_heads, group, d).sum(3)
        return x.to(dtype)

    return (back(dq, t_q, h, q.dtype), back(dk, t_k, h_kv, k.dtype),
            back(dv, t_k, h_kv, v.dtype))


def _flash_bwd_cuda(q, k, v, out, lse, do, *, causal, scale, g_lse=None,
                    block_q=None, block_k=None):
    """Launch B2 and B3: the gradients of ``_flash_attention_cuda``'s
    (out, lse) for cotangents ``do`` (and ``g_lse``, default none).
    Same inputs and checks as the forward; ``do`` and ``out`` are made
    contiguous when the kernels cannot read them as they are. B2 computes
    delta = rowsum(dO * O) - g_lse for its rows and writes it for B3, which
    runs after it on the same stream. ``block_q`` picks B2's bf16 instance
    of that many query rows, ``block_k`` B3's of that many keys (None: the
    shipped ones). Returns (dq [B, Tq, H, D], dk, dv [B, Tk, Hkv, D]) in
    the input dtype."""
    global launches_dq, launches_dkv
    code = _check_kernel_inputs(q, k, v)
    for name, x in (("dO", do), ("out", out)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash backward needs {name} like q, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if not _kernel_readable(do):
        do = do.contiguous()
    if not _kernel_readable(out):
        out = out.contiguous()
    b, t_q, h, d = q.shape
    _, t_k, h_kv, _ = k.shape
    tile_dq = _tile("flash_bwd_dq", code, d, block_q)
    tile_dkv = _tile("flash_bwd_dkv", code, d, block_k)
    lse = lse.float().contiguous()
    if g_lse is not None:
        g_lse = g_lse.float().contiguous()
    # B2 writes delta and lse * log2(e) here for B3, in rows of t_q rounded
    # up to 4 values (each row 16-byte aligned for B3's TMA).
    rows = torch.empty(2 * b * h * (-(-t_q // 4) * 4), dtype=torch.float32,
                       device=q.device)
    dq = torch.empty(b, t_q, h, d, dtype=q.dtype, device=q.device)
    dk = torch.empty(b, t_k, h_kv, d, dtype=k.dtype, device=q.device)
    dv = torch.empty(b, t_k, h_kv, d, dtype=v.dtype, device=q.device)
    if b * h * t_q == 0 or t_k == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sizes = (b, h, h_kv, t_q, t_k, d, float(scale), int(bool(causal)), code)
    inputs = [x.data_ptr() for x in (q, k, v, do, lse, rows)]

    def strides(*xs):
        flat = [st for x in xs for st in x.stride()[:3]]
        return (ctypes.c_int64 * len(flat))(*flat)

    err = kernels.function("flash_bwd_dq")(
        *inputs, dq.data_ptr(), out.data_ptr(),
        None if g_lse is None else g_lse.data_ptr(),
        strides(q, k, v, do, dq, out), *sizes, tile_dq, stream)
    kernels.check_launch("flash_bwd_dq", err)
    launches_dq += 1
    err = kernels.function("flash_bwd_dkv")(
        *inputs, dk.data_ptr(), dv.data_ptr(),
        strides(q, k, v, do, dk, dv), *sizes, tile_dkv, stream)
    kernels.check_launch("flash_bwd_dkv", err)
    launches_dkv += 1
    return dq, dk, dv


class _FlashFunction(torch.autograd.Function):
    """(out, lse) = flash(q, k, v), differentiable in q, k, v through both
    outputs: B1 forward and B2 + B3 backward on the card, the plain twins
    on the CPU, with the instances of ``blocks`` (block_q, block_k).
    Saves (q, k, v, out, lse); the backward never re-runs the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, blocks):
        block_q, block_k = blocks
        if q.device.type == "cuda":
            out, lse = _flash_attention_cuda(q, k, v, causal=causal,
                                             scale=scale, block_q=block_q)
        else:
            out, lse = _flash_plain_bthd(q, k, v, causal=causal, scale=scale,
                                         block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.blocks = causal, scale, blocks
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        bwd = _flash_bwd_cuda if q.device.type == "cuda" else _flash_bwd_plain
        block_q, block_k = ctx.blocks
        dq, dk, dv = bwd(q, k, v, out, lse, g_out, causal=ctx.causal,
                         scale=ctx.scale, g_lse=g_lse, block_q=block_q,
                         block_k=block_k)
        return dq, dk, dv, None, None, None


def _flash(q, k, v, *, causal, scale, block_q, block_k):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    h, h_kv = q.shape[2], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    blocks = _default_blocks(q.shape[-1], block_q, block_k)
    return _FlashFunction.apply(q, k, v, causal, float(scale), blocks)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, block_q: int | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """Exact attention. q [B, Tq, H, D], k/v [B, Tk, Hkv, D] with
    H % Hkv == 0 -> [B, Tq, H, D] in q's dtype. Differentiable.
    ``block_q``/``block_k``: the tile knob (see the module note)."""
    return _flash(q, k, v, causal=causal, scale=scale, block_q=block_q,
                  block_k=block_k)[0]


def flash_attention_lse(q, k, v, *, causal: bool,
                        scale: float | None = None,
                        block_q: int | None = None,
                        block_k: int | None = None):
    """Flash attention returning ``(out, lse)``: out [B, Tq, H, D] (q's
    dtype), lse [B, H, Tq] f32, the log-sum-exp of the scaled scores per
    query row (fully masked rows: log(1e-30)). Differentiable through
    both outputs (ring attention differentiates its merge weights).
    ``block_q``/``block_k``: the tile knob (see the module note)."""
    return _flash(q, k, v, causal=causal, scale=scale, block_q=block_q,
                  block_k=block_k)
