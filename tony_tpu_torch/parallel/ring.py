"""Ring attention: exact attention over a sequence split over the ``sp``
mesh axis. The port's counterpart of the JAX package's ``parallel/ring.py``.

Rank i of the ring holds queries, keys and values of the positions
[i * T, (i + 1) * T) of the sequence. Step 0 attends its queries to its own
keys (causal: the diagonal block); step s attends them to the block of rank
i - s, which the ring brought one rank on at each step. Each step is one
call of ``flash_attention_lse`` (B1 forward, B2/B3 backward on the card,
the plain twins for CPU tensors), and the steps' partial results are
merged in fp32 by their (out, lse) (``_merge_lse``), whose weights
differentiate through lse. Under a causal mask, a step whose block lies
wholly in the future of the rank's queries is skipped; every rank still
rotates the same blocks, so the ring stays in step.

The schedule is apart from the transport: ``ring_body`` takes the rotation
of one K/V block as an argument. ``ring_attention`` rotates over the mesh
axis with ``collectives.ppermute`` (NCCL or gloo send/recv, whose
backward sends each block's dk/dv back to its owner);
``ring_attention_in_process`` runs the ranks of a ring one after another in
one process, each rotation handing out the next owner's slice of
whole-sequence K/V tensors, so autograd routes each block's gradient to its
owner. Both run the same schedule and kernel calls.

Where the port differs from the JAX package:

* ``ring_attention`` takes this rank's local shards [B_local, T/sp, H/tp,
  D], not global arrays: the port has no global arrays.
* K/V rotate at their Hkv heads: the port's flash attention takes GQA K/V,
  so the heads are not repeated before the ring (an exact repeat; it would
  multiply the ring's bytes by H/Hkv).
* No step is recomputed in the backward (JAX remats each ring step): the
  flash Function keeps no score matrix, a step's residuals are its
  received block and its (out, lse), and a recomputation would send and
  receive again.
* Each step waits for its block before its chunk runs: the exchange does
  not overlap the kernels yet.
* Positions are global, as in the JAX package's blockwise path: query row
  r of rank i sits at i * T_q + r, key j of rank o at o * T_k + j. With
  T_q != T_k a block can straddle the diagonal after step 0; it is split
  into kernel calls whose masks make up the global one.
"""

from __future__ import annotations

import torch

from tony_tpu_torch.ops.attention import NEG_INF, flash_attention_lse
from tony_tpu_torch.parallel.collectives import anchor, ppermute
from tony_tpu_torch.parallel.mesh import axis_coordinate, axis_size


def _merge_lse(o1, lse1, o2, lse2):
    """Merge two normalized partials (o [B, T, H, D] f32, lse [B, H, T]
    f32): the (out, lse) form of the online-softmax merge, in the JAX
    package's form (the weights of a fully masked partial's rows stay
    finite)."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2
    wt1 = (w1 / denom).transpose(1, 2)[..., None]
    wt2 = (w2 / denom).transpose(1, 2)[..., None]
    return o1 * wt1 + o2 * wt2, m + torch.log(denom)


def _flash(q, k, v, *, causal, scale):
    out, lse = flash_attention_lse(q, k, v, causal=causal, scale=scale)
    return out.float(), lse


def _chunk(q, k, v, offset: int, *, causal: bool, scale: float):
    """The queries' attention to one K/V block, in which key j is visible
    to query row r iff j <= offset + r (causal; ``offset`` = the first
    query's global position less the first key's): (out [B, Tq, H, D] f32,
    lse [B, H, Tq]), or None when no key is visible. The flash kernel's
    causal mask puts the queries at the end of the keys, so rows that see
    part of the block go through it with the keys cut to match, rows that
    see all of it through the unmasked kernel, and rows that see none get
    lse -1e30 (weight 0 in the merge)."""
    t_q, t_k = q.shape[1], k.shape[1]
    if not causal or offset >= t_k - 1:
        return _flash(q, k, v, causal=False, scale=scale)
    if offset + t_q <= 0:
        return None
    first = max(0, -offset)
    pieces = []
    if first:
        b, _, h, d = q.shape
        pieces.append((q.new_zeros((b, first, h, d), dtype=torch.float32),
                       q.new_full((b, h, first), NEG_INF,
                                  dtype=torch.float32)))
    if offset + t_q <= t_k:
        keys = offset + t_q
        pieces.append(_flash(q[:, first:], k[:, :keys], v[:, :keys],
                             causal=True, scale=scale))
    else:
        split = t_k - offset
        pieces.append(_flash(q[:, first:split], k, v, causal=True,
                             scale=scale))
        pieces.append(_flash(q[:, split:], k, v, causal=False, scale=scale))
    if len(pieces) == 1:
        return pieces[0]
    return (torch.cat([p[0] for p in pieces], 1),
            torch.cat([p[1] for p in pieces], 2))


def ring_body(q, k, v, rotate, *, axis_size: int, axis_index: int,
              causal: bool, scale: float) -> torch.Tensor:
    """One rank's ring. q [B, Tq, H, D], k/v [B, Tk, Hkv, D]: this rank's
    block (rank ``axis_index`` of ``axis_size``). ``rotate(k_blk, v_blk)``
    returns the block the previous rank held; it is called
    ``axis_size - 1`` times, on every rank. Returns [B, Tq, H, D] in q's
    dtype."""
    n, idx = axis_size, axis_index
    t_q, t_k = q.shape[1], k.shape[1]
    acc, k_blk, v_blk = None, k, v
    for s in range(n):
        if s:
            k_blk, v_blk = rotate(k_blk, v_blk)
        owner = (idx - s) % n
        part = _chunk(q, k_blk, v_blk, idx * t_q - owner * t_k,
                      causal=causal, scale=scale)
        if part is not None:
            acc = part if acc is None else _merge_lse(*acc, *part)
    out = acc[0]
    if n > 1 and part is None:
        out = anchor(out, k_blk, v_blk)
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, *, axis_name: str = "sp",
                   causal: bool = True, scale: float | None = None,
                   block_k: int = 512) -> torch.Tensor:
    """Exact attention over a sequence split on mesh axis ``axis_name``,
    from this rank's local shards: q [B_local, T/sp, H/tp, D], k/v
    [B_local, T/sp, Hkv/tp, D] (rank i holds positions [i * T, (i + 1) *
    T); the JAX package takes the global arrays). K/V rotate with
    ``ppermute``. ``scale`` defaults to D ** -0.5. ``block_k`` is accepted
    for the JAX package's signature and ignored: the port's kernels tile
    with their own compiled sizes."""
    if scale is None:
        scale = q.shape[-1] ** -0.5

    def rotate(k_blk, v_blk):
        return ppermute((k_blk, v_blk), axis_name, mesh=mesh)

    return ring_body(q, k, v, rotate, axis_size=axis_size(mesh, axis_name),
                     axis_index=axis_coordinate(mesh, axis_name),
                     causal=causal, scale=scale)


def _slice_rotation(k, v, sp: int, idx: int):
    """The rotation of rank ``idx`` of a ring of ``sp`` run in one
    process: each call hands out the previous owner's slice of the
    whole-sequence ``k``/``v``."""
    t_k = k.shape[1] // sp
    owner = idx

    def rotate(k_blk, v_blk):
        nonlocal owner
        owner = (owner - 1) % sp
        blk = slice(owner * t_k, (owner + 1) * t_k)
        return k[:, blk], v[:, blk]

    return rotate


def ring_attention_in_process(q, k, v, sp: int, *, causal: bool = True,
                              scale: float | None = None) -> torch.Tensor:
    """The ring of ``sp`` ranks run one rank after another in this process
    over whole-sequence q [B, Tq, H, D] and k/v [B, Tk, Hkv, D] (sp must
    divide Tq and Tk): ``ring_body`` with a rotation that hands out slices
    of k/v. Returns [B, Tq, H, D], the ranks' outputs in order.
    Differentiable: a block's gradient reaches its slice of k/v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.shape[1] % sp or k.shape[1] % sp:
        raise ValueError(f"sp {sp} must divide the lengths {q.shape[1]} "
                         f"and {k.shape[1]}")
    t_q, t_k = q.shape[1] // sp, k.shape[1] // sp
    outs = []
    for idx in range(sp):
        own = slice(idx * t_k, (idx + 1) * t_k)
        outs.append(ring_body(
            q[:, idx * t_q:(idx + 1) * t_q], k[:, own], v[:, own],
            _slice_rotation(k, v, sp, idx), axis_size=sp, axis_index=idx,
            causal=causal, scale=scale))
    return torch.cat(outs, 1)
