"""Collectives over named mesh axes, on ``torch.distributed``.

The port's counterpart of the JAX package's ``parallel/collectives.py``: the
same five functions with the same semantics, over the process group of a
mesh axis (``DeviceMesh.get_group(name)``) instead of a ``shard_map`` axis
name, so each also takes the ``mesh``. Every rank of the axis must call them
in the same order (SPMD). Each runs its collective also when the axis has
size 1, so a one-process mesh drives the same path as a larger one.

Two more are differentiable, for the expert-parallel MoE layer: ``pmean``
(``lax.pmean``: its gradient is the mean of the ranks' cotangents) and
``exchange_ep`` (the all_to_all of ``lax.all_to_all`` over ep, whose
gradient is the reverse exchange; ``all_to_all_single`` itself has none).

And Megatron's conjugate pair over tp, for the tensor-parallel trunk:
``copy_to_tp`` (identity forward, all_reduce backward) on the replicated
input of a column-parallel product, and ``reduce_from_tp`` (all_reduce
forward, identity backward) on the partial sums of a row-parallel one. The
JAX package's manual trunk writes the second as ``lax.psum(out, "tp")``;
the first is the transpose JAX takes of an input it broadcasts over tp.
These two, unlike the rest, are the identity at tp = 1.

And the ring's rotation over sp, for ring attention: ``ppermute`` sends
tensors to the next rank of an axis and receives them from the previous
one (``lax.ppermute`` with the permutation i -> i + 1); its gradient is
the reverse rotation of the cotangents, the transpose JAX takes. It too is
the identity at axis size 1.

And what the pipeline over pp needs: ``copy_to`` and ``reduce_from``, the
conjugate pair over any axis (the pipeline's input enters through the
first, its masked output sum leaves through the second); ``anchor`` and
``select``, which keep an unused received tensor in the backward graph at a
zero gradient; ``all_gather_with_slice_grad``, the gather of the layer
stack for work every pp rank does whole; and ``exchange_chunks``, the
all_to_all that turns each rank's contiguous layers into its round-robin
chunks of the interleaved schedule.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from tony_tpu_torch.parallel.mesh import (
    AXES,
    DATA_AXES,
    axis_coordinate,
    axis_size,
    flat_name,
)

# Gradients are averaged in flat buckets of about this many bytes, one
# collective per bucket rather than one per leaf.
BUCKET_BYTES = 25 * 2 ** 20


def axis_group(mesh, axis_names) -> tuple[Any, int]:
    """(process group, size) of mesh axes ``axis_names`` (one name or a
    tuple) taken together. Axes of size 1 add nothing; two or more data
    axes above 1 take the mesh dimension ``build_mesh`` flattened from
    them."""
    names = (axis_names,) if isinstance(axis_names, str) else tuple(
        axis_names)
    wide = tuple(n for n in AXES if n in names and axis_size(mesh, n) > 1)
    if len(wide) > 1:
        if not set(wide) <= set(DATA_AXES):
            raise NotImplementedError(
                f"a collective over mesh axes {wide} together: only the data "
                f"axes {DATA_AXES} have flattened groups")
        # build_mesh flattened them: _flatten returns that mesh again.
        group = mesh[wide]._flatten(flat_name(wide)).get_group()
        return group, axis_size(mesh, wide)
    name = wide[0] if wide else names[0]
    return mesh.get_group(name), axis_size(mesh, name)


def _tensor_leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [] if tree is None else [tree]


def pmean_gradients(grads: Any, mesh, axis_names=("dp", "ep")) -> Any:
    """Average every tensor of ``grads`` (a tensor, or dicts/lists/tuples
    of them) over the data-parallel axes, in place, and return ``grads``.
    Smaller leaves are packed into flat buckets of one dtype, up to
    ``BUCKET_BYTES`` each: one all_reduce per bucket, not per leaf. A
    contiguous leaf of ``BUCKET_BYTES`` or more is reduced where it lies,
    with no copy into a bucket and back."""
    group, n = axis_group(mesh, axis_names)
    bucket_bytes = BUCKET_BYTES
    buckets: dict[torch.dtype, list[list[torch.Tensor]]] = {}
    for t in _tensor_leaves(grads):
        if t.is_contiguous() and t.numel() * t.element_size() >= bucket_bytes:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            if n > 1:
                t.div_(n)
            continue
        runs = buckets.setdefault(t.dtype, [[]])
        size = sum(x.numel() for x in runs[-1]) * t.element_size()
        if runs[-1] and size + t.numel() * t.element_size() > bucket_bytes:
            runs.append([])
        runs[-1].append(t)
    for runs in buckets.values():
        for run in runs:
            flat = torch.cat([t.reshape(-1) for t in run])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            if n > 1:
                flat.div_(n)
            for t, piece in zip(run, flat.split([t.numel() for t in run])):
                t.copy_(piece.view_as(t))
    return grads


def all_gather_tp(x: torch.Tensor, axis: int, axis_name: str = "tp", *,
                  mesh) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``axis`` in rank order (JAX's
    tiled ``all_gather``). Contiguous."""
    group, n = axis_group(mesh, axis_name)
    front = x.movedim(axis, 0).contiguous()
    out = front.new_empty((n * front.shape[0], *front.shape[1:]))
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, axis).contiguous()


def reduce_scatter_tp(x: torch.Tensor, axis: int, axis_name: str = "tp", *,
                      mesh) -> torch.Tensor:
    """Sum ``x`` over the ranks and keep this rank's block of ``axis``
    (JAX's tiled ``psum_scatter``). Contiguous."""
    group, n = axis_group(mesh, axis_name)
    if x.shape[axis] % n:
        raise ValueError(f"dimension {axis} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    front = x.movedim(axis, 0).contiguous()
    out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
    dist.reduce_scatter_tensor(out, front, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, axis).contiguous()


def all_to_all_ep(x: torch.Tensor, split_axis: int, concat_axis: int,
                  axis_name: str = "ep", *, mesh) -> torch.Tensor:
    """Token shuffle for expert parallelism (JAX's tiled ``all_to_all``):
    block i of ``split_axis`` goes to rank i, and the blocks received are
    concatenated along ``concat_axis`` in rank order."""
    group, n = axis_group(mesh, axis_name)
    if x.shape[split_axis] % n:
        raise ValueError(f"dimension {split_axis} of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    send = torch.stack(x.chunk(n, split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def ring_halo_exchange(x: torch.Tensor, axis_name: str, halo: int,
                       axis: int = 0, *, mesh
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange ``halo``-wide boundary slabs with both ring neighbours
    along ``axis``. Returns (from_prev, from_next): the previous rank's
    last ``halo`` rows and the next rank's first."""
    group, n = axis_group(mesh, axis_name)
    lo = x.narrow(axis, 0, halo).contiguous()
    hi = x.narrow(axis, x.shape[axis] - halo, halo).contiguous()
    if n == 1:  # both neighbours are this rank
        return hi.clone(), lo.clone()
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    prev, nxt = ranks[(me - 1) % n], ranks[(me + 1) % n]
    from_prev, from_next = torch.empty_like(hi), torch.empty_like(lo)
    # With two ranks prev == next: the tags keep the two slabs apart.
    ops = [dist.P2POp(dist.isend, hi, nxt, group, tag=0),
           dist.P2POp(dist.irecv, from_prev, prev, group, tag=0),
           dist.P2POp(dist.isend, lo, prev, group, tag=1),
           dist.P2POp(dist.irecv, from_next, nxt, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


def _rotate(tensors, group, n: int, shift: int) -> list[torch.Tensor]:
    """Send each of ``tensors`` to the rank ``shift`` places on along the
    ring of ``group`` and receive its peer from the rank ``shift`` places
    back: one batch of P2P calls, in the same order on every rank. NCCL
    matches a pair's calls in order and ignores the tags; with two ranks
    the previous rank is the next one, and the order keeps the tensors
    apart."""
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    to, frm = ranks[(me + shift) % n], ranks[(me - shift) % n]
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for t in sends]
    ops = []
    for tag, (send, recv) in enumerate(zip(sends, recvs)):
        ops += [dist.P2POp(dist.isend, send, to, group, tag=tag),
                dist.P2POp(dist.irecv, recv, frm, group, tag=tag)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, n, *tensors):
        ctx.args = (group, n)
        return tuple(_rotate(tensors, group, n, 1))

    @staticmethod
    def backward(ctx, *grads):
        # A received tensor's cotangent goes back to the rank that sent it;
        # an unused one is zeros (materialized), so every rank of the ring
        # sends and receives in every backward.
        return (None, None, *_rotate(grads, *ctx.args, -1))


def ppermute(tensors, axis_name: str = "sp", *, mesh) -> tuple:
    """Rotate ``tensors`` (a sequence of tensors) one rank on along the
    ring of mesh axis ``axis_name``: each rank gets what the previous rank
    held (``lax.ppermute`` with i -> i + 1), as a tuple of contiguous
    tensors. Differentiable: the gradient is the reverse rotation. The
    identity at axis size 1."""
    group, n = axis_group(mesh, axis_name)
    if n == 1:
        return tuple(tensors)
    return _Ppermute.apply(group, n, *tensors)


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, axis_name, mesh):
        ctx.args = (axis, axis_name, mesh)
        return all_gather_tp(x, axis, axis_name, mesh=mesh)

    @staticmethod
    def backward(ctx, grad):
        axis, axis_name, mesh = ctx.args
        return (reduce_scatter_tp(grad, axis, axis_name, mesh=mesh),
                None, None, None)


def all_gather_with_scatter_grad(x: torch.Tensor, axis: int,
                                 axis_name: str, *, mesh) -> torch.Tensor:
    """``all_gather_tp`` that autograd differentiates: the gradient of the
    gathered tensor is reduce-scattered (summed over the ranks, this rank's
    block kept), the transpose JAX takes of a tiled all_gather."""
    return _GatherScatter.apply(x, axis, axis_name, mesh)


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y.div_(n) if n > 1 else y

    @staticmethod
    def backward(ctx, grad):
        group, n = ctx.args
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return (g.div_(n) if n > 1 else g), None, None


def pmean(x: torch.Tensor, mesh, axis_names=("dp", "ep")) -> torch.Tensor:
    """The mean of ``x`` over the ranks of mesh axes ``axis_names``
    (``lax.pmean``), differentiable: each rank's loss holds the same mean,
    so a rank's ``x`` gets the mean of every rank's cotangent (one
    all_reduce each way)."""
    group, n = axis_group(mesh, axis_names)
    return _Pmean.apply(x, group, n)


class _ExchangeEp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        # Block j came from rank j: its cotangent goes back to rank j, the
        # same exchange again.
        return _exchange(grad, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    # all_to_all_single reads and writes memory in row-major order: both
    # buffers must be contiguous (empty_like would copy x's strides).
    send = x.contiguous()
    out = torch.empty_like(send, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, send, group=group)
    return out


def exchange_ep(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` [ep, ...]: block i goes to rank i of the ep axis, and block j
    of the result is what rank j sent (``lax.all_to_all(x, "ep", 0, 0)``).
    Differentiable; runs its all_to_all also at ep = 1."""
    group, n = axis_group(mesh, "ep")
    if x.shape[0] != n:
        raise ValueError(f"exchange_ep takes [ep={n}, ...], got "
                         f"{tuple(x.shape)}")
    return _ExchangeEp.apply(x, group)


def _sum_over(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """A contiguous copy of ``x`` summed over ``group``; ``x`` itself at
    n = 1. A copy: the tensor may be shared with another branch of the
    graph (an add hands the same cotangent to both inputs), or saved for a
    remat recomputation (remat "dots" saves a product's output)."""
    if n == 1:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, *ctx.args), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        return _sum_over(x, group, n)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def copy_to(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """``x``, replicated over mesh axis ``axis_name``, into work that each
    rank of the axis does on its own part: the identity, whose gradient is
    summed over the axis (the transpose JAX takes of an input it
    broadcasts over the axis). The identity both ways at axis size 1."""
    return _CopyTo.apply(x, *axis_group(mesh, axis_name))


def reduce_from(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of mesh axis ``axis_name``
    (``lax.psum``), into work that every rank then does whole: its
    gradient is the cotangent itself, which every rank of the axis holds
    whole (a backward that summed over the axis would count it once a
    rank). The identity at axis size 1."""
    return _ReduceFrom.apply(x, *axis_group(mesh, axis_name))


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, replicated over tp, as the input of a column-parallel
    product: the identity, whose gradient is summed over the tp ranks
    (each rank's product gives the cotangent of its own columns only).
    At tp = 1 both ways are the identity: the sum of one rank is its own
    tensor, and the copies a one-rank sum would take (2 x 17 activations
    [b, t, d] a step) added 1.0 ms to bench_transformer's 105.7 ms step on
    an H100."""
    return copy_to(x, mesh, "tp")


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the tp ranks of ``x``, the partial output of a
    row-parallel product (``lax.psum(x, "tp")``); its gradient is the
    cotangent itself, which every tp rank holds whole. The identity at
    tp = 1 (see ``copy_to_tp``)."""
    return reduce_from(x, mesh, "tp")


class _Anchor(torch.autograd.Function):
    """``out`` as it is, with ``tensors`` as inputs whose gradient is
    zeros. A received tensor that no later op uses would leave its
    transfer out of the backward graph on this rank alone, and its peers
    would wait for that transfer's reverse send; the anchor keeps it in."""

    @staticmethod
    def forward(ctx, out, *tensors):
        ctx.likes = [(t.shape, t.dtype, t.device) for t in tensors]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(shape, dtype=dtype, device=device)
                        for shape, dtype, device in ctx.likes))


def anchor(out: torch.Tensor, *tensors: torch.Tensor) -> torch.Tensor:
    """``out``, differentiable, with ``tensors`` kept in the backward graph
    at a zero gradient (``_Anchor``)."""
    return _Anchor.apply(out, *tensors)


def select(first: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` if ``first`` else ``b`` (``jnp.where`` on a rank's own
    condition, without its elementwise pass): the gradient goes to the one
    taken, zeros to the other, so both stay in the backward graph and
    every rank builds the same graph whichever it takes."""
    return _Anchor.apply(a, b) if first else _Anchor.apply(b, a)


class _GatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, axis_name, mesh):
        ctx.args = (axis, x.shape[axis], axis_coordinate(mesh, axis_name))
        return all_gather_tp(x, axis, axis_name, mesh=mesh)

    @staticmethod
    def backward(ctx, grad):
        axis, size, pos = ctx.args
        return grad.narrow(axis, pos * size, size), None, None, None


def all_gather_with_slice_grad(x: torch.Tensor, axis: int, axis_name: str,
                               *, mesh) -> torch.Tensor:
    """``all_gather_tp`` for work that every rank of the axis then does
    whole on the same data (the pp ranks of the unpipelined trunk): each
    rank's cotangent of the gathered tensor is the whole gradient, so the
    gradient of its own block is its slice of it, with no communication (a
    reduce-scatter would sum the axis's identical copies)."""
    return _GatherSlice.apply(x, axis, axis_name, mesh)


def chunk_plan(pp: int, virtual: int, rank: int
               ) -> tuple[list[int], list[int], list[int]]:
    """The exchange that turns contiguous layer blocks into round-robin
    chunks: rank r holds blocks r * virtual + k (k < virtual) of the
    virtual * pp equal blocks of a layer stack, and needs blocks c * pp + r
    (chunk c < virtual). Block b goes to rank b % pp. Returns (this rank's
    blocks in the order it sends them, grouped by destination rank; the
    blocks it sends to each rank; the blocks it receives from each rank).
    What arrives, in source order, is in chunk order: block c * pp + r
    comes from rank (c * pp + r) // virtual, which grows with c."""
    own = [rank * virtual + k for k in range(virtual)]
    order = sorted(range(virtual), key=lambda k: (own[k] % pp, k))
    send = [sum(1 for b in own if b % pp == q) for q in range(pp)]
    recv = [sum(1 for c in range(virtual) if (c * pp + rank) // virtual == q)
            for q in range(pp)]
    return order, send, recv


def _all_to_all_blocks(x, group, send, recv) -> torch.Tensor:
    """all_to_all over dim 0 of ``x`` [blocks, ...]: ``send[q]`` blocks to
    rank q, ``recv[q]`` from it, concatenated in rank order."""
    x = x.contiguous()
    out = x.new_empty((sum(recv), *x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out


class _ExchangeChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pp, virtual, rank):
        order, send, recv = chunk_plan(pp, virtual, rank)
        ctx.args = (group, order, send, recv, x.shape)
        blocks = x.reshape(virtual, x.shape[0] // virtual, *x.shape[1:])
        return _all_to_all_blocks(blocks[order], group, send, recv)

    @staticmethod
    def backward(ctx, grad):
        # Chunk c's cotangent goes back to the rank that sent its block,
        # which puts the blocks back in its own order.
        group, order, send, recv, shape = ctx.args
        back = _all_to_all_blocks(grad, group, recv, send)
        local = torch.empty_like(back)
        local[order] = back
        return local.reshape(shape), None, None, None, None


def exchange_chunks(x: torch.Tensor, mesh, virtual: int,
                    axis_name: str = "pp") -> torch.Tensor:
    """This rank's ``virtual`` round-robin chunks of a layer stack split
    over ``axis_name`` in contiguous blocks: ``x`` [L/pp, ...] holds
    layers [r * L/pp, (r + 1) * L/pp) on rank r; the result [virtual,
    L/(virtual * pp), ...] holds in row c the layers of global virtual
    stage c * pp + r (the interleaved schedule's placement, which JAX's
    ``forward_pipeline`` gets by reshaping the pp-sharded stack). One
    all_to_all over the axis (``chunk_plan``); differentiable, the
    gradient going back the reverse way. Runs its all_to_all also at axis
    size 1."""
    group, n = axis_group(mesh, axis_name)
    if x.shape[0] % virtual:
        raise ValueError(f"{x.shape[0]} layers do not split into "
                         f"{virtual} chunks")
    return _ExchangeChunks.apply(x, group, n, virtual,
                                 axis_coordinate(mesh, axis_name))
