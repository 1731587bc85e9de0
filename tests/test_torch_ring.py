"""The port's ring attention (``tony_tpu_torch.parallel.ring``) held against
the JAX package's on the CPU.

The (out, lse) merge against JAX's ``_merge_lse``; the ring body run in one
process (``ring_attention_in_process``: each rotation hands out the next
owner's slice of whole-sequence K/V) at sp 2 and 4 against JAX's
``ring_attention(kernel="jax")`` on a virtual ``MeshSpec(sp=n)`` and
against the port's ``flash_attention`` over the whole sequence; then ONE
launch of two gloo ranks (program ``ring`` in ``tests/torch_ranks.py``)
that runs the sp 2 cases over the real ``ppermute``. fp32 throughout;
inputs from seeded numpy.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu.parallel.ring import _merge_lse as jax_merge_lse
from tony_tpu.parallel.ring import ring_attention as jax_ring_attention
from tony_tpu_torch.ops import flash_attention
from tony_tpu_torch.parallel.ring import _merge_lse, ring_attention_in_process
from torch_ranks import launch

torch.set_num_threads(1)

# fp32: both sides sum the same terms in another order (~5e-7 here). Held
# as max |got - want| <= TOL * max(1, max |want|) for the output and each
# gradient.
TOL = 1e-5
B, D = 2, 16
# name: (query and key positions per rank, query heads, K/V heads, causal).
# "odd": 7 positions a rank; "cross": twice as many queries as keys (the
# JAX package's cross-length test), where blocks after step 0 straddle the
# diagonal in global positions.
CASES = {
    "causal": (16, 16, 4, 4, True),
    "full": (16, 16, 4, 4, False),
    "gqa": (16, 16, 4, 2, True),
    "odd": (7, 7, 4, 2, True),
    "cross": (16, 8, 2, 2, True),
}


def _case(name: str, sp: int) -> dict:
    """Seeded q, k, v and the output cotangent g, whole over the
    sequence; "odd" has 7 positions per rank."""
    t_q, t_k, h, h_kv, causal = CASES[name]
    if name == "odd":
        t_q, t_k = t_q * sp, t_k * sp
    rng = np.random.default_rng(sorted(CASES).index(name) * 10 + sp)
    arrs = {"q": (B, t_q, h, D), "k": (B, t_k, h_kv, D),
            "v": (B, t_k, h_kv, D), "g": (B, t_q, h, D)}
    out = {n: rng.normal(size=s).astype(np.float32) for n, s in arrs.items()}
    out["causal"] = np.asarray(causal)
    return out


@functools.lru_cache(maxsize=None)
def _jax_ring(name: str, sp: int) -> dict:
    """JAX's ring_attention(kernel="jax") on MeshSpec(sp=sp) of ``sp``
    virtual devices: the output and the vjp of g (K/V repeated to the
    query heads inside, so dk/dv sum over each K/V head's group)."""
    c = _case(name, sp)
    mesh = jax_build_mesh(JaxMeshSpec(sp=sp), devices=jax.devices()[:sp])
    group = c["q"].shape[2] // c["k"].shape[2]

    def f(q, k, v):
        return jax_ring_attention(q, jnp.repeat(k, group, 2),
                                  jnp.repeat(v, group, 2), mesh,
                                  causal=bool(c["causal"]), block_k=4,
                                  kernel="jax")

    out, vjp = jax.vjp(f, *(jnp.asarray(c[n]) for n in "qkv"))
    dq, dk, dv = vjp(jnp.asarray(c["g"]))
    return {n: np.asarray(x) for n, x in
            zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv))}


def _port(fn, c: dict) -> dict:
    """``fn(q, k, v)`` on torch tensors of the case, and the gradients of
    <out, g>."""
    q, k, v = (torch.from_numpy(c[n]).requires_grad_() for n in "qkv")
    out = fn(q, k, v)
    out.backward(torch.from_numpy(c["g"]))
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def _assert_close(got: dict, want: dict, what: str) -> None:
    for key in ("out", "dq", "dk", "dv"):
        err = np.abs(got[key] - want[key]).max()
        limit = TOL * max(1.0, np.abs(want[key]).max())
        assert err <= limit, (what, key, err, limit)


def test_merge_lse_matches_jax():
    """_merge_lse against JAX's on seeded partials, values and the vjp
    of seeded cotangents of both outputs, to 1e-6: rows where one side is
    fully masked (lse log(1e-30), the kernel's, or -1e30, a chunk's rows
    that see no key) and rows where both are."""
    rng = np.random.default_rng(3)
    b, t, h, d = 2, 6, 3, 8
    o1, o2 = (rng.normal(size=(b, t, h, d)).astype(np.float32)
              for _ in range(2))
    lse1, lse2 = (rng.normal(size=(b, h, t)).astype(np.float32) * 3
                  for _ in range(2))
    lse1[:, :, 0] = np.log(np.float32(1e-30))
    lse2[:, :, 1] = -1e30
    lse1[:, :, 2] = lse2[:, :, 2] = -1e30
    go = rng.normal(size=(b, t, h, d)).astype(np.float32)
    gl = rng.normal(size=(b, h, t)).astype(np.float32)
    want, vjp = jax.vjp(jax_merge_lse, *map(jnp.asarray, (o1, lse1, o2,
                                                         lse2)))
    want_grads = vjp((jnp.asarray(go), jnp.asarray(gl)))
    ins = [torch.from_numpy(x).requires_grad_() for x in (o1, lse1, o2,
                                                          lse2)]
    got = _merge_lse(*ins)
    torch.autograd.backward(got, (torch.from_numpy(go),
                                  torch.from_numpy(gl)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)
    assert np.isfinite(got[1].detach().numpy()).all()
    for x, w in zip(ins, want_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_in_one_process_matches_jax_and_flash(name, sp):
    """The ring body with the one-process rotation: output and dq, dk, dv
    against JAX's ring_attention(kernel="jax") on sp virtual devices, and
    (equal query and key lengths) against flash_attention over the whole
    sequence, within TOL."""
    c = _case(name, sp)
    causal = bool(c["causal"])
    got = _port(lambda q, k, v: ring_attention_in_process(
        q, k, v, sp, causal=causal), c)
    _assert_close(got, _jax_ring(name, sp), f"{name} sp {sp} vs JAX")
    if c["q"].shape[1] == c["k"].shape[1]:
        whole = _port(lambda q, k, v: flash_attention(q, k, v,
                                                      causal=causal), c)
        _assert_close(got, whole, f"{name} sp {sp} vs flash")


def test_cross_length_follows_global_positions_not_the_kernel_mask():
    """With twice as many queries as keys, the port's ring masks by global
    positions (query row r of rank i at i * Tq + r), as JAX's blockwise
    ring and its test_ring_cross_length_causal_skip_exact do. JAX's kernel
    ring (``_ring_kernel_local``, kernel="interpret" here) applies the
    kernel's own causal mask at step 0, which puts the queries at the end
    of the keys, and disagrees with its blockwise ring by more than 1: the
    port follows the blockwise one (a deliberate deviation, ROADMAP
    Queue C)."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 16, 2, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, 8, 2, 64)).astype(np.float32)
            for _ in range(2))
    mesh = jax_build_mesh(JaxMeshSpec(sp=2), devices=jax.devices()[:2])
    blockwise, kernel = (np.asarray(jax_ring_attention(
        *map(jnp.asarray, (q, k, v)), mesh, causal=True, block_k=4,
        kernel=mode)) for mode in ("jax", "interpret"))
    got = ring_attention_in_process(*map(torch.from_numpy, (q, k, v)), 2,
                                    causal=True).numpy()
    assert np.abs(got - blockwise).max() <= TOL
    assert np.abs(kernel - blockwise).max() > 1.0


def test_ring_in_two_gloo_ranks_matches_jax(tmp_path):
    """One launch of two gloo ranks over an sp=2 mesh, each holding its
    block of every case: ring_attention with the real ppermute gives each
    rank's block of the output and of dq, dk and dv within TOL of JAX's
    ring on two virtual devices. Every case issues two send/recv batches
    on each rank (one rotation forward, its reverse backward), also on
    rank 0, whose causal ring skips the block it receives."""
    arrays = {f"{name}/{n}": x for name in CASES
              for n, x in _case(name, 2).items()}
    np.savez(tmp_path / "cases.npz", **arrays)
    results = launch("ring", tmp_path, args=(tmp_path / "cases.npz",))
    ranks = [dict(np.load(tmp_path / f"ring.{r}.npz")) for r in range(2)]
    for name in CASES:
        got = {key: np.concatenate([ranks[r][f"{name}/{key}"]
                                    for r in range(2)], axis=1)
               for key in ("out", "dq", "dk", "dv")}
        _assert_close(got, _jax_ring(name, 2), f"{name} two ranks")
        assert [res["batches"][name] for res in results] == [2, 2], name
