"""The port's pipeline schedules held against the JAX package on the CPU,
with no processes: ``schedule_info``; ``pipeline_apply_in_process`` (every
stage of a pipeline run in this process, tick by tick) against JAX's
``pipeline_apply`` on the virtual CPU mesh (the sequential match, the
gradient through the pipeline, the bubble ticks' non-finite aux masked in
both schedules, the refusals), mirroring ``tests/test_parallel.py``'s
``TestPipeline``; the chunk exchange's plan; and the pipelined trunk at
pp 4 x virtual 4 on a 16-layer tiny config against JAX's interleaved
``lm_loss`` on ``MeshSpec(pp=4, tp=2)`` (``tests/test_models.py``'s
depth case), and against itself under GPipe and v 2. Inputs from seeded
numpy generators; the JAX references jitted on its 8 virtual devices.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_moe import _flat
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models import init_params as jax_init_params
from tony_tpu.models.train import lm_loss as jax_lm_loss
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from tony_tpu.parallel.pipeline import schedule_info as jax_schedule_info
from tony_tpu_torch.interop import params_from_numpy
from tony_tpu_torch.models import TransformerConfig, lm_loss
from tony_tpu_torch.parallel.collectives import chunk_plan
from tony_tpu_torch.parallel.pipeline import (
    pipeline_apply_in_process,
    schedule_info,
)

torch.set_num_threads(1)

# tests/test_models.py's depth case: 16 layers, so pp 4 x virtual 4 has 16
# virtual stages of one layer.
DEEP = dict(vocab_size=128, d_model=32, n_layers=16, n_heads=2,
            head_dim=16, d_ff=64, max_seq=64, dtype="float32", remat=False)
DEEP_PIPE = dict(pipeline_microbatches=8, pipeline_schedule="interleaved",
                 pipeline_virtual=4)


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
@pytest.mark.parametrize("m,pp,layers,virtual", [
    (1, 1, 4, 1), (4, 2, 8, 1), (8, 4, 16, 2), (8, 4, 16, 4),
    (6, 3, 12, 2), (16, 8, 64, 3)])
def test_schedule_info_matches_jax(schedule, m, pp, layers, virtual):
    v = virtual if schedule == "interleaved" else 1
    assert dataclasses.astuple(schedule_info(schedule, m, pp, layers, v)) \
        == dataclasses.astuple(jax_schedule_info(schedule, m, pp, layers, v))


def test_schedule_info_refuses_an_unknown_schedule():
    with pytest.raises(ValueError, match="unknown schedule '1f1b'"):
        schedule_info("1f1b", 4, 2, 8)


def _jax_mesh(**axes):
    spec = JaxMeshSpec(**axes)
    return jax_build_mesh(spec, devices=jax.devices()[:spec.num_devices])


def _linear_stages(seed, shape, dim, batch, positive=False):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(*shape, dim, dim)) * 0.3).astype(np.float32)
    x = rng.normal(size=(batch, dim)).astype(np.float32)
    if positive:
        # Bounded away from zero, so every valid tick's aux is finite and
        # only bubble ticks see all-zero activations.
        x = np.abs(x) + np.float32(1.0)
    return w, x


def test_matches_sequential_and_jax():
    """pp 4 over 4 microbatches, GPipe: the stages in sequence, and JAX's
    pipeline_apply on MeshSpec(pp=4, dp=2), to 1e-5."""
    pp, dim = 4, 8
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(pp, dim, dim)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(pp, dim)) * 0.1).astype(np.float32)
    x = rng.normal(size=(16, dim)).astype(np.float32)
    want = np.asarray(jax_pipeline_apply(
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
        mesh=_jax_mesh(pp=pp, dp=2), num_microbatches=4))
    got = pipeline_apply_in_process(
        lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
        torch.from_numpy(x), pp, num_microbatches=4).numpy()
    seq = x
    for i in range(pp):
        seq = np.tanh(seq @ w[i] + b[i])
    np.testing.assert_allclose(got, seq, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("schedule,pp,virtual,m", [
    ("gpipe", 2, 1, 2), ("gpipe", 4, 1, 8), ("interleaved", 2, 2, 2),
    ("interleaved", 4, 2, 8), ("interleaved", 4, 4, 4)])
def test_grad_through_pipeline_matches_jax(schedule, pp, virtual, m):
    """The loss's sum and its gradient in the stage weights and the input,
    through the in-process pipeline, against jax.grad of JAX's
    pipeline_apply on a pp x dp mesh (stage params [pp, ...] or [pp, v,
    ...]) and the stages in sequence, to 1e-5."""
    dim = 4
    shape = (pp,) if schedule == "gpipe" else (pp, virtual)
    w, x = _linear_stages(3 + pp + virtual, shape, dim, 8)
    mesh = _jax_mesh(pp=pp, dp=8 // pp)

    def jax_loss(w, x):
        return jax_pipeline_apply(
            lambda p, h: jnp.tanh(h @ p["w"]), {"w": w}, x, mesh=mesh,
            num_microbatches=m, schedule=schedule, virtual=virtual).sum()

    j_loss, (j_gw, j_gx) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(w), jnp.asarray(x))
    tw, tx = (torch.from_numpy(a.copy()).requires_grad_() for a in (w, x))
    loss = pipeline_apply_in_process(
        lambda p, h: torch.tanh(h @ p["w"]), {"w": tw}, tx, pp,
        num_microbatches=m, schedule=schedule, virtual=virtual).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(j_gw), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_gx), atol=1e-5)
    # The stages in sequence (global virtual stage g = c * pp + d).
    seq_w = torch.from_numpy(w.copy()).requires_grad_()
    h = torch.from_numpy(x)
    for g in range(pp * virtual):
        h = torch.tanh(h @ (seq_w[g] if schedule == "gpipe"
                            else seq_w[g % pp, g // pp]))
    h.sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), seq_w.grad.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("schedule,virtual,x_rows", [
    ("gpipe", 1, 8), ("interleaved", 2, 4)])
def test_bubble_tick_nan_aux_masked(schedule, virtual, x_rows):
    """Bubble ticks run the stage on garbage (zero-initialized)
    activations, where the aux log(sum |x|) is -inf: the accumulated aux
    stays finite and equals JAX's and the sum over (stage, microbatch) of
    each stage's aux on its true input (test_parallel.py's two cases),
    and the gradient of out + aux stays finite."""
    pp, m, dim = 2, 2, 4
    shape = (pp,) if schedule == "gpipe" else (pp, virtual)
    w, x = _linear_stages(5 if schedule == "gpipe" else 6, shape, dim,
                          x_rows, positive=True)

    def stage(tanh, log, absolute):
        def fn(p, xin):
            y = tanh(xin @ p["w"]) + 2.0
            return y, {"logsum": log(absolute(xin).sum())}
        return fn

    _, j_aux = jax_pipeline_apply(
        stage(jnp.tanh, jnp.log, jnp.abs), {"w": jnp.asarray(w)},
        jnp.asarray(x), mesh=_jax_mesh(pp=pp, dp=4), num_microbatches=m,
        schedule=schedule, virtual=virtual, stage_aux=True)
    tw = torch.from_numpy(w.copy()).requires_grad_()
    out, aux = pipeline_apply_in_process(
        stage(torch.tanh, torch.log, torch.abs), {"w": tw},
        torch.from_numpy(x), pp, num_microbatches=m, schedule=schedule,
        virtual=virtual, stage_aux=True)
    got = aux["logsum"].item()
    assert np.isfinite(got), "a bubble tick's -inf leaked into the aux sum"
    x_mb = x.reshape(m, -1, dim)
    expect = 0.0
    for u in range(m):
        h = x_mb[u]
        for g in range(pp * virtual):
            expect += np.log(np.abs(h).sum())
            h = np.tanh(h @ (w[g] if schedule == "gpipe"
                             else w[g % pp, g // pp])) + 2.0
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    np.testing.assert_allclose(got, float(j_aux["logsum"]), rtol=1e-5)
    (out.sum() + aux["logsum"]).backward()
    assert torch.isfinite(tw.grad).all()


def test_refusals_match_jax():
    """The JAX package's refusals, with its messages: a batch the
    microbatches do not divide, an unknown schedule, virtual stages
    without the interleaved schedule, interleaved microbatches pp does
    not divide, and virtual < 1."""
    w = {"w": torch.zeros(2, 1)}
    x = torch.zeros(8, 4)
    cases = [
        (dict(), torch.zeros(7, 4), 2, "not divisible by 2 microbatches"),
        (dict(schedule="1f1b"), x, 2, "unknown schedule '1f1b'"),
        (dict(virtual=2), x, 2, "requires schedule='interleaved'"),
        (dict(schedule="interleaved", virtual=2), torch.zeros(6, 4), 3,
         "divisible by pp \\(2\\)"),
        (dict(schedule="interleaved", virtual=0), x, 2, "virtual must be"),
    ]
    mesh = _jax_mesh(pp=2, dp=4)
    for kw, xx, m, match in cases:
        with pytest.raises(ValueError, match=match):
            pipeline_apply_in_process(lambda p, h: h, w, xx, 2,
                                      num_microbatches=m, **kw)
        with pytest.raises(ValueError, match=match):
            jax_pipeline_apply(lambda p, h: h, {"w": jnp.zeros((2, 1))},
                               jnp.asarray(xx.numpy()), mesh=mesh,
                               num_microbatches=m, **kw)


@pytest.mark.parametrize("pp,virtual", [(1, 3), (2, 2), (2, 3), (4, 2),
                                        (4, 4), (3, 5)])
def test_chunk_plan_gives_each_rank_its_round_robin_chunks(pp, virtual):
    """The chunk exchange's all_to_all, run by hand from ``chunk_plan`` on
    every rank's contiguous blocks (rank r holds blocks r * v .. r * v +
    v - 1), gives rank d the blocks c * pp + d in chunk order, JAX's
    ``forward_pipeline`` reshape of the stack ([v, pp] swapped); the
    reverse exchange puts every block back where it was."""
    blocks = np.arange(pp * virtual)
    held = blocks.reshape(pp, virtual)
    want = blocks.reshape(virtual, pp).swapaxes(0, 1)
    plans = [chunk_plan(pp, virtual, r) for r in range(pp)]
    sent = []
    for r, (order, send, _) in enumerate(plans):
        buf = held[r][order]
        sent.append(np.split(buf, np.cumsum(send)[:-1]))
    for d, (_, send, recv) in enumerate(plans):
        got = np.concatenate([sent[q][d] for q in range(pp)])
        assert [len(sent[q][d]) for q in range(pp)] == recv
        np.testing.assert_array_equal(got, want[d])
    back = []
    for d, (_, _, recv) in enumerate(plans):
        back.append(np.split(want[d], np.cumsum(recv)[:-1]))
    for r, (order, send, _) in enumerate(plans):
        local = np.empty(virtual, dtype=int)
        local[order] = np.concatenate([back[q][r] for q in range(pp)])
        np.testing.assert_array_equal(local, held[r])


@pytest.fixture(scope="module")
def deep():
    """JAX's 16-layer weights (jitted initializer), a batch of 8 x 17, and
    JAX's loss and gradients of the interleaved pipeline at pp 4 x v 4
    over 8 microbatches on MeshSpec(pp=4, tp=2)."""
    jcfg = JaxConfig(**DEEP)
    jparams = jax.jit(jax_init_params, static_argnums=1)(
        jax.random.key(5), jcfg)
    tokens = np.random.default_rng(7).integers(0, 128, (8, 17)).astype(
        np.int32)
    mesh = _jax_mesh(pp=4, tp=2)
    with jax.sharding.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t: jax_lm_loss(p, t, jcfg, mesh, **DEEP_PIPE)))(
            jparams, jnp.asarray(tokens))
    return (jax.device_get(jparams), tokens, float(loss),
            _flat(jax.device_get(grads)))


def _port_loss_and_grads(jparams, tokens, **pipe) -> tuple:
    cfg = TransformerConfig(**DEEP)
    params = params_from_numpy(jparams, cfg, "cpu")
    flat = {}

    def trainable(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = trainable(v, f"{prefix}{k}/")
            else:
                out[k] = flat[prefix + k] = v.clone().requires_grad_()
        return out

    params = trainable(params)
    loss = lm_loss(params, torch.from_numpy(tokens), cfg, None, **pipe)
    loss.backward()
    return loss.item(), {k: v.grad.numpy() for k, v in flat.items()}


def test_deep_interleaved_trunk_matches_jax(deep):
    """The pipelined trunk run in this process at pp 4 x v 4 (16 virtual
    stages), 8 microbatches: the loss equals JAX's interleaved pipeline
    on MeshSpec(pp=4, tp=2) to rtol 1e-6, and every gradient leaf within
    2e-6 of the leaf's largest."""
    jparams, tokens, want_loss, want = deep
    loss, grads = _port_loss_and_grads(jparams, tokens, pipeline_stages=4,
                                       **DEEP_PIPE)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    assert set(grads) == set(want)
    for path, g in grads.items():
        scale = np.abs(want[path]).max()
        assert np.abs(g - want[path]).max() <= 2e-6 * scale, path


@pytest.mark.parametrize("pipe", [
    dict(pipeline_microbatches=8, pipeline_stages=4),
    dict(pipeline_microbatches=8, pipeline_stages=4,
         pipeline_schedule="interleaved", pipeline_virtual=2)],
    ids=["gpipe", "interleaved-v2"])
def test_deep_trunk_schedules_agree(deep, pipe):
    """The same trunk, batch and weights under GPipe and interleaved at v
    2 (pp 4, 8 microbatches): loss and gradients equal v 4's to the same
    tolerances (the schedules reorder the same math)."""
    jparams, tokens, _, _ = deep
    loss4, grads4 = _port_loss_and_grads(jparams, tokens, pipeline_stages=4,
                                         **DEEP_PIPE)
    loss, grads = _port_loss_and_grads(jparams, tokens, **pipe)
    np.testing.assert_allclose(loss, loss4, rtol=1e-6)
    for path, g in grads.items():
        scale = np.abs(grads4[path]).max()
        assert np.abs(g - grads4[path]).max() <= 2e-6 * scale, path
