"""The port's MoE model family held against the JAX package on the CPU.

Routing (``_route_tokens``, with its tie rule), the MoE layer (``_moe_mlp``:
output, the kept/dropped pattern and the four router values, with drops and
without), ``lm_loss`` and every gradient leaf at each remat setting, a
3-step ``make_train_step`` trajectory, the balance loss recovering a
collapsed router, MoE decode (dense mixture and routed gather) and serving,
and the expert-parallel path: the rank lists of the dp x ep groups, a
one-rank mesh bit-equal to ``mesh=None``, and one launch of two gloo ranks
(``torch_ranks.launch``) over an ep=2 mesh held against the JAX package's
ep=2 step, its manual MoE layer under ``shard_map``, and its checkpoint
manager both ways. Tiny configs (2 layers, d 32, E 4), fp32, weights from
the JAX initializer through ``interop``, inputs from seeded numpy
generators.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from tony_tpu.checkpoint import CheckpointManager as JaxManager
from tony_tpu.checkpoint import _MANIFEST as JAX_MANIFEST
from tony_tpu.checkpoint.manager import _normalize_index
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models import generate as jax_generate
from tony_tpu.models import init_params as jax_init_params
from tony_tpu.models import param_roles as jax_param_roles
from tony_tpu.models import transformer as jax_tf
from tony_tpu.models.decode import decode_weights as jax_decode_weights
from tony_tpu.models.train import _sharding_for_tree
from tony_tpu.models.train import lm_loss as jax_lm_loss
from tony_tpu.models.train import make_train_step as jax_make_train_step
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu_torch.interop import params_from_numpy, params_to_numpy
from tony_tpu_torch.models import (
    DecodeSession,
    TransformerConfig,
    forward,
    generate,
    lm_loss,
    make_train_step,
)
from tony_tpu_torch.models import transformer as tf
from tony_tpu_torch.parallel import MeshSpec, build_mesh
from tony_tpu_torch.parallel.mesh import AXES, axis_group_ranks
from tony_tpu_torch.serving import ServingEngine
from torch_ranks import MOE_TINY, launch

torch.set_num_threads(1)

MOE_KEYS = {"moe_balance", "moe_zloss", "moe_drop_rate", "moe_entropy"}
# Decode: GQA 4/2, head_dim 8, the JAX decode tests' shape.
DECODE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, head_dim=8, d_ff=64, max_seq=64,
              dtype="float32", remat=False, n_experts=4, expert_top_k=2,
              capacity_factor=4.0)


# The JAX initializer compiled (far faster than its eager ops here).
_jax_init = jax.jit(jax_init_params, static_argnums=1)


def _cfgs(**overrides):
    kw = {**MOE_TINY, **overrides}
    return JaxConfig(**kw), TransformerConfig(**kw)


@pytest.fixture(scope="module")
def mesh():
    mesh = jax_build_mesh(JaxMeshSpec(), devices=jax.devices()[:1])
    with jax.sharding.set_mesh(mesh):
        yield mesh


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jparams = _jax_init(jax.random.key(0), jcfg)
    return jparams, params_from_numpy(jax.device_get(jparams), tcfg, "cpu")


def _tokens(seed, b=2, t=17):
    return np.random.default_rng(seed).integers(0, 64, (b, t)).astype(
        np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().float().numpy()
                               if torch.is_tensor(v) else np.asarray(v))
    return out


def _trainable(params):
    return {k: (_trainable(v) if isinstance(v, dict)
                else v.detach().clone().requires_grad_())
            for k, v in params.items()}


def _grads(params):
    return {k: (_grads(v) if isinstance(v, dict) else v.grad)
            for k, v in params.items()}


def _layer(params, i=0):
    return {k: v[i] for k, v in params["layers"].items()}


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_value_and_grad(params, tokens, cfg, mesh):
    """((loss, metrics), grads) of the JAX package's lm_loss."""
    return jax.value_and_grad(jax_lm_loss, has_aux=True)(
        params, tokens, cfg, mesh, return_metrics=True)


def _jax_keep(gidx, e, cap):
    """The JAX layer's slot assignment and capacity mask, [b, t, k]."""
    b, t, kk = gidx.shape
    onehot = jax.nn.one_hot(gidx, e, dtype=jnp.float32)
    flat = onehot.transpose(2, 0, 1, 3).reshape(kk * b * t, e).astype(
        jnp.int32)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos_e = (pos * flat).sum(-1).reshape(kk, b, t).transpose(1, 2, 0)
    return np.asarray(pos_e), np.asarray(pos_e < cap)


# ---------------------------------------------------------------------------
# Routing and the layer
# ---------------------------------------------------------------------------

def test_route_tokens_matches_jax():
    rng = np.random.default_rng(0)
    hn = rng.standard_normal((2, 9, 32)).astype(np.float32)
    router = rng.standard_normal((32, 4)).astype(np.float32) * 0.3
    for k in (1, 2, 3):
        want = jax_tf._route_tokens(jnp.asarray(hn), jnp.asarray(router), k)
        got = tf._route_tokens(torch.from_numpy(hn),
                               torch.from_numpy(router), k)
        for name, g, w in zip(("logits", "probs", "gvals", "gidx"), got,
                              want):
            if name == "gidx":
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                # Values of order 1; fp32 sums of 32 products in another
                # order differ by a few 1e-7.
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=name)


def test_route_tokens_breaks_ties_toward_the_lower_index():
    """Experts 1 and 3 share a router column, and 0 and 2 another: every
    row ties twice. lax.top_k takes the lower index first, and so must
    the port."""
    rng = np.random.default_rng(1)
    hn = rng.standard_normal((1, 6, 8)).astype(np.float32)
    col_a, col_b = rng.standard_normal((2, 8)).astype(np.float32)
    router = np.stack([col_a, col_b, col_a, col_b], axis=1)
    for k in (1, 2, 3):
        want = np.asarray(jax_tf._route_tokens(
            jnp.asarray(hn), jnp.asarray(router), k)[3])
        got = tf._route_tokens(torch.from_numpy(hn),
                               torch.from_numpy(router), k)[3].numpy()
        np.testing.assert_array_equal(got, want)
        # The tied pair comes out in index order.
        if k >= 2:
            assert (got[..., 0] < got[..., 1]).all()


@pytest.mark.parametrize("cf,drops", [(1.25, True), (4.0, False)])
def test_moe_layer_matches_jax(weights, mesh, cf, drops):
    """Output within 1e-6 of its largest entry, the four router values to
    rtol 1e-6, the expert choices and the kept/dropped pattern exact."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    rng = np.random.default_rng(2)
    # A shared offset skews the routing, so that cf 1.25 drops.
    x = (rng.standard_normal((4, 16, 32))
         + 2.0 * rng.standard_normal(32)).astype(np.float32)
    want, want_aux = jax_tf._moe_mlp(jnp.asarray(x), _layer(jparams), jcfg,
                                     mesh)
    got, aux = tf._moe_mlp(torch.from_numpy(x), _layer(tparams), tcfg)
    assert got.shape == (4, 16, 32) and set(aux) == MOE_KEYS
    assert _rel_err(got.numpy(), want) <= 1e-6
    for key in MOE_KEYS:
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]),
                                   rtol=1e-6, err_msg=key)
    assert (float(aux["moe_drop_rate"]) > 0) == drops

    lp = _layer(tparams)
    cap = max(1, int(cf * 4 * 16 * 2 / 4))
    hn = jax_tf.rms_norm(jnp.asarray(x), _layer(jparams)["ln2"])
    jidx = np.asarray(jax_tf._route_tokens(hn, _layer(jparams)["router"],
                                           2)[3])
    tidx = tf._route_tokens(tf.rms_norm(torch.from_numpy(x), lp["ln2"]),
                            lp["router"], 2)[3]
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    _, pos, keep, _ = tf._expert_slots(tidx, 4, cap)
    want_pos, want_keep = _jax_keep(jnp.asarray(jidx), 4, cap)
    np.testing.assert_array_equal(
        pos.reshape(2, 4, 16).permute(1, 2, 0).numpy(), want_pos)
    np.testing.assert_array_equal(
        keep.reshape(2, 4, 16).permute(1, 2, 0).numpy(), want_keep)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "dots")])
def test_lm_loss_and_gradients_match_jax(weights, mesh, remat, policy, cf):
    """The total loss (CE + the router terms) and every metric to rtol
    1e-6, every gradient leaf to 1e-6 absolute (leaves of order 0.1-1;
    fp32 reordering reads ~1e-7), each remat setting of the port against
    jax.grad of the JAX package's lm_loss (its remat recomputes the same
    values, so one reference per capacity serves the three)."""
    jparams, tparams = weights
    _, tcfg = _cfgs(capacity_factor=cf, remat=remat, remat_policy=policy)
    toks = _tokens(1, b=4)
    (jl, jm), jg = _jax_value_and_grad(jparams, toks,
                                       _cfgs(capacity_factor=cf)[0], mesh)
    params = _trainable(tparams)
    loss, metrics = lm_loss(params, torch.as_tensor(toks), tcfg,
                            return_metrics=True)
    loss.backward()
    assert set(metrics) == set(jm) == MOE_KEYS | {"cross_entropy"}
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    for key in jm:
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(jm[key]), rtol=1e-6, err_msg=key)
    want, got = _flat(jax.device_get(jg)), _flat(_grads(params))
    assert set(want) == set(got)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-6,
                                   err_msg=path)


def test_three_step_trajectory_matches_jax(weights, mesh):
    """Losses and router metrics of 3 steps (clip active, lr 1e-3) to
    1e-5, params after them to 1e-5."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    j_init, j_step = jax_make_train_step(jcfg, mesh, learning_rate=1e-3)
    t_init, t_step = make_train_step(tcfg, device="cpu", learning_rate=1e-3)
    jstate, tstate = j_init(jax.random.key(0)), t_init(params=tparams)
    for i in range(3):
        toks = _tokens(10 + i, b=4)
        jstate, jm = j_step(jstate, toks)
        tstate, tm = t_step(tstate, toks)
        assert set(tm) == set(jm) == MOE_KEYS | {"loss", "cross_entropy"}
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       atol=1e-5, err_msg=key)
    want = _flat(jax.device_get(jstate.params))
    got = _flat(params_to_numpy(tstate.params))
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-5,
                                   err_msg=path)


def test_balance_loss_recovers_a_collapsed_router(weights):
    """The JAX package's recovery test on the port: a router shrunk and
    tilted toward expert 0, top-1. With the balance loss the assignment
    spreads again (entropy toward ln E, drops to 0); without it the
    collapse stays (top-1 combine weights are 1, so CE alone gives the
    router no signal)."""
    jparams, _ = weights

    def run(balance_coef, steps=40):
        cfg = TransformerConfig(
            vocab_size=128, d_model=32, n_layers=2, n_heads=2, head_dim=16,
            d_ff=64, max_seq=64, n_experts=4, expert_top_k=1,
            dtype="float32", remat=False, moe_balance_coef=balance_coef)
        jcfg = JaxConfig(**dataclasses.asdict(cfg))
        params = params_from_numpy(jax.device_get(_jax_init(
            jax.random.key(0), jcfg)), cfg, "cpu")
        tokens = np.random.default_rng(1).integers(0, 128, (4, 17))
        embed = params["embed"]
        direction = embed[torch.as_tensor(np.unique(tokens))]
        direction = (direction / direction.norm(dim=-1, keepdim=True)).sum(0)
        router = params["layers"]["router"] * 0.05
        router[:, :, 0] += 0.1 * direction
        params["layers"]["router"] = router
        init_fn, step_fn = make_train_step(cfg, device="cpu",
                                           learning_rate=1e-2)
        state = init_fn(params=params)
        hist = []
        for _ in range(steps):
            state, metrics = step_fn(state, tokens)
            hist.append({k: float(v) for k, v in metrics.items()})
        return hist

    with_aux, without = run(0.05), run(0.0)
    ln_e = float(np.log(4))
    assert with_aux[0]["moe_entropy"] < 0.65 * ln_e
    assert with_aux[0]["moe_drop_rate"] > 0.3
    assert with_aux[-1]["moe_entropy"] > 0.9 * ln_e
    assert with_aux[-1]["moe_drop_rate"] < 0.05
    assert without[-1]["moe_entropy"] < 0.7 * ln_e
    assert without[-1]["moe_drop_rate"] > 0.3


def test_forward_refuses_experts_that_do_not_fit_the_mesh(weights):
    _, tparams = weights
    _, tcfg = _cfgs()
    half = {**tparams, "layers": {
        k: (v[:, :2] if k in tf.EXPERT_LEAVES else v)
        for k, v in tparams["layers"].items()}}
    with pytest.raises(ValueError, match="experts per rank"):
        forward(half, torch.as_tensor(_tokens(0)), tcfg)


# ---------------------------------------------------------------------------
# Decode and serving
# ---------------------------------------------------------------------------

def _decode_setup(seed=7, **overrides):
    kw = {**DECODE, **overrides}
    jcfg, tcfg = JaxConfig(**kw), TransformerConfig(**kw)
    jparams = _jax_init(jax.random.key(seed), jcfg)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams),
                                                   tcfg, "cpu")


def test_decode_weights_match_jax_and_keep_an_fp32_router():
    jcfg, jparams, tcfg, tparams = _decode_setup(
        dtype="bfloat16", n_kv_heads=2)
    want = _flat(jax.device_get(jax_decode_weights(jparams, jcfg)))
    from tony_tpu_torch.models import decode_weights

    fused = decode_weights(tparams, tcfg)
    assert fused["layers"]["router"].dtype == torch.float32
    assert fused["layers"]["gate_up"].shape == (2, 4, 32, 128)
    assert fused["layers"]["gate_up"].dtype == torch.bfloat16
    got = _flat(fused)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    # The fused layout converts like the raw one.
    again = params_from_numpy(jax.device_get(jax_decode_weights(
        jparams, jcfg)), tcfg, "cpu")
    assert again["layers"]["router"].dtype == torch.float32


def test_greedy_decode_matches_the_training_forward():
    """Cached greedy decode (dense mixture) emits what full-recompute
    argmax of the training forward does, at a capacity that drops
    nothing (decode never drops)."""
    _, _, cfg, params = _decode_setup()
    prompt = np.random.default_rng(3).integers(0, 64, (2, 6))
    got = generate(params, prompt, cfg, 5, device="cpu")
    ctx = torch.as_tensor(prompt)
    want = []
    with torch.no_grad():
        for _ in range(5):
            nxt = forward(params, ctx, cfg)[:, -1].argmax(-1)
            want.append(nxt)
            ctx = torch.cat([ctx, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(got.numpy(), torch.stack(want, 1).numpy())


@pytest.mark.parametrize("n_experts", [4, 16])
def test_routed_decode_gives_the_dense_mixture_tokens(n_experts):
    _, _, base, params = _decode_setup(seed=11, n_experts=n_experts,
                                       n_kv_heads=0)
    prompt = np.random.default_rng(5).integers(0, 64, (3, 7))
    out = {mode: generate(params, prompt, dataclasses.replace(
        base, moe_decode_mode=mode), 6, device="cpu").numpy()
        for mode in ("routed", "dense", "auto")}
    np.testing.assert_array_equal(out["routed"], out["dense"])
    np.testing.assert_array_equal(out["auto"], out["dense"])
    with pytest.raises(ValueError, match="moe_decode_mode"):
        generate(params, prompt, dataclasses.replace(
            base, moe_decode_mode="sparse"), 2, device="cpu")


@pytest.mark.parametrize("mode", ["dense", "routed"])
def test_greedy_tokens_equal_jax_generate(mode):
    jcfg, jparams, tcfg, tparams = _decode_setup(seed=9,
                                                 moe_decode_mode=mode)
    prompt = np.random.default_rng(4).integers(0, 64, (2, 5)).astype(
        np.int32)
    want = np.asarray(jax_generate(jparams, jnp.asarray(prompt), jcfg, 8))
    session = DecodeSession(tparams, tcfg, device="cpu")
    assert session.params["layers"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(session.generate(prompt, 8).numpy(), want)


def test_moe_serving_engine_equals_generate():
    """The JAX serving test's MoE trunk parity: staggered prompts through
    the slot engine (chunked prefill, slot decode, both on the dense
    mixture) each equal to a single-request generate."""
    _, _, cfg, params = _decode_setup(seed=0, n_experts=2, n_kv_heads=2,
                                      max_seq=96)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (4, 9, 13)]
    eng = ServingEngine(params, cfg, device="cpu", slots=2, prefill_chunk=4)
    reqs = [eng.submit(p, 5) for p in prompts]
    for _ in range(500):
        if all(r.done() for r in reqs):
            break
        eng.step()
    eng.close()
    for p, r in zip(prompts, reqs):
        want = generate(params, p[None], cfg, 5, device="cpu")[0].numpy()
        np.testing.assert_array_equal(np.asarray(r.result(1)["tokens"]),
                                      want)


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1, 2, 1, 1), (2, 1, 2, 1, 2),
                                   (4, 1, 2, 1, 1), (1, 2, 4, 1, 1),
                                   (3, 1, 1, 1, 2)])
def test_dp_ep_group_ranks_are_a_function_of_the_spec(shape):
    """Ranks lie in C order over (dp, pp, ep, sp, tp): a dp x ep group is
    the ranks that share pp, sp and tp, dp major; the groups partition
    the world, and a one-axis group's list is that axis's line."""
    spec = MeshSpec(*shape)
    groups = axis_group_ranks(spec, ("dp", "ep"))
    assert sorted(r for g in groups for r in g) == list(range(
        spec.num_devices))
    coords = {r: np.unravel_index(r, spec.shape) for r in
              range(spec.num_devices)}
    for g in groups:
        assert len(g) == spec.dp * spec.ep
        others = {tuple(coords[r][i] for i in (1, 3, 4)) for r in g}
        assert len(others) == 1
        assert [(coords[r][0], coords[r][2]) for r in g] == [
            (d, e) for d in range(spec.dp) for e in range(spec.ep)]
    # The same lists from the JAX package's mesh layout of the spec.
    jmesh = jax_build_mesh(JaxMeshSpec(*shape),
                           devices=jax.devices()[:spec.num_devices])
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    grid = np.vectorize(lambda d: ids[d.id])(jmesh.devices)
    dims = [AXES.index("dp"), AXES.index("ep")]
    rest = [i for i in range(5) if i not in dims]
    want = grid.transpose(rest + dims).reshape(-1, spec.dp * spec.ep)
    assert groups == want.tolist()
    for axis in AXES:
        lines = axis_group_ranks(spec, axis)
        assert all(len(g) == getattr(spec, axis) for g in lines)


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "dots")])
def test_ep_path_on_one_rank_is_bit_equal_to_no_mesh(weights, monkeypatch,
                                                     remat, policy):
    """A one-rank gloo group on a HashStore: make_train_step over the
    one-rank mesh runs the manual MoE form (its all_to_all runs 4 times a
    layer a step: out, back, and the two of the backward; 6 under remat,
    which exchanges again when it recomputes the layer) and gives the
    same losses, metrics and params as mesh=None, bit for bit, with drops
    on."""
    _, tparams = weights
    _, cfg = _cfgs(remat=remat, remat_policy=policy)
    calls = []
    real = dist.all_to_all_single
    monkeypatch.setattr(dist, "all_to_all_single",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    batches = [_tokens(20 + i, b=4) for i in range(2)]
    init_fn, step_fn = make_train_step(cfg, device="cpu", learning_rate=1e-3)
    plain = init_fn(params=tparams)
    plain_metrics = [step_fn(plain, b)[1] for b in batches]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = build_mesh(MeshSpec(), "cpu", timeout_s=60)
        m_init, m_step = make_train_step(cfg, mesh, device="cpu",
                                         learning_rate=1e-3)
        state = m_init(params=tparams)
        metrics = [m_step(state, b)[1] for b in batches]
    finally:
        dist.destroy_process_group()
    assert len(calls) == (6 if remat else 4) * cfg.n_layers * len(batches)
    for got, want in zip(metrics, plain_metrics):
        assert set(got) == set(want) == MOE_KEYS | {"loss", "cross_entropy"}
        for key in want:
            assert torch.equal(got[key], want[key]), key
    got, want = _flat(state.params), _flat(plain.params)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def _manual_layer(jparams, x, cfg):
    """JAX's ``_moe_mlp_manual`` of layer 0 under shard_map on an ep=2
    mesh of two devices: the batch split over (dp, ep), the experts over
    ep. Returns (out [B, T, d], aux)."""
    jmesh = jax_build_mesh(JaxMeshSpec(ep=2), devices=jax.devices()[:2])
    lp = {k: np.asarray(v[0]) for k, v in jparams["layers"].items()}
    specs = {k: (P("ep") if k in tf.EXPERT_LEAVES else P()) for k in lp}
    fn = jax.jit(jax.shard_map(
        lambda xs, lps: jax_tf._moe_mlp_manual(xs, lps, cfg), mesh=jmesh,
        in_specs=(P(("dp", "ep")), specs),
        out_specs=(P(("dp", "ep")), P()), check_vma=False))
    with jax.sharding.set_mesh(jmesh):
        out, aux = fn(jnp.asarray(x), lp)
    return np.asarray(out), {k: float(v) for k, v in aux.items()}


def _jax_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def test_ep2_in_two_gloo_ranks_matches_jax(weights, tmp_path):
    """One launch of two gloo ranks over an ep=2 mesh (2 of the 4 experts
    each, the batch split over them):

    1. At cf = E (nothing drops), 3 steps: each step's loss and router
       metrics equal JAX's step on a MeshSpec(ep=2) mesh of two devices to
       rtol 1e-5, and each step's reduced gradients equal jax.grad of its
       lm_loss there within 1e-5 of each leaf's largest gradient. One
       step with remat "dots", and one over a dp=2 mesh of the same two
       ranks (the experts whole on each, their d dimension split), give
       the same loss and gradients.
    2. At cf 1.25 (drops), each rank's MoE-layer output equals JAX's
       ``_moe_mlp_manual`` under shard_map on the same ep=2 mesh (whose
       capacity is local like the port's) within 1e-6 of its largest
       entry, and the router values to rtol 1e-6.
    3. The ep-sharded state restores a checkpoint JAX's manager wrote from
       its ep=2 state (exactly), and after one more step the port's save
       carries the shard indices JAX's ep=2 shardings give each device and
       restores bit for bit in JAX's manager on the ep=2 mesh.
    """
    jparams, _ = weights
    np.savez(tmp_path / "w.npz", **_flat(jax.device_get(jparams)))
    batches = np.stack([_tokens(30 + i, b=4) for i in range(3)])
    np.save(tmp_path / "batches.npy", batches)
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 16, 32))
         + 2.0 * rng.standard_normal(32)).astype(np.float32)
    np.savez(tmp_path / "x.npz", x=x)

    jmesh = jax_build_mesh(JaxMeshSpec(ep=2), devices=jax.devices()[:2])
    jcfg, _ = _cfgs(capacity_factor=4.0)
    steps = []
    with jax.sharding.set_mesh(jmesh):
        j_init, j_step = jax_make_train_step(jcfg, jmesh, learning_rate=1e-3,
                                             grad_clip=1e9)
        jstate = j_init(jax.random.key(0))
        for i, toks in enumerate(batches):
            grads = _jax_value_and_grad(jstate.params, jnp.asarray(toks),
                                        jcfg, jmesh)[1]
            jstate, jm = j_step(jstate, toks)
            steps.append(({k: float(v) for k, v in jm.items()},
                          _flat(jax.device_get(grads))))
            if i == 1:
                JaxManager(tmp_path / "jax").save(2, jstate, blocking=True)
                cstate = jax.device_get(jstate)

    results = launch("moe_ep", tmp_path, args=(
        tmp_path / "w.npz", tmp_path / "batches.npy", tmp_path / "x.npz",
        tmp_path / "jax", tmp_path / "port"))
    ranks = [dict(np.load(tmp_path / f"moe_ep.{r}.npz")) for r in range(2)]

    # 1. Losses, metrics and gradients of 3 steps.
    for r, res in enumerate(results):
        for i, (jm, jg) in enumerate(steps):
            for key, val in jm.items():
                np.testing.assert_allclose(res["metrics"][i][key], val,
                                           rtol=1e-5, err_msg=f"{i} {key}")
            for path, want in jg.items():
                key = f"step{i}/.params" + "".join(
                    f"[{k!r}]" for k in path.split("/"))
                scale = np.abs(want).max()
                assert np.abs(ranks[r][key] - want).max() <= 1e-5 * scale, \
                    (i, path)
                if i == 0:
                    for other in ("dots/", "dp2/"):
                        got = ranks[r][key.replace("step0/", other)]
                        assert np.abs(got - want).max() <= 1e-5 * scale, \
                            (other, path)
        # The expert FFN leaves and the router are split over ep.
        assert {k: v for k, v in res["split"].items()} == {
            ".params['layers']['router']": [None, None, "ep"],
            ".params['layers']['w_gate']": [None, "ep", None, None],
            ".params['layers']['w_up']": [None, "ep", None, None],
            ".params['layers']['w_down']": [None, "ep", None, None],
        }
        assert res["all_to_all_calls"] > 0
        for key in ("dots_loss", "dp_loss"):
            np.testing.assert_allclose(res[key], steps[0][0]["loss"],
                                       rtol=1e-5, err_msg=key)

    # 2. The layer with drops against the manual form.
    _, tcfg = _cfgs()
    jcfg_drop, _ = _cfgs(capacity_factor=1.25)
    want_out, want_aux = _manual_layer(jparams, x, jcfg_drop)
    assert want_aux["moe_drop_rate"] > 0
    for r, res in enumerate(results):
        mine = want_out[2 * r:2 * r + 2]
        assert _rel_err(ranks[r]["layer/out"], mine) <= 1e-6
        for key, val in want_aux.items():
            np.testing.assert_allclose(res["layer_aux"][key], val, rtol=1e-6,
                                       err_msg=key)

    # 3. The checkpoint both ways.
    want = _jax_flat(cstate)
    for r, res in enumerate(results):
        assert res["round_trip_equal"] and res["step"] == 3
        got = {k[len("restored/"):]: v for k, v in ranks[r].items()
               if k.startswith("restored/")}
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=path)
    saved = {k[len("saved/"):]: v for k, v in ranks[0].items()
             if k.startswith("saved/")}
    shardings = {jax.tree_util.keystr(p): sh for p, sh in
                 jax.tree_util.tree_flatten_with_path(_sharding_for_tree(
                     cstate, jax_param_roles(jcfg), jmesh))[0]}
    split = 0
    for pid, device in enumerate(jmesh.devices.reshape(-1)):
        with np.load(tmp_path / "port" / "step_3" / f"process_{pid}.npz") \
                as npz:
            manifest = json.loads(bytes(npz[JAX_MANIFEST]).decode())
        assert set(manifest) == set(want)
        for path, info in manifest.items():
            shape = tuple(want[path].shape)
            index = _normalize_index(
                shardings[path].devices_indices_map(shape)[device], shape)
            assert info["shard_indices"] == [index], path
            split += index != [[0, d] for d in shape]
    assert split == 2 * 3 * 4  # router + 3 expert leaves, mu and nu, 2 ranks
    with jax.sharding.set_mesh(jmesh):
        restored = JaxManager(tmp_path / "port").restore(
            j_init(jax.random.key(1)))
    got = _jax_flat(restored)
    for path in saved:
        np.testing.assert_array_equal(got[path], saved[path], err_msg=path)
