"""The port's tensor parallelism (tp) held against the JAX package on the
CPU: Megatron's split of the dense trunk over explicit collectives
(``copy_to_tp``/``reduce_from_tp``, the vocab-parallel cross-entropy), its
train step, its checkpoints and the tp-sharded ``DecodeSession(mesh=)``.

Single-process cases: the per-part split of the fused decode layout, and the
vocab-parallel loss on a one-rank group (the same bits as the plain loss).
Then ONE launch of two gloo ranks (``torch_ranks.launch``, program
``train_tp``) against the JAX package's step, manager and sharded session on
meshes of two virtual CPU devices. Tiny config (2 layers, d 32, GQA 4/2,
d_ff 64, vocab 64), fp32, weights from the JAX initializer.
"""

from __future__ import annotations

import json
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_moe import _flat, _jax_flat, _jax_value_and_grad, _tokens
from tony_tpu.checkpoint import CheckpointManager as JaxManager
from tony_tpu.checkpoint import _MANIFEST as JAX_MANIFEST
from tony_tpu.checkpoint.manager import _normalize_index
from tony_tpu.models import DecodeSession as JaxDecodeSession
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models import init_params as jax_init_params
from tony_tpu.models import param_roles as jax_param_roles
from tony_tpu.models.decode import decode_weights as jax_decode_weights
from tony_tpu.models.train import _sharding_for_tree
from tony_tpu.models.train import make_train_step as jax_make_train_step
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu_torch.interop import params_from_numpy
from tony_tpu_torch.models import TransformerConfig, decode_weights
from tony_tpu_torch.models.decode import shard_decode_weights
from tony_tpu_torch.ops import (
    softmax_cross_entropy,
    vocab_parallel_cross_entropy,
)
from tony_tpu_torch.parallel import MeshSpec, build_mesh
from tony_tpu_torch.parallel.mesh import AXES
from torch_ranks import TINY, launch

torch.set_num_threads(1)

_jax_init = jax.jit(jax_init_params, static_argnums=1)
NEW_TOKENS = 6


@pytest.fixture(scope="module")
def jparams():
    return _jax_init(jax.random.key(0), JaxConfig(**TINY))


def _global_norm(grads: dict) -> float:
    return float(np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                             for g in grads.values())))


def _key(path: str) -> str:
    """The ``.params`` keystr of a ``/``-joined params path."""
    return ".params" + "".join(f"[{k!r}]" for k in path.split("/"))


class _Position:
    """A mesh position for the placement code, which reads only the axis
    sizes and this position's coordinates."""

    def __init__(self, spec: MeshSpec, coords: tuple[int, ...]):
        self.spec, self.coords = spec, coords

    def size(self, dim: int) -> int:
        return self.spec.shape[dim]

    def get_local_rank(self, name: str) -> int:
        return self.coords[AXES.index(name)]


def _jax_steps(jparams, jcfg, jmesh, batches, clip, save_dir=None):
    """JAX's step on ``jmesh``: per step (metrics, jax.grad's gradients
    scaled by optax's clip rule, the scale); with ``save_dir`` the state
    after step 2 is saved there by JAX's manager and returned too."""
    with jax.sharding.set_mesh(jmesh):
        j_init, j_step = jax_make_train_step(jcfg, jmesh, learning_rate=1e-3,
                                             grad_clip=clip)
        jstate = j_init(jax.random.key(0))
        steps, saved = [], None
        for i, toks in enumerate(batches):
            grads = _flat(jax.device_get(_jax_value_and_grad(
                jstate.params, jnp.asarray(toks), jcfg, jmesh)[1]))
            scale = min(1.0, clip / _global_norm(grads))
            jstate, jm = j_step(jstate, toks)
            steps.append(({k: float(v) for k, v in jm.items()},
                          {k: v * scale for k, v in grads.items()}, scale))
            if i == 1 and save_dir is not None:
                JaxManager(save_dir).save(2, jstate, blocking=True)
                saved = jax.device_get(jstate)
    return steps, saved, j_init


def _half_norm_clip(jparams, jcfg, jmesh, tokens) -> float:
    with jax.sharding.set_mesh(jmesh):
        return 0.5 * _global_norm(_flat(jax.device_get(_jax_value_and_grad(
            jparams, jnp.asarray(tokens), jcfg, jmesh)[1])))


@pytest.mark.parametrize("tp", [2, 4])
def test_decode_pieces_split_each_part(jparams, tp):
    """shard_decode_weights cuts each part of the fused layout on its own:
    rank i's qkv holds its q, k and v heads (not a block of the packed
    axis, which would give rank 0 only query heads), its gate_up its gate
    and up columns; wo, w_down and unembed their head, ff and vocab
    blocks; the norms and embed stay whole. Against decode_weights of the
    training leaves cut per part; the pieces put together give the whole
    layout back."""
    tcfg = TransformerConfig(**{**TINY, "n_heads": 8, "n_kv_heads": 4})
    jcfg = JaxConfig(**{**TINY, "n_heads": 8, "n_kv_heads": 4})
    raw = params_from_numpy(jax.device_get(_jax_init(jax.random.key(1),
                                                     jcfg)), tcfg, "cpu")
    whole = decode_weights(raw, tcfg)
    lp = raw["layers"]
    h, hkv, f = tcfg.n_heads // tp, tcfg.kv_heads // tp, tcfg.d_ff // tp
    v = tcfg.vocab_size // tp
    pieces = []
    for i in range(tp):
        mine = shard_decode_weights(whole, tcfg,
                                    _Position(MeshSpec(tp=tp),
                                              (0, 0, 0, 0, i)))
        got = mine["layers"]
        want_qkv = torch.cat([lp["wq"][:, :, i * h:(i + 1) * h],
                              lp["wk"][:, :, i * hkv:(i + 1) * hkv],
                              lp["wv"][:, :, i * hkv:(i + 1) * hkv]], dim=2)
        assert torch.equal(got["qkv"], want_qkv)
        packed = whole["layers"]["qkv"].shape[2] // tp
        assert not torch.equal(got["qkv"], whole["layers"]["qkv"][
            :, :, i * packed:(i + 1) * packed])
        assert torch.equal(got["gate_up"], torch.cat([
            lp["w_gate"][..., i * f:(i + 1) * f],
            lp["w_up"][..., i * f:(i + 1) * f]], dim=-1))
        assert torch.equal(got["wo"], lp["wo"][:, i * h:(i + 1) * h])
        assert torch.equal(got["w_down"], lp["w_down"][:, i * f:(i + 1) * f])
        assert torch.equal(mine["unembed"],
                           raw["unembed"][:, i * v:(i + 1) * v])
        for name in ("ln1", "ln2"):
            assert torch.equal(got[name], whole["layers"][name])
        for name in ("embed", "final_norm"):
            assert torch.equal(mine[name], whole[name])
        pieces.append(mine)
    qkvs = [p["layers"]["qkv"] for p in pieces]
    for j, (start, n) in enumerate(((0, h), (h, hkv), (h + hkv, hkv))):
        part = torch.cat([q[:, :, start:start + n] for q in qkvs], dim=2)
        full = (lp["wq"], lp["wk"], lp["wv"])[j]
        assert torch.equal(part, full), j
    with pytest.raises(ValueError, match="whole fused layout"):
        shard_decode_weights(pieces[0], tcfg,
                             _Position(MeshSpec(tp=tp), (0, 0, 0, 0, 0)))
    # JAX's fused layout is the same whole.
    jwhole = jax.device_get(jax_decode_weights(_jax_init(jax.random.key(1),
                                                         jcfg), jcfg))
    np.testing.assert_array_equal(whole["layers"]["qkv"].numpy(),
                                  np.asarray(jwhole["layers"]["qkv"]))


def test_vocab_parallel_loss_on_one_rank_is_the_plain_loss():
    """On a one-rank gloo group (a HashStore; destroyed in finally) the
    vocab-parallel cross-entropy runs its three all_reduces and gives
    softmax_cross_entropy's loss and gradient bit for bit, from fp32 and
    from bf16 logits."""
    gen = torch.Generator().manual_seed(3)
    labels = torch.randint(0, 64, (2, 7), generator=gen)
    base = torch.randn(2, 7, 64, generator=gen) * 4
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = build_mesh(MeshSpec(tp=1), "cpu", timeout_s=60)
        for dtype in (torch.float32, torch.bfloat16):
            logits = base.to(dtype).requires_grad_()
            want = softmax_cross_entropy(logits, labels)
            (g_want,) = torch.autograd.grad(want, logits)
            got = vocab_parallel_cross_entropy(logits, labels, mesh)
            (g_got,) = torch.autograd.grad(got, logits)
            assert got.dtype == torch.float32
            assert torch.equal(got, want), dtype
            assert torch.equal(g_got, g_want), dtype
    finally:
        dist.destroy_process_group()


def test_tp2_in_two_gloo_ranks_matches_jax(jparams, tmp_path):
    """One launch of two gloo ranks over a tp=2 mesh, each holding its
    heads, ff columns and vocab block, both fed the same batches:

    1. 3 steps with a clip at half the first step's global norm (it
       bites): each step's loss equals JAX's step on a MeshSpec(tp=2) mesh
       of two devices to rtol 1e-6, and each step's clipped gradients
       (gathered) equal jax.grad's, scaled by optax's rule, within 1e-5
       of each leaf's largest, at remat none and "full"; one step at
       "dots" too. The replicated norms' gradients are the same bits on
       both ranks.
    2. The tp-split state restores a checkpoint JAX's manager wrote from
       its tp=2 state exactly; after one more step the port's save
       carries the shard indices JAX's tp=2 shardings give each device
       and restores bit for bit in JAX's manager.
    3. DecodeSession(mesh=) at tp=2 and at dp=2 (batch rows over dp):
       greedy tokens equal JAX's DecodeSession(mesh=) on the same mesh and
       the port's session without a mesh; each rank holds its per-part
       pieces and a cache of Hkv/tp heads (tp) or B/dp rows (dp), and
       refresh() keeps them. A temperature draw, from generators seeded
       differently on the two ranks, gives the same tokens on both.
    4. The refusals: MoE x tp and a tp that does not divide the K/V heads
       (train and decode), MoE over an sp mesh and over a pp mesh.
    """
    jcfg = JaxConfig(**TINY)
    np.savez(tmp_path / "w.npz", **_flat(jax.device_get(jparams)))
    batches = np.stack([_tokens(50 + i, b=4) for i in range(3)])
    np.save(tmp_path / "batches.npy", batches)
    prompt = _tokens(60, b=4, t=6)
    np.save(tmp_path / "prompt.npy", prompt)

    jmesh = jax_build_mesh(JaxMeshSpec(tp=2), devices=jax.devices()[:2])
    clip = _half_norm_clip(jparams, jcfg, jmesh, batches[0])
    steps, cstate, j_init = _jax_steps(jparams, jcfg, jmesh, batches, clip,
                                       tmp_path / "jax")
    assert steps[0][2] < 0.6  # the clip bites
    dp_mesh = jax_build_mesh(JaxMeshSpec(dp=2), devices=jax.devices()[:2])
    want_tokens = {
        tag: np.asarray(JaxDecodeSession(jparams, jcfg, mesh=m).generate(
            jnp.asarray(prompt), max_new_tokens=NEW_TOKENS))
        for tag, m in (("tp", jmesh), ("dp", dp_mesh))}

    results = launch("train_tp", tmp_path, args=(
        tmp_path / "w.npz", tmp_path / "batches.npy", repr(clip),
        tmp_path / "jax", tmp_path / "port", tmp_path / "prompt.npy"))
    ranks = [dict(np.load(tmp_path / f"train_tp.{r}.npz")) for r in range(2)]

    # 1. Losses and clipped gradients, each remat setting.
    for r, res in enumerate(results):
        for tag, metrics in res["metrics"].items():
            assert len(metrics) == (1 if tag == "dots" else 3)
            for i, got in enumerate(metrics):
                jm, jg, _ = steps[i]
                for key, val in jm.items():
                    np.testing.assert_allclose(got[key], val, rtol=1e-6,
                                               err_msg=f"{tag} {i} {key}")
                for path, want in jg.items():
                    diff = np.abs(ranks[r][f"{tag}/step{i}/{_key(path)}"]
                                  - want).max()
                    assert diff <= 1e-5 * np.abs(want).max(), (tag, i, path)
        assert res["split"] == {
            ".params['embed']": ["tp", None],
            ".params['layers']['wq']": [None, None, "tp", None],
            ".params['layers']['wk']": [None, None, "tp", None],
            ".params['layers']['wv']": [None, None, "tp", None],
            ".params['layers']['wo']": [None, "tp", None, None],
            ".params['layers']['w_gate']": [None, None, "tp"],
            ".params['layers']['w_up']": [None, None, "tp"],
            ".params['layers']['w_down']": [None, "tp", None],
            ".params['unembed']": [None, "tp"],
        }
    for name in ("ln1", "ln2", "final_norm"):
        got = [ranks[r][f"local/{name}"] for r in range(2)]
        assert np.abs(got[0]).max() > 0
        np.testing.assert_array_equal(got[0], got[1], err_msg=name)

    # 2. The checkpoint both ways.
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
    assert split == 2 * 3 * 9  # 9 tp-split leaves, params/mu/nu, 2 ranks
    with jax.sharding.set_mesh(jmesh):
        restored = JaxManager(tmp_path / "port").restore(
            j_init(jax.random.key(1)))
    got = _jax_flat(restored)
    for path in saved:
        np.testing.assert_array_equal(got[path], saved[path], err_msg=path)

    # 3. Sharded decode.
    tcfg = TransformerConfig(**TINY)
    whole = decode_weights(params_from_numpy(jax.device_get(jparams), tcfg,
                                             "cpu"), tcfg)
    for r, res in enumerate(results):
        for tag in ("tp", "dp"):
            np.testing.assert_array_equal(ranks[r][f"decode/{tag}"],
                                          want_tokens[tag], err_msg=tag)
            np.testing.assert_array_equal(ranks[r][f"decode/{tag}"],
                                          ranks[r]["decode/plain"])
            pos = (0, 0, 0, 0, r) if tag == "tp" else (r, 0, 0, 0, 0)
            spec = MeshSpec(tp=2) if tag == "tp" else MeshSpec(dp=2)
            mine = shard_decode_weights(whole, tcfg, _Position(spec, pos))
            for part in ("qkv", "gate_up", "wo", "w_down"):
                np.testing.assert_array_equal(
                    ranks[r][f"decode/{tag}/{part}"],
                    mine["layers"][part].numpy(), err_msg=(tag, part))
            np.testing.assert_array_equal(ranks[r][f"decode/{tag}/unembed"],
                                          mine["unembed"].numpy())
        assert ranks[r]["decode/tp/qkv"].shape[2] == (4 + 2 * 2) // 2
        assert res["cache_tp"] == [2, 4, 12, 1, 16]
        assert res["cache_dp"] == [2, 2, 12, 2, 16]
        assert res["refresh_tp"] == [2, 32, 4, 16]
        assert res["refresh_dp"] == [2, 32, 8, 16]
    temp = [ranks[r]["decode/temperature"] for r in range(2)]
    np.testing.assert_array_equal(temp[0], temp[1])
    assert temp[0].shape == (4, NEW_TOKENS)
    assert not np.array_equal(temp[0], ranks[0]["decode/plain"])

    # 4. The refusals that stay; an MoE trunk's step and session run over
    # tp, its step and session over sp, its forward and session over pp.
    refused = results[0]["refused"]
    for key in ("kv_train", "kv_decode"):
        assert refused[key].startswith("ValueError") and \
            "must divide kv_heads 1" in refused[key], key
    for key in ("moe_train", "moe_decode", "pp_forward", "pp_decode",
                "sp_train", "sp_decode"):
        assert refused[key] == "", (key, refused[key])
