"""The port's MoE trunk over tensor parallelism (tp) held against the JAX
package on the CPU: each rank holds its F/tp columns of every resident
expert, the normed input and the combine weights enter the experts through
``copy_to_tp`` and the combined output leaves through ``reduce_from_tp``
(JAX's ``_moe_mlp_manual`` sums it with ``lax.psum(out, "tp")``), the
train step over tp beside dp and ep, its checkpoints, and the sharded
``DecodeSession(mesh=)`` over ep x tp (the experts split over ep, their ff
over tp, as the JAX package's ``decode_param_specs`` places them).

Single-process cases: the expert branch of the fused decode layout's
per-part split (``shard_decode_weights`` with a fake mesh position), and
the mesh checks. Then ONE launch of four gloo ranks (``torch_ranks.launch``,
program ``moe_tp``) against the JAX package's manual MoE layer under
``shard_map``, its step, manager and sharded session on meshes of four
virtual CPU devices. The JAX package's MoE test config (vocab 128, d 32, 2
layers, E 4, top-2, fp32) with GQA 4/2 heads, which tp 2 divides; weights
from the JAX initializer.
"""

from __future__ import annotations

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_moe import _flat, _jax_flat, _rel_err
from test_torch_tp import (
    _Position,
    _half_norm_clip,
    _jax_init,
    _jax_steps,
    _key,
)
from tony_tpu.checkpoint import CheckpointManager as JaxManager
from tony_tpu.checkpoint import _MANIFEST as JAX_MANIFEST
from tony_tpu.checkpoint.manager import _normalize_index
from tony_tpu.models import DecodeSession as JaxDecodeSession
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models import param_roles as jax_param_roles
from tony_tpu.models import transformer as jax_tf
from tony_tpu.models.train import _sharding_for_tree
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu_torch.interop import params_from_numpy
from tony_tpu_torch.models import TransformerConfig, decode_weights
from tony_tpu_torch.models.decode import (
    check_decode_mesh,
    shard_decode_weights,
)
from tony_tpu_torch.models.transformer import check_mesh
from tony_tpu_torch.parallel import MeshSpec
from torch_ranks import MOE_DECODE, MOE_MESH, MOE_TP_RUNS, launch

torch.set_num_threads(1)

MOE_KEYS = ("moe_balance", "moe_zloss", "moe_drop_rate", "moe_entropy")
NEW_TOKENS = 5


@pytest.fixture(scope="module")
def jparams():
    return _jax_init(jax.random.key(0), JaxConfig(**MOE_MESH))


def jax_manual_layer(jparams, x, jcfg, axes: dict) -> tuple:
    """JAX's ``_moe_mlp_manual`` of layer 0 under shard_map on a mesh of
    ``axes``: the batch split over (dp, ep), the positions over sp, the
    experts over ep and their ff over tp. Returns (out [B, T, d], aux)."""
    n = math.prod(axes.values())
    jmesh = jax_build_mesh(JaxMeshSpec(**axes), devices=jax.devices()[:n])
    lp = {k: np.asarray(v[0]) for k, v in jparams["layers"].items()}
    specs = {k: P() for k in lp}
    specs["w_gate"] = specs["w_up"] = P("ep", None, "tp")
    specs["w_down"] = P("ep", "tp", None)
    fn = jax.jit(jax.shard_map(
        lambda xs, lps: jax_tf._moe_mlp_manual(xs, lps, jcfg), mesh=jmesh,
        in_specs=(P(("dp", "ep"), "sp"), specs),
        out_specs=(P(("dp", "ep"), "sp"), P()), check_vma=False))
    with jax.sharding.set_mesh(jmesh):
        out, aux = fn(jnp.asarray(x), lp)
    return np.asarray(out), {k: float(v) for k, v in aux.items()}


def rank_block(want, axes: dict, rank: int):
    """Rank ``rank``'s block of a [B, T, ...] array on a mesh of ``axes``:
    its data rows over dp x ep, its positions over sp."""
    spec = MeshSpec(**axes)
    coords = np.unravel_index(rank, spec.shape)
    dp, _, ep, sp, _ = coords
    rows = want.shape[0] // (spec.dp * spec.ep)
    row = dp * spec.ep + ep
    t = want.shape[1] // spec.sp
    return want[row * rows:(row + 1) * rows, sp * t:(sp + 1) * t]


def layer_input(seed: int):
    """[4, 16, 32] with a shared offset that skews the routing (cf 1.25
    drops)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 16, 32))
            + 2.0 * rng.standard_normal(32)).astype(np.float32)


def check_moe_steps(results, ranks, steps, tag, grad_steps=None) -> None:
    """Every rank's losses of ``tag``'s steps equal JAX's to rtol 2e-5,
    the four router values to rtol 1e-5, and its gathered clipped
    gradients (of the first ``grad_steps`` steps; default all) within
    1e-5 of each leaf's largest."""
    for r, res in enumerate(results):
        metrics = res["metrics"][tag]
        assert len(metrics) == len(steps)
        for i, (jm, jg, _) in enumerate(steps):
            assert set(MOE_KEYS) <= set(metrics[i])
            for key, val in jm.items():
                rtol = 1e-5 if key in MOE_KEYS else 2e-5
                np.testing.assert_allclose(metrics[i][key], val, rtol=rtol,
                                           err_msg=f"{r} {tag} {i} {key}")
            if grad_steps is not None and i >= grad_steps:
                continue
            for path, want in jg.items():
                got = ranks[r][f"{tag}/step{i}/{_key(path)}"]
                assert np.abs(got - want).max() <= (
                    1e-5 * np.abs(want).max()), (r, tag, i, path)


@pytest.mark.parametrize("ep,tp", [(2, 1), (1, 2), (2, 2), (4, 2)])
def test_moe_decode_pieces_split_experts_and_parts(ep, tp):
    """An MoE trunk's fused layout on a mesh position: gate_up [L, E, d,
    2F] keeps the position's E/ep experts and its tp block of the gate
    columns and of the up columns, w_down [L, E, F, d] its experts and ff
    rows; the router, the norms and embed stay whole. The pieces put
    together over ep and tp give the whole layout back."""
    tcfg, jcfg = TransformerConfig(**MOE_DECODE), JaxConfig(**MOE_DECODE)
    raw = params_from_numpy(jax.device_get(_jax_init(jax.random.key(2),
                                                     jcfg)), tcfg, "cpu")
    whole = decode_weights(raw, tcfg)
    lp = raw["layers"]
    e, f = tcfg.n_experts // ep, tcfg.d_ff // tp
    spec = MeshSpec(ep=ep, tp=tp)
    grid = {}
    for i in range(ep):
        for j in range(tp):
            got = shard_decode_weights(whole, tcfg, _Position(
                spec, (0, 0, i, 0, j)))["layers"]
            experts = slice(i * e, (i + 1) * e)
            cols = slice(j * f, (j + 1) * f)
            assert torch.equal(got["gate_up"], torch.cat([
                lp["w_gate"][:, experts][..., cols],
                lp["w_up"][:, experts][..., cols]], dim=-1))
            assert torch.equal(got["w_down"],
                               lp["w_down"][:, experts][:, :, cols])
            for name in ("router", "ln1", "ln2"):
                assert torch.equal(got[name], whole["layers"][name])
            grid[i, j] = got
    down = torch.cat([torch.cat([grid[i, j]["w_down"] for j in range(tp)],
                                dim=2) for i in range(ep)], dim=1)
    assert torch.equal(down, whole["layers"]["w_down"])


def test_mesh_checks_take_moe_over_every_axis():
    """check_mesh takes an MoE config over tp, sp, pp and ep x tp (it
    reads only the axis sizes), and still refuses a tp that does not
    divide the MoE trunk's heads or d_ff, and an ep that does not divide
    its experts; check_decode_mesh refuses anything but a DeviceMesh (the
    four-rank test below serves over a real one)."""

    class Sizes:
        device_type = "cpu"

        def __init__(self, **axes):
            self.shape = MeshSpec(**axes).shape

        def size(self, dim):
            return self.shape[dim]

    cfg = TransformerConfig(**MOE_MESH)
    for axes in ({"tp": 2}, {"sp": 2}, {"pp": 2}, {"ep": 2, "tp": 2},
                 {"ep": 4, "tp": 2}, {"pp": 2, "ep": 2, "tp": 2}):
        check_mesh(Sizes(**axes), cfg)
    with pytest.raises(ValueError, match="must divide n_heads 4"):
        check_mesh(Sizes(ep=2, tp=8), cfg)
    with pytest.raises(ValueError, match="must divide d_ff 48"):
        check_mesh(Sizes(tp=32), dataclasses.replace(
            cfg, n_heads=32, n_kv_heads=32, head_dim=1, d_ff=48,
            vocab_size=128))
    with pytest.raises(ValueError, match="ep 8 must divide n_experts 4"):
        check_mesh(Sizes(ep=8), cfg)
    with pytest.raises(TypeError, match="DeviceMesh"):
        check_decode_mesh(Sizes(ep=2, tp=2), cfg)


def test_moe_tp_in_four_gloo_ranks_matches_jax(jparams, tmp_path):
    """One launch of four gloo ranks:

    1. The MoE layer at cf 1.25 (tokens drop) over dp=2 x tp=2 and over
       ep=2 x tp=2: each rank's output equals JAX's ``_moe_mlp_manual``
       under shard_map on the same mesh (local capacity, like the port's)
       within 1e-6 of its largest entry, and the router values to rtol
       1e-6.
    2. At cf = E (nothing drops), with a clip at half the first step's
       global norm (it bites), 2 steps over dp=2 x tp=2 and over ep=2 x
       tp=2: each step's loss equals JAX's step on the same mesh of four
       devices to rtol 2e-5, the router values to rtol 1e-5, and each
       step's clipped gradients equal jax.grad's, scaled by optax's rule,
       within 1e-5 of each leaf's largest. One step over ep=2 x tp=2 at
       remat "dots" (the layer and its collectives recomputed in the
       backward) gives the same. The expert leaves are split over ep and
       tp, the router over ep.
    3. The ep=2 x tp=2 state restores a checkpoint JAX's manager wrote
       from its state on the same mesh (exactly), and after one more step
       the port's save carries the shard indices JAX's shardings give
       each device and restores bit for bit in JAX's manager.
    4. DecodeSession(mesh=) over ep=2 x tp=2 (the JAX package's sharded
       MoE decode config), with the dense mixture and with the routed
       gather, gives the greedy tokens of JAX's DecodeSession(mesh=) on
       the same mesh and of the session without a mesh, on every rank.
    """
    jcfg = JaxConfig(**MOE_MESH)
    np.savez(tmp_path / "w.npz", **_flat(jax.device_get(jparams)))
    rng = np.random.default_rng(11)
    batches = rng.integers(0, 128, (2, 8, 17)).astype(np.int32)
    np.save(tmp_path / "batches.npy", batches)
    x = layer_input(12)
    np.savez(tmp_path / "x.npz", x=x)
    djcfg = JaxConfig(**MOE_DECODE)
    dparams = _jax_init(jax.random.key(3), djcfg)
    np.savez(tmp_path / "dw.npz", **_flat(jax.device_get(dparams)))
    prompt = np.random.default_rng(2).integers(0, 64, (4, 5)).astype(
        np.int32)
    np.save(tmp_path / "prompt.npy", prompt)

    jmeshes = {tag: jax_build_mesh(JaxMeshSpec(**axes),
                                   devices=jax.devices()[:4])
               for tag, axes in MOE_TP_RUNS.items()}
    clip = _half_norm_clip(jparams, jcfg, jmeshes["ep_tp"], batches[0])
    steps, saved_state, j_init = {}, None, None
    for tag, jmesh in jmeshes.items():
        steps[tag], saved, init = _jax_steps(
            jparams, jcfg, jmesh, batches, clip,
            save_dir=tmp_path / "jax" if tag == "ep_tp" else None)
        if tag == "ep_tp":
            saved_state, j_init = saved, init
    assert steps["ep_tp"][0][2] < 0.6  # the clip bites
    drop = dataclasses.replace(jcfg, capacity_factor=1.25)
    layers = {tag: jax_manual_layer(jparams, x, drop, axes)
              for tag, axes in MOE_TP_RUNS.items()}
    assert layers["ep_tp"][1]["moe_drop_rate"] > 0

    results = launch("moe_tp", tmp_path, world=4, args=(
        tmp_path / "w.npz", tmp_path / "batches.npy", repr(clip),
        tmp_path / "x.npz", tmp_path / "jax", tmp_path / "port",
        tmp_path / "dw.npz", tmp_path / "prompt.npy"))
    ranks = [dict(np.load(tmp_path / f"moe_tp.{r}.npz")) for r in range(4)]

    # 1. The layer with drops.
    for tag, axes in MOE_TP_RUNS.items():
        want_out, want_aux = layers[tag]
        for r, res in enumerate(results):
            mine = rank_block(want_out, axes, r)
            assert _rel_err(ranks[r][f"layer/{tag}"], mine) <= 1e-6, (tag, r)
            for key, val in want_aux.items():
                np.testing.assert_allclose(res["layer_aux"][tag][key], val,
                                           rtol=1e-6, err_msg=f"{tag} {key}")

    # 2. The steps; remat "dots" gives step 0 again.
    for tag in MOE_TP_RUNS:
        check_moe_steps(results, ranks, steps[tag], tag)
    check_moe_steps(results, ranks, steps["ep_tp"][:1], "dots")
    for res in results:
        assert res["split"] == {
            "['embed']": ["tp", None],
            "['layers']['router']": [None, None, "ep"],
            "['layers']['w_down']": [None, "ep", "tp", None],
            "['layers']['w_gate']": [None, "ep", None, "tp"],
            "['layers']['w_up']": [None, "ep", None, "tp"],
            "['layers']['wk']": [None, None, "tp", None],
            "['layers']['wo']": [None, "tp", None, None],
            "['layers']['wq']": [None, None, "tp", None],
            "['layers']['wv']": [None, None, "tp", None],
            "['unembed']": [None, "tp"],
        }

    # 3. The checkpoint both ways.
    want = _jax_flat(saved_state)
    for r, res in enumerate(results):
        assert res["round_trip_equal"] and res["step"] == 3
        got = {k[len("restored/"):]: v for k, v in ranks[r].items()
               if k.startswith("restored/")}
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=path)
    check_saved_layout(tmp_path / "port" / "step_3", ranks[0], jcfg,
                       jmeshes["ep_tp"], j_init)

    # 4. Decode over ep x tp, dense and routed.
    want_tokens = np.asarray(JaxDecodeSession(dparams, djcfg).generate(
        jnp.asarray(prompt), max_new_tokens=NEW_TOKENS))
    with jax.sharding.set_mesh(jmeshes["ep_tp"]):
        sharded = np.asarray(JaxDecodeSession(
            dparams, djcfg, mesh=jmeshes["ep_tp"]).generate(
            jnp.asarray(prompt), max_new_tokens=NEW_TOKENS))
    np.testing.assert_array_equal(sharded, want_tokens)
    for r in range(4):
        for tag in ("plain", "dense", "routed"):
            np.testing.assert_array_equal(ranks[r][f"decode/{tag}"],
                                          want_tokens, err_msg=(r, tag))
    # Rank 3 (ep 1, tp 1) holds experts 2 and 3, their second ff half.
    assert ranks[3]["decode/gate_up"].shape == (2, 2, 32, 64)
    assert ranks[3]["decode/w_down"].shape == (2, 2, 32, 32)


def check_saved_layout(step_dir, saved_rank, jcfg, jmesh, j_init) -> None:
    """Each process file of the port's save under ``step_dir`` carries the
    shard indices JAX's shardings give its device, and JAX's manager
    restores it bit for bit on ``jmesh``."""
    saved = {k[len("saved/"):]: v for k, v in saved_rank.items()
             if k.startswith("saved/")}
    with jax.sharding.set_mesh(jmesh):
        template = j_init(jax.random.key(1))
        shardings = {jax.tree_util.keystr(p): sh for p, sh in
                     jax.tree_util.tree_flatten_with_path(_sharding_for_tree(
                         template, jax_param_roles(jcfg), jmesh))[0]}
        restored = _jax_flat(JaxManager(step_dir.parent).restore(template))
    split = 0
    for pid, device in enumerate(jmesh.devices.reshape(-1)):
        with np.load(step_dir / f"process_{pid}.npz") as npz:
            manifest = json.loads(bytes(npz[JAX_MANIFEST]).decode())
        assert set(manifest) == set(saved)
        for path, info in manifest.items():
            shape = tuple(saved[path].shape)
            index = _normalize_index(
                shardings[path].devices_indices_map(shape)[device], shape)
            assert info["shard_indices"] == [index], (pid, path)
            split += index != [[0, d] for d in shape]
    assert split > 0
    for path in saved:
        np.testing.assert_array_equal(restored[path], saved[path],
                                      err_msg=path)
