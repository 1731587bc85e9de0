"""The port's pipeline parallelism (pp) held against the JAX package on the
CPU: the dense trunk's train step over a pp=2 mesh, in both of the JAX
package's meanings of pp (the layer stack stored over pp with the compute
replicated, and the pipelined trunk under GPipe and interleaved virtual
stages), the NCCL/gloo send/recv batches a schedule issues, its
checkpoints, ``DecodeSession(mesh=)`` replicated over pp, and the
refusals.

ONE launch of two gloo ranks (``torch_ranks.launch``, program
``train_pp``) against the JAX package's step, manager and session on a mesh
of two virtual CPU devices. Tiny config at 4 layers (d 32, GQA 4/2, d_ff
64, vocab 64), fp32, weights from the JAX initializer.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_moe import _flat, _jax_flat, _tokens
from test_torch_tp import _global_norm, _jax_init, _key
from tony_tpu.checkpoint import CheckpointManager as JaxManager
from tony_tpu.checkpoint import _MANIFEST as JAX_MANIFEST
from tony_tpu.models import DecodeSession as JaxDecodeSession
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models.train import lm_loss as jax_lm_loss
from tony_tpu.models.train import make_train_step as jax_make_train_step
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu_torch.interop import params_from_numpy
from tony_tpu_torch.models import DecodeSession, TransformerConfig
from tony_tpu_torch.parallel import schedule_info
from torch_ranks import PP_TINY, PP_TRUNKS, launch

NEW_TOKENS = 6
# The layer leaves, split over pp on their stacked dimension.
LAYER_LEAVES = ("ln1", "ln2", "w_down", "w_gate", "w_up", "wk", "wo", "wq",
                "wv")


@pytest.fixture(scope="module")
def jparams():
    return _jax_init(jax.random.key(0), JaxConfig(**PP_TINY))


def _jax_grad_fn(jcfg, jmesh, trunk: dict):
    return jax.jit(jax.value_and_grad(
        lambda p, t: jax_lm_loss(p, t, jcfg, jmesh, return_metrics=True,
                                 **trunk), has_aux=True))


def jax_pipeline_steps(jparams, jcfg, jmesh, batches, clip, trunk: dict,
                       save_dir=None):
    """JAX's step on ``jmesh`` with the pipeline arguments ``trunk``, from
    its initializer's weights at key 0 (``jparams``): per
    step (metrics, jax.grad's gradients scaled by optax's clip rule, the
    scale); with ``save_dir`` the state after step 2 is saved there by
    JAX's manager and returned too."""
    grad_fn = _jax_grad_fn(jcfg, jmesh, trunk)
    with jax.sharding.set_mesh(jmesh):
        j_init, j_step = jax_make_train_step(jcfg, jmesh, learning_rate=1e-3,
                                             grad_clip=clip, **trunk)
        jstate = j_init(jax.random.key(0))
        steps, saved = [], None
        for i, toks in enumerate(batches):
            grads = _flat(jax.device_get(grad_fn(jstate.params,
                                                 jnp.asarray(toks))[1]))
            scale = min(1.0, clip / _global_norm(grads))
            jstate, jm = j_step(jstate, toks)
            steps.append(({k: float(v) for k, v in jm.items()},
                          {k: v * scale for k, v in grads.items()}, scale))
            if i == 1 and save_dir is not None:
                JaxManager(save_dir).save(2, jstate, blocking=True)
                saved = jax.device_get(jstate)
    return steps, saved, j_init


def half_norm_clip(jparams, jcfg, jmesh, tokens) -> float:
    """Half the first step's global gradient norm: a clip that bites."""
    with jax.sharding.set_mesh(jmesh):
        grads = _jax_grad_fn(jcfg, jmesh, {})(jparams, jnp.asarray(tokens))[1]
    return 0.5 * _global_norm(_flat(jax.device_get(grads)))


def check_steps(results, ranks, steps: dict, tags) -> None:
    """Every rank's metrics of each step equal JAX's to rtol 1e-6, and its
    gathered clipped gradients within 1e-5 of each leaf's largest."""
    for r, res in enumerate(results):
        for tag in tags:
            metrics = res["metrics"][tag]
            assert len(metrics) == len(steps[tag])
            for i, (jm, jg, _) in enumerate(steps[tag]):
                for key, val in jm.items():
                    np.testing.assert_allclose(metrics[i][key], val,
                                               rtol=1e-6,
                                               err_msg=f"{r} {tag} {i} {key}")
                for path, want in jg.items():
                    got = ranks[r][f"{tag}/step{i}/{_key(path)}"]
                    assert np.abs(got - want).max() <= (
                        1e-5 * np.abs(want).max()), (r, tag, i, path)


def check_replicated(ranks, pairs, tags) -> None:
    """Every leaf not split over pp (params and AdamW moments) bit-equal
    on the ranks of each pp pair."""
    for a, b in pairs:
        for tag in tags:
            keys = [k for k in ranks[a] if k.startswith(f"rep/{tag}/")]
            assert keys and keys == [k for k in ranks[b]
                                     if k.startswith(f"rep/{tag}/")]
            for k in keys:
                np.testing.assert_array_equal(ranks[a][k], ranks[b][k],
                                              err_msg=f"{a} {b} {k}")


def test_pp2_in_two_gloo_ranks_matches_jax(jparams, tmp_path):
    """One launch of two gloo ranks over a pp=2 mesh, both fed the same
    rows:

    1. 3 steps of each trunk: the unpipelined one (the layer stack
       gathered over pp), GPipe over 4 microbatches and interleaved with
       2 virtual stages over 4, with a clip at half the first step's
       global norm (it bites): each step's loss and cross-entropy equal
       JAX's step with the same pipeline arguments on a MeshSpec(pp=2)
       mesh of two devices to rtol 1e-6, and each step's clipped
       gradients equal jax.grad's, scaled by optax's rule, within 1e-5 of
       each leaf's largest, on both ranks. Every leaf not split over pp
       (params and moments) is bit-equal on the two ranks after the
       steps. The layer leaves are split over pp on their stacked axis.
       In the first step each rank sends and receives ticks - 1 P2P
       batches in the forward and as many in the backward (none in the
       unpipelined trunk), and the interleaved trunk exchanges each of
       the 9 layer leaves for its chunks with one all_to_all each way.
       One GPipe step at remat "full" (the stages recompute their layers
       in the backward) equals JAX's at remat "full" to the same
       tolerances and sends no more than without remat.
    2. A state restores a checkpoint JAX's manager wrote from its pp=2
       state exactly; after one more step of the unpipelined trunk and of
       GPipe's, the port's saves hold each layer leaf's pp block in its
       process file (JAX's shard indices) and restore bit for bit in
       JAX's manager and in the port's.
    3. DecodeSession(mesh=) over pp=2 (replicated) gives the greedy tokens
       of JAX's session on the same mesh and of the port's without a mesh.
    4. The refusals: MoE x pp (train and decode), layers pp x virtual
       does not divide, a batch the microbatches do not divide,
       interleaved microbatches pp does not divide, K/V heads tp does not
       divide.
    """
    jcfg = JaxConfig(**PP_TINY)
    np.savez(tmp_path / "w.npz", **_flat(jax.device_get(jparams)))
    batches = np.stack([_tokens(120 + i, b=4) for i in range(3)])
    np.save(tmp_path / "batches.npy", batches)
    prompt = _tokens(130, b=4, t=6)
    np.save(tmp_path / "prompt.npy", prompt)

    jmesh = jax_build_mesh(JaxMeshSpec(pp=2), devices=jax.devices()[:2])
    clip = half_norm_clip(jparams, jcfg, jmesh, batches[0])
    steps, cstate, j_init = {}, None, None
    for tag, trunk in PP_TRUNKS.items():
        save = tmp_path / "jax" if tag == "plain" else None
        steps[tag], saved, init = jax_pipeline_steps(
            jparams, jcfg, jmesh, batches, clip, trunk, save)
        if saved is not None:
            cstate, j_init = saved, init
        assert steps[tag][0][2] < 0.6  # the clip bites
    steps["gpipe_remat"] = jax_pipeline_steps(
        jparams, JaxConfig(**{**PP_TINY, "remat": True}), jmesh,
        batches[:1], clip, PP_TRUNKS["gpipe"])[0]
    with jax.sharding.set_mesh(jmesh):
        want_tokens = np.asarray(JaxDecodeSession(
            jparams, jcfg, mesh=jmesh).generate(jnp.asarray(prompt),
                                                max_new_tokens=NEW_TOKENS))

    results = launch("train_pp", tmp_path, args=(
        tmp_path / "w.npz", tmp_path / "batches.npy", repr(clip),
        tmp_path / "jax", tmp_path / "port", tmp_path / "prompt.npy"))
    ranks = [dict(np.load(tmp_path / f"train_pp.{r}.npz")) for r in range(2)]

    # 1. Metrics, gradients, the replicated leaves, the sends.
    check_steps(results, ranks, steps, [*PP_TRUNKS, "gpipe_remat"])
    check_replicated(ranks, [(0, 1)], PP_TRUNKS)
    for res in results:
        assert {k: v for k, v in res["split"].items()
                if k.startswith(".params")} == {
            f".params['layers']['{k}']": ["pp"] + [None] * (
                3 if k in ("wq", "wk", "wv", "wo") else
                1 if k in ("ln1", "ln2") else 2)
            for k in LAYER_LEAVES}
        for tag, trunk in PP_TRUNKS.items():
            ticks = 1 if not trunk else schedule_info(
                trunk.get("pipeline_schedule", "gpipe"),
                trunk["pipeline_microbatches"], 2, 4,
                trunk.get("pipeline_virtual", 1)).ticks
            assert res["p2p_first_step"][tag] == {"fwd": ticks - 1,
                                                  "bwd": ticks - 1}, tag
        assert res["p2p_first_step"]["gpipe_remat"] == \
            res["p2p_first_step"]["gpipe"]
        assert res["all_to_all_per_step"] == {
            "plain": 0, "gpipe": 0, "interleaved": 2 * len(LAYER_LEAVES)}

    # 2. The checkpoint both ways.
    want = _jax_flat(cstate)
    for r, res in enumerate(results):
        assert res["round_trip_equal"] == {"plain": True, "gpipe": True}
        for tag in ("plain", "gpipe"):
            got = {k[len(f"restored/{tag}/"):]: v for k, v in
                   ranks[r].items() if k.startswith(f"restored/{tag}/")}
            assert set(got) == set(want)
            for path in want:
                np.testing.assert_array_equal(got[path], want[path],
                                              err_msg=path)
    for tag in ("plain", "gpipe"):
        saved = {k[len(f"saved/{tag}/"):]: v for k, v in ranks[0].items()
                 if k.startswith(f"saved/{tag}/")}
        for pid in range(2):
            with np.load(tmp_path / "port" / tag / "step_3" /
                         f"process_{pid}.npz") as npz:
                manifest = json.loads(bytes(npz[JAX_MANIFEST]).decode())
            assert set(manifest) == set(want)
            for path, info in manifest.items():
                shape = list(saved[path].shape)
                index = [[0, d] for d in shape]
                if "['layers']" in path:
                    half = shape[0] // 2
                    index[0] = [pid * half, (pid + 1) * half]
                assert info["shape"] == shape, path
                assert info["shard_indices"] == [index], path
        with jax.sharding.set_mesh(jmesh):
            restored = JaxManager(tmp_path / "port" / tag).restore(
                j_init(jax.random.key(1)))
        got = _jax_flat(restored)
        for path in saved:
            np.testing.assert_array_equal(got[path], saved[path],
                                          err_msg=f"{tag} {path}")

    # 3. Decode, replicated over pp.
    tcfg = TransformerConfig(**PP_TINY)
    plain = DecodeSession(params_from_numpy(jax.device_get(jparams), tcfg,
                                            "cpu"), tcfg, "cpu").generate(
        prompt, NEW_TOKENS).numpy()
    np.testing.assert_array_equal(plain, want_tokens)
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["decode/pp"], want_tokens)

    # 4. The refusals.
    refused = results[0]["refused"]
    for key in ("moe_train", "moe_decode"):  # an MoE trunk runs over pp
        assert refused[key] == "", (key, refused[key])
    expected = {
        "layers": "n_layers 4 not divisible by pp*virtual 8",
        "batch": "batch 3 not divisible by 4 microbatches",
        "interleaved_microbatches": "interleaved schedule needs "
                                    "num_microbatches (3) divisible by pp "
                                    "(2)",
        "kv_heads": "pipeline trunk needs n_kv_heads (1) divisible by tp "
                    "(2)",
    }
    for key, text in expected.items():
        assert refused[key].startswith("ValueError") and \
            text in refused[key], (key, refused[key])
