"""The port's sequence parallelism (sp) held against the JAX package on the
CPU: the dense trunk's train step over an sp=2 mesh (ring attention over
the sequence blocks, RoPE at global positions, each rank's block of the
shifted sequence, the gradient mean over the data axes), its checkpoints,
``DecodeSession(mesh=)`` replicated over sp, and the refusals.

ONE launch of two gloo ranks (``torch_ranks.launch``, program
``train_sp``) against the JAX package's step, manager and session on a mesh
of two virtual CPU devices. Tiny config (2 layers, d 32, GQA 4/2, d_ff 64,
vocab 64), fp32, weights from the JAX initializer.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_moe import _flat, _jax_flat, _tokens
from test_torch_tp import _half_norm_clip, _jax_init, _jax_steps, _key
from tony_tpu.checkpoint import CheckpointManager as JaxManager
from tony_tpu.checkpoint import _MANIFEST as JAX_MANIFEST
from tony_tpu.models import DecodeSession as JaxDecodeSession
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu_torch.interop import params_from_numpy
from tony_tpu_torch.models import DecodeSession, TransformerConfig
from torch_ranks import TINY, launch

NEW_TOKENS = 6
# The ring's send/recv batches in the first step of TINY (2 layers) at sp 2:
# one rotation a layer forward and its reverse backward; remat "full" and
# "dots" run each layer's forward again in the backward, rotation too.
P2P_FIRST_STEP = {"none": 4, "full": 6, "dots": 6}


@pytest.fixture(scope="module")
def jparams():
    return _jax_init(jax.random.key(0), JaxConfig(**TINY))


def test_sp2_in_two_gloo_ranks_matches_jax(jparams, tmp_path):
    """One launch of two gloo ranks over an sp=2 mesh, both fed the same
    rows (each trains on its block of 8 of the 16 shifted positions):

    1. 3 steps at remat none, "full" and "dots", with a clip at half the
       first step's global norm (it bites): each step's loss and
       cross-entropy equal JAX's step on a MeshSpec(sp=2) mesh of two
       devices (its ring attention over the sequence) to rtol 1e-6, and
       the first step's clipped gradients equal jax.grad's, scaled by
       optax's rule, within 1e-5 of each leaf's largest, on both ranks.
       Each rank sends and receives P2P_FIRST_STEP batches in the first
       step. No leaf is split over sp.
    2. The state restores a checkpoint JAX's manager wrote from its sp=2
       state exactly; after one more step the port's save holds every
       leaf whole in each process file (JAX's sp=2 shardings replicate
       every leaf) and restores bit for bit in JAX's manager and in the
       port's.
    3. DecodeSession(mesh=) over sp=2 (replicated) gives the greedy
       tokens of JAX's DecodeSession(mesh=) on the same mesh and of the
       port's session without a mesh.
    4. The refusals: MoE x sp (train and decode), a pipeline whose pp
       does not divide the layers, and an sp that does not divide the
       sequence.
    """
    jcfg = JaxConfig(**TINY)
    np.savez(tmp_path / "w.npz", **_flat(jax.device_get(jparams)))
    batches = np.stack([_tokens(80 + i, b=4) for i in range(3)])
    np.save(tmp_path / "batches.npy", batches)
    prompt = _tokens(90, b=4, t=6)
    np.save(tmp_path / "prompt.npy", prompt)

    jmesh = jax_build_mesh(JaxMeshSpec(sp=2), devices=jax.devices()[:2])
    clip = _half_norm_clip(jparams, jcfg, jmesh, batches[0])
    steps, cstate, j_init = _jax_steps(jparams, jcfg, jmesh, batches, clip,
                                       tmp_path / "jax")
    assert steps[0][2] < 0.6  # the clip bites
    want_tokens = np.asarray(JaxDecodeSession(jparams, jcfg,
                                              mesh=jmesh).generate(
        jnp.asarray(prompt), max_new_tokens=NEW_TOKENS))

    results = launch("train_sp", tmp_path, args=(
        tmp_path / "w.npz", tmp_path / "batches.npy", repr(clip),
        tmp_path / "jax", tmp_path / "port", tmp_path / "prompt.npy"))
    ranks = [dict(np.load(tmp_path / f"train_sp.{r}.npz")) for r in range(2)]

    # 1. Losses and first-step gradients, each remat setting.
    for r, res in enumerate(results):
        assert res["p2p_first_step"] == P2P_FIRST_STEP
        assert res["split"] == {}
        for tag, metrics in res["metrics"].items():
            assert len(metrics) == 3
            for i, got in enumerate(metrics):
                for key, val in steps[i][0].items():
                    np.testing.assert_allclose(got[key], val, rtol=1e-6,
                                               err_msg=f"{tag} {i} {key}")
            for path, want in steps[0][1].items():
                diff = np.abs(ranks[r][f"{tag}/{_key(path)}"] - want).max()
                assert diff <= 1e-5 * np.abs(want).max(), (r, tag, path)

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
    for pid in range(2):
        with np.load(tmp_path / "port" / "step_3" / f"process_{pid}.npz") \
                as npz:
            manifest = json.loads(bytes(npz[JAX_MANIFEST]).decode())
        assert set(manifest) == set(want)
        for path, info in manifest.items():
            shape = list(saved[path].shape)
            assert info["shape"] == shape and info["shard_shapes"] == [
                shape], path
            assert info["shard_indices"] == [[[0, d] for d in shape]], path
    with jax.sharding.set_mesh(jmesh):
        restored = JaxManager(tmp_path / "port").restore(
            j_init(jax.random.key(1)))
    got = _jax_flat(restored)
    for path in saved:
        np.testing.assert_array_equal(got[path], saved[path], err_msg=path)

    # 3. Decode, replicated over sp.
    tcfg = TransformerConfig(**TINY)
    plain = DecodeSession(params_from_numpy(jax.device_get(jparams), tcfg,
                                            "cpu"), tcfg, "cpu").generate(
        prompt, NEW_TOKENS).numpy()
    np.testing.assert_array_equal(plain, want_tokens)
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["decode/sp"], want_tokens)

    # 4. The refusals.
    refused = results[0]["refused"]
    for key in ("moe_train", "moe_decode"):  # an MoE trunk runs over sp
        assert refused[key] == "", (key, refused[key])
    assert refused["pp_train"].startswith("ValueError") and \
        "n_layers 3 not divisible by pp*virtual 2" in refused["pp_train"]
    assert refused["odd_sequence"].startswith("ValueError") and \
        "sp 2 must divide the sequence length 15" in refused["odd_sequence"]
