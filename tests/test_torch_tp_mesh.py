"""The dense trunk over a dp=2 x tp=2 mesh of four gloo ranks, held against
the JAX package's step on the same mesh of four virtual CPU devices: the one
mesh on which a leaf is split over dp and tp at once, so the gradient
reduction must mean over dp but never over tp, and the global norm must sum
each block's square over both. One launch through ``torch_ranks.launch``;
the JAX reference runs in the test process. Tiny config (2 layers, d 32,
GQA 4/2), fp32, weights from the JAX initializer.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from test_torch_moe import _flat, _jax_flat, _tokens
from test_torch_tp import _half_norm_clip, _jax_init, _jax_steps, _key
from tony_tpu.checkpoint import CheckpointManager as JaxManager
from tony_tpu.checkpoint import _MANIFEST as JAX_MANIFEST
from tony_tpu.checkpoint.manager import _normalize_index
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models import param_roles as jax_param_roles
from tony_tpu.models.train import _sharding_for_tree
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu_torch.parallel import MeshSpec
from tony_tpu_torch.parallel.mesh import axis_group_ranks
from torch_ranks import TINY, launch


@pytest.fixture(scope="module")
def jparams():
    return _jax_init(jax.random.key(0), JaxConfig(**TINY))


def test_dp2_tp2_in_four_gloo_ranks_matches_jax(jparams, tmp_path):
    """One launch of four gloo ranks over a dp=2 x tp=2 mesh: the
    projections and the unembed split over dp (d) and tp (heads, ff,
    vocab) at once, the embedding over tp alone, the norms replicated,
    so each branch of the gradient reduction runs (a mean over dp of a
    leaf replicated over the data axes, split over tp or not, and the
    divide of a leaf split over dp) and the norm sums over dp and then
    tp. With a clip at half the first step's global norm (it bites): 2
    steps' losses equal JAX's step on a MeshSpec(dp=2, tp=2) mesh of four
    devices to rtol 1e-6, and each step's clipped gradients equal
    jax.grad's, scaled by optax's rule, within 1e-5 of each leaf's
    largest. The tp ranks of one dp row read the same batch of the
    corpus through ``sharded_batches(mesh=)``, the dp rows their own. The
    state saved after step 2 carries the shard indices JAX's dp=2 x tp=2
    shardings give each device and restores bit for bit in JAX's
    manager."""
    jcfg = JaxConfig(**TINY)
    np.savez(tmp_path / "w.npz", **_flat(jax.device_get(jparams)))
    batches = np.stack([_tokens(70 + i, b=8) for i in range(2)])
    np.save(tmp_path / "batches.npy", batches)
    corpus = np.arange(8 * 33, dtype=np.uint16).reshape(8, 33)
    corpus.tofile(tmp_path / "c.tokens")

    jmesh = jax_build_mesh(JaxMeshSpec(dp=2, tp=2), devices=jax.devices()[:4])
    clip = _half_norm_clip(jparams, jcfg, jmesh, batches[0])
    steps, _, j_init = _jax_steps(jparams, jcfg, jmesh, batches, clip)
    assert steps[0][2] < 0.6  # the clip bites

    results = launch("tp_dp", tmp_path, world=4, args=(
        tmp_path / "w.npz", tmp_path / "batches.npy", repr(clip),
        tmp_path / "c.tokens", tmp_path / "port"))
    ranks = [dict(np.load(tmp_path / f"tp_dp.{r}.npz")) for r in range(4)]
    spec = MeshSpec(dp=2, tp=2)
    for r, res in enumerate(results):
        assert res["dp_row"] == r // 2
        for axis in ("dp", "tp"):
            assert [res["groups"][axis]] == [
                g for g in axis_group_ranks(spec, axis) if r in g]
        assert res["split"] == {
            ".params['embed']": ["tp", None],
            ".params['layers']['wq']": [None, "dp", "tp", None],
            ".params['layers']['wk']": [None, "dp", "tp", None],
            ".params['layers']['wv']": [None, "dp", "tp", None],
            ".params['layers']['wo']": [None, "tp", None, "dp"],
            ".params['layers']['w_gate']": [None, "dp", "tp"],
            ".params['layers']['w_up']": [None, "dp", "tp"],
            ".params['layers']['w_down']": [None, "tp", "dp"],
            ".params['unembed']": ["dp", "tp"],
        }
        for i, (jm, jg, _) in enumerate(steps):
            for key, val in jm.items():
                np.testing.assert_allclose(res["metrics"][i][key], val,
                                           rtol=1e-6, err_msg=f"{i} {key}")
            for path, want in jg.items():
                got = ranks[r][f"step{i}/{_key(path)}"]
                assert np.abs(got - want).max() <= (
                    1e-5 * np.abs(want).max()), (r, i, path)
        np.testing.assert_array_equal(
            ranks[r]["first_batch"], corpus[4 * (r // 2):4 * (r // 2) + 2])

    # The checkpoint: each process file holds its pieces at JAX's indices.
    saved = {k[len("saved/"):]: v for k, v in ranks[0].items()
             if k.startswith("saved/")}
    with jax.sharding.set_mesh(jmesh):
        template = j_init(jax.random.key(1))
        shardings = {jax.tree_util.keystr(p): sh for p, sh in
                     jax.tree_util.tree_flatten_with_path(_sharding_for_tree(
                         template, jax_param_roles(jcfg), jmesh))[0]}
        restored = _jax_flat(JaxManager(tmp_path / "port").restore(template))
    split = 0
    for pid, device in enumerate(jmesh.devices.reshape(-1)):
        with np.load(tmp_path / "port" / "step_2" / f"process_{pid}.npz") \
                as npz:
            manifest = json.loads(bytes(npz[JAX_MANIFEST]).decode())
        assert set(manifest) == set(saved)
        for path, info in manifest.items():
            shape = tuple(saved[path].shape)
            index = _normalize_index(
                shardings[path].devices_indices_map(shape)[device], shape)
            assert info["shard_indices"] == [index], (pid, path)
            split += index != [[0, d] for d in shape]
    assert split == 4 * 3 * 9  # 9 split leaves, params/mu/nu, 4 ranks
    for path in saved:
        np.testing.assert_array_equal(restored[path], saved[path],
                                      err_msg=path)
