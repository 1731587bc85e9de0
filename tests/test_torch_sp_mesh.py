"""The dense trunk over sp=2 x tp=2 and over dp=2 x sp=2 on four gloo ranks,
held against the JAX package's step on the same meshes of four virtual CPU
devices. sp x tp is the mesh ``MeshSpec.auto(4)`` gives (the ring runs on
each rank's tp heads, and the replicated norms' gradients are summed over
tp before the mean over sp); dp x sp is the one on which a leaf split over
dp (``embed_fsdp``) has its reduce-scattered gradient averaged over sp as
well, and the other leaves are averaged over the flattened dp x sp group.
One launch through ``torch_ranks.launch``; the JAX reference runs in the
test process. Tiny config (2 layers, d 32, GQA 4/2), fp32, weights from
the JAX initializer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_moe import _flat, _tokens
from test_torch_tp import _half_norm_clip, _jax_init, _jax_steps, _key
from tony_tpu.models import DecodeSession as JaxDecodeSession
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu_torch.parallel import MeshSpec
from tony_tpu_torch.parallel.mesh import axis_group_ranks
from torch_ranks import TINY, launch

MESHES = {"sp_tp": dict(sp=2, tp=2), "dp_sp": dict(dp=2, sp=2)}


@pytest.fixture(scope="module")
def jparams():
    return _jax_init(jax.random.key(0), JaxConfig(**TINY))


def test_sp2_tp2_and_dp2_sp2_in_four_gloo_ranks_match_jax(jparams,
                                                          tmp_path):
    """One launch of four gloo ranks, over sp=2 x tp=2 (every rank fed the
    whole batch) and then dp=2 x sp=2 (each dp row its half), with a clip
    at half the first step's global norm (it bites): on each mesh, 2
    steps' losses equal JAX's step on the same mesh of four devices to
    rtol 1e-6, and each step's clipped gradients equal jax.grad's, scaled
    by optax's rule, within 1e-5 of each leaf's largest, on every rank.
    The gradient mean's group is the sp group on sp x tp and the
    flattened dp x sp group of all four ranks on dp x sp.
    DecodeSession(mesh=) over sp=2 x tp=2 gives JAX's greedy tokens on the
    same mesh."""
    jcfg = JaxConfig(**TINY)
    np.savez(tmp_path / "w.npz", **_flat(jax.device_get(jparams)))
    batches = np.stack([_tokens(100 + i, b=8) for i in range(2)])
    np.save(tmp_path / "batches.npy", batches)
    prompt = _tokens(110, b=4, t=6)
    np.save(tmp_path / "prompt.npy", prompt)

    jmeshes = {tag: jax_build_mesh(JaxMeshSpec(**axes),
                                   devices=jax.devices()[:4])
               for tag, axes in MESHES.items()}
    clip = _half_norm_clip(jparams, jcfg, jmeshes["sp_tp"], batches[0])
    steps = {tag: _jax_steps(jparams, jcfg, m, batches, clip)[0]
             for tag, m in jmeshes.items()}
    assert steps["sp_tp"][0][2] < 0.6  # the clip bites
    want_tokens = np.asarray(JaxDecodeSession(
        jparams, jcfg, mesh=jmeshes["sp_tp"]).generate(
        jnp.asarray(prompt), max_new_tokens=6))

    results = launch("sp_mesh", tmp_path, world=4, args=(
        tmp_path / "w.npz", tmp_path / "batches.npy", repr(clip),
        tmp_path / "prompt.npy"))
    ranks = [dict(np.load(tmp_path / f"sp_mesh.{r}.npz")) for r in range(4)]
    groups = {"sp_tp": axis_group_ranks(MeshSpec(**MESHES["sp_tp"]), "sp"),
              "dp_sp": axis_group_ranks(MeshSpec(**MESHES["dp_sp"]),
                                        ("dp", "sp"))}
    for r, res in enumerate(results):
        for tag in MESHES:
            assert [res["data_group"][tag]] == [
                g for g in groups[tag] if r in g], (r, tag)
            for i, (jm, jg, _) in enumerate(steps[tag]):
                for key, val in jm.items():
                    np.testing.assert_allclose(
                        res["metrics"][tag][i][key], val, rtol=1e-6,
                        err_msg=f"{tag} {i} {key}")
                for path, want in jg.items():
                    got = ranks[r][f"{tag}/step{i}/{_key(path)}"]
                    assert np.abs(got - want).max() <= (
                        1e-5 * np.abs(want).max()), (r, tag, i, path)
        np.testing.assert_array_equal(ranks[r]["decode"], want_tokens)
