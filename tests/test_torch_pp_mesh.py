"""The dense trunk's pipeline over two-axis meshes on four gloo ranks, held
against the JAX package's step on the same meshes of four virtual CPU
devices: pp=2 x tp=2 under GPipe and interleaved (tp's sums inside each
stage, the chunk exchange over pp on each rank's tp block), pp=2 x sp=2
under GPipe (the ring over sp inside each stage), and dp=2 x pp=2 under
GPipe (each dp row its own rows and its own pipeline). One launch through
``torch_ranks.launch``; the JAX reference runs in the test process. Tiny
config at 4 layers (d 32, GQA 4/2), fp32, weights from the JAX
initializer.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from test_torch_moe import _flat, _tokens
from test_torch_pp import (
    check_replicated,
    check_steps,
    half_norm_clip,
    jax_pipeline_steps,
)
from test_torch_tp import _jax_init
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from torch_ranks import PP_MESH_RUNS, PP_TINY, PP_TRUNKS, launch

# The pairs of ranks that differ only in their pp coordinate (ranks lie in
# C order over dp, pp, ep, sp, tp).
PP_PAIRS = {"pp_tp_gpipe": [(0, 2), (1, 3)],
            "pp_tp_interleaved": [(0, 2), (1, 3)],
            "pp_sp": [(0, 2), (1, 3)], "dp_pp": [(0, 1), (2, 3)]}


@pytest.fixture(scope="module")
def jparams():
    return _jax_init(jax.random.key(0), JaxConfig(**PP_TINY))


def test_pp_meshes_in_four_gloo_ranks_match_jax(jparams, tmp_path):
    """One launch of four gloo ranks over pp=2 x tp=2 (GPipe, then
    interleaved with 2 virtual stages; every rank fed the whole batch),
    pp=2 x sp=2 (GPipe; every rank the whole batch, each sp rank its block
    of the shifted sequence) and dp=2 x pp=2 (GPipe; each dp row its
    half), 4 microbatches each, with a clip at half the first step's
    global norm (it bites): on each mesh, 2 steps' losses equal JAX's step
    with the same pipeline arguments on the same mesh of four devices to
    rtol 1e-6, and each step's clipped gradients equal jax.grad's, scaled
    by optax's rule, within 1e-5 of each leaf's largest, on every rank.
    Every leaf not split over pp is bit-equal on the ranks that differ
    only in their pp coordinate."""
    jcfg = JaxConfig(**PP_TINY)
    np.savez(tmp_path / "w.npz", **_flat(jax.device_get(jparams)))
    batches = np.stack([_tokens(140 + i, b=8) for i in range(2)])
    np.save(tmp_path / "batches.npy", batches)

    jmeshes = {tag: jax_build_mesh(JaxMeshSpec(**axes),
                                   devices=jax.devices()[:4])
               for tag, (axes, _) in PP_MESH_RUNS.items()}
    clip = half_norm_clip(jparams, jcfg, jmeshes["pp_tp_gpipe"], batches[0])
    steps = {tag: jax_pipeline_steps(jparams, jcfg, jmeshes[tag], batches,
                                     clip, PP_TRUNKS[trunk])[0]
             for tag, (_, trunk) in PP_MESH_RUNS.items()}
    assert steps["pp_tp_gpipe"][0][2] < 0.6  # the clip bites

    results = launch("pp_mesh", tmp_path, world=4, args=(
        tmp_path / "w.npz", tmp_path / "batches.npy", repr(clip)))
    ranks = [dict(np.load(tmp_path / f"pp_mesh.{r}.npz")) for r in range(4)]
    check_steps(results, ranks, steps, PP_MESH_RUNS)
    for tag, pairs in PP_PAIRS.items():
        check_replicated(ranks, pairs, [tag])
