"""The port's MoE trunk over sequence parallelism (sp) held against the JAX
package on the CPU: each rank routes its own block of T/sp positions with a
local capacity, the router statistics are averaged over dp x ep x sp
before they are combined, the ep exchange runs as over ep alone, and the
attention is the ring over sp.

ONE launch of four gloo ranks (``torch_ranks.launch``, program ``moe_sp``)
against the JAX package's manual MoE layer under ``shard_map`` and its step
on meshes of four virtual CPU devices. The MoE test config of
``tests/test_torch_moe_tp.py``; weights from the JAX initializer.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from test_torch_moe import _flat, _rel_err
from test_torch_moe_tp import (
    MOE_KEYS,
    check_moe_steps,
    jax_manual_layer,
    layer_input,
    rank_block,
)
from test_torch_tp import _half_norm_clip, _jax_init, _jax_steps, _key
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu_torch.parallel import MeshSpec
from tony_tpu_torch.parallel.mesh import DATA_AXES, axis_group_ranks
from torch_ranks import MOE_MESH, MOE_SP_RUNS, launch

ROUTER = _key("layers/router")


@pytest.fixture(scope="module")
def jparams():
    return _jax_init(jax.random.key(0), JaxConfig(**MOE_MESH))


def test_moe_sp_in_four_gloo_ranks_matches_jax(jparams, tmp_path):
    """One launch of four gloo ranks:

    1. At cf = E (nothing drops), with a clip at half the first step's
       global norm (it bites), 2 steps over dp=2 x sp=2 and over ep=2 x
       sp=2 (each sp rank its block of 8 of the 16 shifted positions):
       each step's loss equals JAX's step on the same mesh of four devices
       to rtol 2e-5, the router values to rtol 1e-5, and each step's
       clipped gradients equal jax.grad's, scaled by optax's rule, within
       1e-5 of each leaf's largest, the router's leaf among them (the
       balance loss's gradient passes the pmean over dp x ep x sp, where a
       factor of sp is easy to gain or lose). One step over ep=2 x sp=2
       at remat "dots" gives the same. The router statistics' group is
       the data axes' (all four ranks).
    2. The MoE layer at cf 1.25 (tokens drop) over ep=2 x sp=2, each rank
       routing its block of positions with a capacity counted from it:
       each rank's output equals JAX's ``_moe_mlp_manual`` under shard_map
       on the same mesh within 1e-6 of its largest entry, and the router
       values to rtol 1e-6.
    """
    jcfg = JaxConfig(**MOE_MESH)
    np.savez(tmp_path / "w.npz", **_flat(jax.device_get(jparams)))
    rng = np.random.default_rng(21)
    batches = rng.integers(0, 128, (2, 8, 17)).astype(np.int32)
    np.save(tmp_path / "batches.npy", batches)
    x = layer_input(22)
    np.savez(tmp_path / "x.npz", x=x)

    jmeshes = {tag: jax_build_mesh(JaxMeshSpec(**axes),
                                   devices=jax.devices()[:4])
               for tag, axes in MOE_SP_RUNS.items()}
    clip = _half_norm_clip(jparams, jcfg, jmeshes["ep_sp"], batches[0])
    steps = {tag: _jax_steps(jparams, jcfg, jmesh, batches, clip)[0]
             for tag, jmesh in jmeshes.items()}
    assert steps["ep_sp"][0][2] < 0.6  # the clip bites
    want_out, want_aux = jax_manual_layer(
        jparams, x, dataclasses.replace(jcfg, capacity_factor=1.25),
        MOE_SP_RUNS["ep_sp"])
    assert want_aux["moe_drop_rate"] > 0

    results = launch("moe_sp", tmp_path, world=4, args=(
        tmp_path / "w.npz", tmp_path / "batches.npy", repr(clip),
        tmp_path / "x.npz"))
    ranks = [dict(np.load(tmp_path / f"moe_sp.{r}.npz")) for r in range(4)]

    for tag, axes in MOE_SP_RUNS.items():
        check_moe_steps(results, ranks, steps[tag], tag)
        groups = axis_group_ranks(MeshSpec(**axes), DATA_AXES)
        for r, res in enumerate(results):
            assert [res["data_group"][tag]] == [g for g in groups if r in g]
            for i, (_, jg, _) in enumerate(steps[tag]):
                want = jg["layers/router"]
                got = ranks[r][f"{tag}/step{i}/{ROUTER}"]
                assert np.abs(got - want).max() <= 1e-5 * np.abs(
                    want).max(), (tag, r, i)
    check_moe_steps(results, ranks, steps["ep_sp"][:1], "dots")

    for r, res in enumerate(results):
        mine = rank_block(want_out, MOE_SP_RUNS["ep_sp"], r)
        assert _rel_err(ranks[r]["layer/ep_sp"], mine) <= 1e-6, r
        for key in MOE_KEYS:
            np.testing.assert_allclose(res["layer_aux"]["ep_sp"][key],
                                       want_aux[key], rtol=1e-6,
                                       err_msg=key)
