"""The MoE trunk over a dp=2 x ep=2 mesh of four gloo ranks, held against
the JAX package's step on the same mesh of four virtual CPU devices: the one
mesh on which every branch of the port's gradient reduction runs. One
launch through ``torch_ranks.launch``; the JAX reference runs in the test
process. Tiny config (2 layers, d 32, E 4), fp32, weights from the JAX
initializer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_moe import _cfgs, _flat, _jax_init, _jax_value_and_grad, _tokens
from tony_tpu.models.train import make_train_step as jax_make_train_step
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu_torch.parallel import MeshSpec
from tony_tpu_torch.parallel.mesh import axis_group_ranks
from torch_ranks import launch


@pytest.fixture(scope="module")
def jparams():
    return _jax_init(jax.random.key(0), _cfgs()[0])


def _global_norm(grads: dict) -> float:
    return float(np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                             for g in grads.values())))


def test_dp2_ep2_in_four_gloo_ranks_matches_jax(jparams, tmp_path):
    """One launch of four gloo ranks over a dp=2 x ep=2 mesh: the expert
    FFN leaves split over ep (experts) and dp (d), the router over ep, the
    embedding over dp, the rest replicated, so every branch of the
    gradient reduction runs (a mean over dp x ep through the flattened
    group, over dp alone, over ep alone, and the divide of a leaf split
    over both) and the global norm sums each block once. At cf = E
    (nothing drops), with a clip at half the first step's global norm so
    it bites: 2 steps' loss and router metrics equal JAX's step on a
    MeshSpec(dp=2, ep=2) mesh of four devices to rtol 1e-5, and each
    step's clipped gradients equal jax.grad's, scaled by optax's
    clip_by_global_norm rule, within 1e-5 of each leaf's largest."""
    np.savez(tmp_path / "w.npz", **_flat(jax.device_get(jparams)))
    batches = np.stack([_tokens(40 + i, b=8) for i in range(2)])
    np.save(tmp_path / "batches.npy", batches)

    spec = JaxMeshSpec(dp=2, ep=2)
    jmesh = jax_build_mesh(spec, devices=jax.devices()[:4])
    jcfg, _ = _cfgs(capacity_factor=4.0)
    with jax.sharding.set_mesh(jmesh):
        clip = 0.5 * _global_norm(_flat(jax.device_get(_jax_value_and_grad(
            jparams, jnp.asarray(batches[0]), jcfg, jmesh)[1])))
        j_init, j_step = jax_make_train_step(jcfg, jmesh, learning_rate=1e-3,
                                             grad_clip=clip)
        jstate = j_init(jax.random.key(0))
        steps = []
        for toks in batches:
            grads = _flat(jax.device_get(_jax_value_and_grad(
                jstate.params, jnp.asarray(toks), jcfg, jmesh)[1]))
            scale = min(1.0, clip / _global_norm(grads))
            jstate, jm = j_step(jstate, toks)
            steps.append(({k: float(v) for k, v in jm.items()},
                          {k: v * scale for k, v in grads.items()}, scale))
    assert steps[0][2] < 0.6  # the clip bites

    results = launch("moe_dp_ep", tmp_path, world=4, args=(
        tmp_path / "w.npz", tmp_path / "batches.npy", repr(clip)))
    ranks = [dict(np.load(tmp_path / f"moe_dp_ep.{r}.npz")) for r in range(4)]
    want_ranks = axis_group_ranks(MeshSpec(dp=2, ep=2), ("dp", "ep"))
    for r, res in enumerate(results):
        assert [res["dp_ep_ranks"]] == want_ranks and res["dp_ep_size"] == 4
        split = dict(res["split"])
        assert {k: split.pop(f".params['layers']['{k}']") for k in (
            "router", "w_gate", "w_up", "w_down")} == {
            "router": [None, None, "ep"],
            "w_gate": [None, "ep", "dp", None],
            "w_up": [None, "ep", "dp", None],
            "w_down": [None, "ep", None, "dp"],
        }
        assert ".params['unembed']" in split
        assert all({e for e in spec if e} == {"dp"}
                   for spec in split.values()), split
        for i, (jm, jg, _) in enumerate(steps):
            for key, val in jm.items():
                np.testing.assert_allclose(res["metrics"][i][key], val,
                                           rtol=1e-5, err_msg=f"{i} {key}")
            for path, want in jg.items():
                key = f"step{i}/.params" + "".join(
                    f"[{k!r}]" for k in path.split("/"))
                assert np.abs(ranks[r][key] - want).max() <= (
                    1e-5 * np.abs(want).max()), (r, i, path)
