"""The port's MoE trunk over pipeline parallelism (pp) held against the JAX
package on the CPU, in both of its meanings: the layer stack stored over pp
and gathered (every pp rank runs the whole trunk), and the pipelined trunk,
whose MoE stages return their layers' router values summed beside their
output; the schedule sums them over the valid ticks and the stages
(selection, never a multiply, drops a bubble tick's), and the trunk
divides the sum by n_layers x microbatches.

In one process (``forward_pipeline(mesh=None, stages=)``): GPipe and
interleaved schedules against JAX's ``lm_loss(pipeline_microbatches=)`` on
a pp x tp mesh of virtual CPU devices (loss, router values, every
gradient), with and without drops, and the refusal of an ep that does not
divide the experts. Then ONE launch of four gloo ranks
(``torch_ranks.launch``, program ``moe_pp``) over pp=2 x ep=2 and pp=2 x
tp=2 against JAX's steps on the same meshes, the pipelined runs also
against JAX's GSPMD trunk, and the pp-staged, ep-split checkpoint both
ways. The MoE test config of ``tests/test_torch_moe_tp.py`` at 4 and 8
layers; weights from the JAX initializer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_moe import _flat, _jax_flat
from test_torch_moe_tp import MOE_KEYS, check_moe_steps, check_saved_layout
from test_torch_pp import check_replicated, half_norm_clip, jax_pipeline_steps
from test_torch_tp import _jax_init
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models.train import lm_loss as jax_lm_loss
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu_torch.interop import params_from_numpy
from tony_tpu_torch.models import TransformerConfig, lm_loss
from tony_tpu_torch.models.transformer import check_pipeline
from torch_ranks import MOE_MESH, MOE_PP_RUNS, MOE_PP_TRUNKS, launch

torch.set_num_threads(1)

# One process: (layers, stages, schedule, virtual stages, microbatches,
# capacity factor). pp 4 x v 2 needs 8 layers; cf 1.25 drops tokens (the
# embedding skewed), which the reference, routing the same microbatches
# with the same capacity, drops alike.
IN_PROCESS = {
    "gpipe-pp2-m2": (4, 2, "gpipe", 1, 2, 4.0),
    "interleaved-pp4-v2-m4": (8, 4, "interleaved", 2, 4, 4.0),
    "gpipe-pp2-m4-drops": (4, 2, "gpipe", 1, 4, 1.25),
}


def _jax_pipeline_grads(jparams, jcfg, tokens, stages, **pipe):
    """((loss, metrics), grads) of JAX's pipelined lm_loss on MeshSpec(pp=
    stages, tp=2): the batch is not split over ep, so each stage routes
    whole microbatches, as one process does."""
    jmesh = jax_build_mesh(JaxMeshSpec(pp=stages, tp=2),
                           devices=jax.devices()[:2 * stages])
    with jax.sharding.set_mesh(jmesh):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, t: jax_lm_loss(p, t, jcfg, jmesh, return_metrics=True,
                                     **pipe), has_aux=True))(
            jparams, jnp.asarray(tokens))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            _flat(jax.device_get(grads)))


def _port_pipeline_grads(params, cfg, tokens, **pipe):
    flat = {}

    def trainable(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = trainable(v, f"{prefix}{k}/")
            else:
                out[k] = flat[prefix + k] = v.clone().requires_grad_()
        return out

    loss, metrics = lm_loss(trainable(params), torch.from_numpy(tokens), cfg,
                            None, return_metrics=True, **pipe)
    loss.backward()
    return (loss.item(), {k: v.item() for k, v in metrics.items()},
            {k: v.grad.numpy() for k, v in flat.items()})


@pytest.mark.parametrize("case", list(IN_PROCESS))
def test_pipeline_in_one_process_matches_jax(case):
    """The MoE trunk through ``forward_pipeline`` with every stage in this
    process: the loss equals JAX's pipelined ``lm_loss`` with the same
    schedule to rtol 2e-5, the four router values (each summed over the
    stages' layers and the valid ticks, over n_layers x microbatches) to
    rtol 1e-5, and every gradient leaf within 1e-5 of its largest. With
    cf 1.25 tokens drop, the same in both."""
    layers, stages, schedule, virtual, m, cf = IN_PROCESS[case]
    kw = dict(MOE_MESH, n_layers=layers, capacity_factor=cf)
    jcfg, cfg = JaxConfig(**kw), TransformerConfig(**kw)
    jparams = jax.device_get(_jax_init(jax.random.key(4), jcfg))
    if cf < cfg.n_experts:
        offset = np.random.default_rng(5).standard_normal(cfg.d_model)
        jparams = {**jparams, "embed": np.asarray(jparams["embed"])
                   + 2.0 * offset.astype(np.float32)}
    tokens = np.random.default_rng(6).integers(0, 128, (8, 17)).astype(
        np.int32)
    pipe = dict(pipeline_microbatches=m, pipeline_schedule=schedule,
                pipeline_virtual=virtual)
    want_loss, want_metrics, want = _jax_pipeline_grads(
        jparams, jcfg, tokens, stages, **pipe)
    loss, metrics, grads = _port_pipeline_grads(
        params_from_numpy(jparams, cfg, "cpu"), cfg, tokens,
        pipeline_stages=stages, **pipe)
    assert (want_metrics["moe_drop_rate"] > 0) == (cf < cfg.n_experts)
    np.testing.assert_allclose(loss, want_loss, rtol=2e-5)
    for key in MOE_KEYS:
        np.testing.assert_allclose(metrics[key], want_metrics[key],
                                   rtol=1e-5, err_msg=key)
    assert set(grads) == set(want)
    for path, g in grads.items():
        scale = np.abs(want[path]).max()
        assert np.abs(g - want[path]).max() <= 1e-5 * scale, path


def test_pipeline_refuses_experts_ep_does_not_divide():
    """JAX's refusal (``tests/test_models.py``): resident-expert slabs
    must be equal, so ep must divide the experts through the pipeline."""
    cfg = TransformerConfig(**dict(MOE_MESH, n_experts=3))
    with pytest.raises(ValueError, match="n_experts 3 not divisible by ep 2"):
        check_pipeline(cfg, 2, 1, "gpipe", 1, ep=2)
    check_pipeline(cfg, 2, 1, "gpipe", 1, ep=3)


# The JAX reference of a launch run that is not its own trunk's step: GPipe
# over one microbatch is the GSPMD trunk's math at cf = E, and the
# interleaved schedule GPipe's over the same microbatches (JAX's own test
# holds the two equal).
REFERENCE = {"pp_ep_gpipe1": "pp_ep_plain",
             "pp_ep_interleaved": "pp_ep_gpipe"}


def microbatch_order(batches, data_rows: int, m: int):
    """``batches`` [steps, B, T+1] with the rows reordered so that JAX's
    microbatch i (the global batch's i-th block, split over the data rows)
    holds what the port's does: each data row's i-th block of its own
    rows. The router statistics of a microbatch are averaged over the data
    axes before the balance product, so the grouping shows in the aux."""
    steps, b, t = batches.shape
    return batches.reshape(steps, data_rows, m, b // (data_rows * m),
                           t).transpose(0, 2, 1, 3, 4).reshape(steps, b, t)


def test_moe_pp_in_four_gloo_ranks_matches_jax(tmp_path):
    """One launch of four gloo ranks, at cf = E (nothing drops) with a clip
    at half the first step's global norm (it bites), 2 steps each over
    pp=2 x ep=2 of the trunk with the layer stack gathered over pp, of
    GPipe over 1 and over 2 microbatches and of interleaved with 2
    virtual stages over 2, and over pp=2 x tp=2 of GPipe over 2: each
    step's loss equals JAX's step with the same pipeline arguments on the
    same mesh of four devices to rtol 2e-5 and the router values to rtol
    1e-5 (JAX fed the rows in ``microbatch_order``; see REFERENCE for the
    two runs held against another trunk's step), and the first step's
    clipped gradients equal jax.grad's, scaled by optax's rule, within
    1e-5 of each leaf's largest (the two-axis halves of JAX's pp 2 x ep 2
    x tp 2 test). The second step's gradients are taken at weights that
    AdamW's first, sign-like update has moved apart wherever a gradient
    entry is rounding noise: JAX's own GSPMD steps on pp=2 x ep=2 and dp=2
    x ep=2 differ there by 1.7e-5 of a leaf's largest, so they are not
    held. The layer stack gathered and GPipe over one microbatch equal
    JAX's GSPMD trunk on the mesh (one microbatch's router values are the
    batch's). Every leaf not split over pp is bit-equal on the
    ranks that differ only in their pp coordinate.
    The state, its layer stack staged over pp and its experts over ep,
    restores a checkpoint JAX's manager wrote from its pipelined state on
    pp=2 x ep=2 (exactly), and after one GPipe step the port's save
    carries JAX's shard indices and restores bit for bit in JAX's
    manager."""
    kw = dict(MOE_MESH, n_layers=4)
    jcfg = JaxConfig(**kw)
    jparams = _jax_init(jax.random.key(0), jcfg)
    np.savez(tmp_path / "w.npz", **_flat(jax.device_get(jparams)))
    rng = np.random.default_rng(31)
    batches = rng.integers(0, 128, (2, 8, 17)).astype(np.int32)
    np.save(tmp_path / "batches.npy", batches)

    jmeshes = {k: jax_build_mesh(JaxMeshSpec(**axes),
                                 devices=jax.devices()[:4])
               for k, axes in (("pp_ep", dict(pp=2, ep=2)),
                               ("pp_tp", dict(pp=2, tp=2)))}
    clip = half_norm_clip(jparams, jcfg, jmeshes["pp_ep"], batches[0])
    steps, saved_state, j_init = {}, None, None
    for tag, (axes, trunk) in MOE_PP_RUNS.items():
        if tag in REFERENCE:
            continue
        key = "pp_ep" if "ep" in axes else "pp_tp"
        save = tag == "pp_ep_gpipe"
        trunk = MOE_PP_TRUNKS[trunk]
        rows = microbatch_order(batches, axes.get("ep", 1),
                                trunk.get("pipeline_microbatches", 1))
        steps[tag], saved, init = jax_pipeline_steps(
            jparams, jcfg, jmeshes[key], rows, clip, trunk,
            save_dir=tmp_path / "jax" if save else None)
        if save:
            saved_state, j_init = saved, init
    assert steps["pp_ep_gpipe"][0][2] < 0.6  # the clip bites

    results = launch("moe_pp", tmp_path, world=4, args=(
        tmp_path / "w.npz", tmp_path / "batches.npy", repr(clip),
        tmp_path / "jax", tmp_path / "port"))
    ranks = [dict(np.load(tmp_path / f"moe_pp.{r}.npz")) for r in range(4)]

    for tag in MOE_PP_RUNS:
        check_moe_steps(results, ranks, steps[REFERENCE.get(tag, tag)], tag,
                        grad_steps=1)
        check_replicated(ranks, [(0, 2), (1, 3)], [tag])
    for res in results:
        assert res["split"]["['layers']['w_gate']"] == ["pp", "ep", None,
                                                        None]
        assert res["split"]["['layers']['router']"] == ["pp", None, "ep"]

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
                       jmeshes["pp_ep"], j_init)
