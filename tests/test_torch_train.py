"""The port's training slice held against the JAX package on the CPU: the
training forward's logits, ``lm_loss`` and its gradients on the same
converted weights, remat policies, a 5-step trajectory of ``make_train_step``
(clip + AdamW) with the final params, and the clip against optax. Then data
parallelism: two gloo ranks (``torch_ranks.launch``) train over a dp=2 mesh
and match the JAX package's dp=2 step and the port's single-process step.
Then the runtime (``task_context``, ``local_rank``, ``initialize`` in two
gloo processes), the train CLI (synthetic and file corpora, checkpoints, a
resumed run equal to a straight one), serving from its checkpoint, a job
submitted twice through the orchestrator with ``--framework pytorch``, the
second resuming the first, and a job of two workers equal to one process on
the same global batches. Inputs come from seeded numpy generators; all
comparisons are fp32 unless a test says otherwise."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu.conf.configuration import TonyConfiguration
from tony_tpu.executor.runtimes import PyTorchRuntime
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models import forward as jax_forward
from tony_tpu.models import init_params as jax_init_params
from tony_tpu.models import param_roles as jax_param_roles
from tony_tpu.models.train import lm_loss as jax_lm_loss
from tony_tpu.models.train import make_train_step as jax_make_train_step
from tony_tpu.parallel.mesh import MeshSpec, build_mesh
from tony_tpu_torch import runtime as rt
from tony_tpu_torch import serve as serve_cli
from tony_tpu_torch import train as train_cli
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.interop import (
    params_from_numpy,
    params_to_numpy,
    train_state_to_numpy,
)
from tony_tpu_torch.io import write_jsonl_blocks
from tony_tpu_torch.models import (
    TrainState,
    TransformerConfig,
    forward,
    lm_loss,
    make_train_step,
    param_roles,
)
from tony_tpu_torch.models.train import clip_scale, leaves
from tony_tpu_torch.parallel import MeshSpec as TorchMeshSpec
from tony_tpu_torch.parallel import axis_group_ranks
from tony_tpu_torch.parallel.mesh import data_row, mesh_spec
from tony_tpu_torch.io import ShardedRecordReader
from torch_ranks import launch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

# Two layers, GQA 4/2, narrow widths.
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=64, max_seq=32, dtype="float32", remat=False)


@pytest.fixture(scope="module")
def mesh():
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    with jax.sharding.set_mesh(mesh):
        yield mesh


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**TINY)
    tcfg = TransformerConfig(**TINY)
    jparams = jax_init_params(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


class _SpecMesh:
    """A mesh of the given axis sizes for the refusals, which read only
    the sizes (a real mesh needs as many processes)."""

    device_type = "cpu"

    def __init__(self, **axes):
        self.shape = TorchMeshSpec(**axes).shape

    def size(self, dim: int) -> int:
        return self.shape[dim]


def _tokens(seed, b=2, t=17):
    return np.random.default_rng(seed).integers(0, 64, (b, t)).astype(
        np.int32)


def _trainable(params):
    return {k: (_trainable(v) if isinstance(v, dict)
                else v.detach().clone().requires_grad_())
            for k, v in params.items()}


def _grads(params):
    return {k: (_grads(v) if isinstance(v, dict) else v.grad)
            for k, v in params.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v if not torch.is_tensor(v)
                                         else v.detach().float().numpy())
    return out


class TestForwardAndLoss:
    def test_fp32_logits_match_jax(self, models, mesh):
        jcfg, jparams, tcfg, tparams = models
        toks = _tokens(0, t=16)
        want = jax_forward(jparams, jnp.asarray(toks), jcfg, mesh)
        got, aux = forward(tparams, torch.as_tensor(toks), tcfg,
                           return_aux=True)
        assert aux == {} and got.dtype == torch.float32
        # fp32 throughout: products summed in another order (1e-5).
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)

    def test_lm_loss_and_gradients_match_jax(self, models, mesh):
        jcfg, jparams, tcfg, tparams = models
        toks = _tokens(1)
        (jl, jm), jg = jax.value_and_grad(jax_lm_loss, has_aux=True)(
            jparams, jnp.asarray(toks), jcfg, mesh, return_metrics=True)
        params = _trainable(tparams)
        loss, metrics = lm_loss(params, torch.as_tensor(toks), tcfg,
                                return_metrics=True)
        loss.backward()
        assert set(metrics) == set(jm) == {"cross_entropy"}
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
        want, got = _flat(jax.device_get(jg)), _flat(_grads(params))
        assert set(want) == set(got)
        for path in want:
            # Gradients of order 0.1 agree to ~1e-7 (fp32 reordering).
            np.testing.assert_allclose(got[path], want[path], atol=1e-6,
                                       err_msg=path)

    def test_bf16_forward_and_loss_match_jax_loosely(self, models, mesh):
        # bf16 compute from fp32 masters: the two frameworks round the
        # products and the residual stream at other places, so logits
        # agree to a few bf16 ulps of their scale (~1) and the loss to
        # 1e-2.
        _, jparams, _, tparams = models
        jcfg = JaxConfig(**{**TINY, "dtype": "bfloat16"})
        tcfg = TransformerConfig(**{**TINY, "dtype": "bfloat16"})
        toks = _tokens(2)
        want = jax_forward(jparams, jnp.asarray(toks[:, :-1]), jcfg, mesh)
        got = forward(tparams, torch.as_tensor(toks[:, :-1]), tcfg)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().detach().numpy(),
                                   np.asarray(want, np.float32), atol=6e-2)
        jl = jax_lm_loss(jparams, jnp.asarray(toks), jcfg, mesh)
        tl = lm_loss(tparams, torch.as_tensor(toks), tcfg)
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-2)

    @pytest.mark.parametrize("policy", ["full", "dots"])
    def test_remat_gives_the_same_gradients(self, models, policy):
        # Recomputation repeats the same fp32 arithmetic: equal to 1e-7.
        _, _, tcfg, tparams = models
        toks = torch.as_tensor(_tokens(3))
        grads = []
        for cfg in (tcfg, TransformerConfig(**{**TINY, "remat": True,
                                               "remat_policy": policy})):
            params = _trainable(tparams)
            lm_loss(params, toks, cfg).backward()
            grads.append(_flat(_grads(params)))
        for path in grads[0]:
            np.testing.assert_allclose(grads[1][path], grads[0][path],
                                       atol=1e-7, err_msg=path)

    def test_remat_unknown_policy_moe_and_mesh_raise(self, models):
        _, _, _, tparams = models
        toks = torch.as_tensor(_tokens(4))
        cfg = TransformerConfig(**{**TINY, "remat": True,
                                   "remat_policy": "offload"})
        with pytest.raises(ValueError, match="remat_policy"):
            forward(tparams, toks, cfg)
        # MoE trunks run (tests/test_torch_moe.py); dense params under an
        # MoE config, or experts the mesh's ep does not divide, raise.
        with pytest.raises(ValueError, match="experts per rank"):
            forward(tparams, toks, TransformerConfig(**{**TINY,
                                                        "n_experts": 4}))
        with pytest.raises(ValueError, match="must divide n_experts"):
            forward(tparams, toks, TransformerConfig(**{**TINY,
                                                        "n_experts": 3}),
                    mesh=_SpecMesh(ep=2))
        # tp and sp are ported for both families (tests/test_torch_tp.py,
        # tests/test_torch_sp.py, tests/test_torch_moe_tp.py,
        # tests/test_torch_moe_sp.py): an MoE trunk passes the mesh checks
        # and meets the dense trunk's refusals of its pieces (an sp block
        # longer than max_seq allows, the whole heads over tp), and a tp
        # that does not divide the K/V heads is refused.
        with pytest.raises(ValueError, match="exceeds max_seq 32"):
            forward(tparams, toks, TransformerConfig(**{**TINY,
                                                        "n_experts": 4}),
                    mesh=_SpecMesh(dp=2, sp=2))
        with pytest.raises(ValueError, match="exceeds max_seq 32"):
            forward(tparams, toks, TransformerConfig(**TINY),
                    mesh=_SpecMesh(dp=2, sp=2))
        with pytest.raises(ValueError, match="n_heads/tp = 2 heads per rank"):
            forward(tparams, toks, TransformerConfig(**{**TINY,
                                                        "n_experts": 4}),
                    mesh=_SpecMesh(tp=2))
        with pytest.raises(ValueError, match="must divide kv_heads 2"):
            forward(tparams, toks, TransformerConfig(**TINY),
                    mesh=_SpecMesh(tp=4))
        with pytest.raises(ValueError, match="gathered parameters"):
            half = {**tparams, "layers": {
                k: v[:, :16] if k in ("wq", "wk", "wv") else v
                for k, v in tparams["layers"].items()}}
            forward(half, toks, TransformerConfig(**TINY),
                    mesh=_SpecMesh(dp=2))

    def test_param_roles_match_jax(self):
        for n_experts in (0, 4):
            assert param_roles(TransformerConfig(n_experts=n_experts)) == \
                jax_param_roles(JaxConfig(n_experts=n_experts))


class TestTrainStep:
    def test_five_steps_match_jax_make_train_step(self, models, mesh):
        # Same weights, same batches, lr 1e-3 with the default clip at 1.0
        # (active: the first gradients' norm is above it). Losses agree to
        # 1e-5 and the params after 5 AdamW steps to 1e-5 (fp32
        # reordering; Adam's first steps move each weight by ~lr).
        jcfg, _, tcfg, tparams = models
        batches = [_tokens(10 + i) for i in range(5)]
        j_init, j_step = jax_make_train_step(jcfg, mesh, learning_rate=1e-3)
        t_init, t_step = make_train_step(tcfg, device="cpu",
                                         learning_rate=1e-3)
        jstate = j_init(jax.random.key(0))
        tstate = t_init(params=tparams)
        jlosses, tlosses = [], []
        for toks in batches:
            jstate, jm = j_step(jstate, toks)
            tstate, tm = t_step(tstate, toks)
            jlosses.append(float(jm["loss"]))
            tlosses.append(float(tm["loss"]))
            assert set(tm) == {"loss", "cross_entropy"}
        np.testing.assert_allclose(tlosses, jlosses, atol=1e-5)
        assert int(tstate.step) == 5
        want = _flat(jax.device_get(jstate.params))
        got = _flat(params_to_numpy(tstate.params))
        for path in want:
            np.testing.assert_allclose(got[path], want[path], atol=1e-5,
                                       err_msg=path)

    def test_state_updates_in_place_with_device_metrics(self, models):
        _, _, tcfg, tparams = models
        init_fn, step_fn = make_train_step(tcfg, device="cpu")
        given = tparams["layers"]["wq"].clone()
        state = init_fn(params=tparams)
        assert isinstance(state, TrainState) and state.step.dtype == \
            torch.int32
        wq = state.params["layers"]["wq"]
        before = wq.detach().clone()
        new, metrics = step_fn(state, _tokens(5))
        # The weights are updated in the state's own tensors (no copy).
        assert new.params["layers"]["wq"] is wq
        assert not torch.equal(wq.detach(), before)
        assert new.opt_state is state.opt_state
        for m in metrics.values():
            assert torch.is_tensor(m) and m.dim() == 0 and \
                not m.requires_grad
        # The caller's tensors are copied into the masters, never updated.
        assert torch.equal(tparams["layers"]["wq"], given)

    def test_init_from_seed_and_generator_agree(self):
        cfg = TransformerConfig(**TINY)
        init_fn, _ = make_train_step(cfg, device="cpu")
        a = init_fn(3).params
        b = init_fn(torch.Generator().manual_seed(3)).params
        for x, y in zip(leaves(a), leaves(b)):
            assert x.dtype == torch.float32 and x.requires_grad
            assert torch.equal(x, y)

    @pytest.mark.parametrize("scale", [0.999, 1.0, 1.001, 3.0])
    def test_clip_matches_optax(self, scale):
        # Global norm just below, at, and above the limit: optax leaves the
        # gradients alone only strictly below it, and divides by the norm
        # with no epsilon. The clip runs inside the fused AdamW step, which
        # leaves the clipped gradient in .grad (a zero learning rate and
        # decay here).
        rng = np.random.default_rng(7)
        raw = [rng.normal(size=s).astype(np.float32)
               for s in ((3, 4), (5,), (2, 2, 2))]
        norm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                           for x in raw))
        raw = [x * np.float32(scale / norm) for x in raw]
        max_norm = float(np.sqrt(sum(float((x.astype(np.float32) ** 2)
                                           .sum()) for x in raw)))
        max_norm = max_norm if scale == 1.0 else 1.0
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(x) for x in raw], optax.EmptyState())
        params = [torch.zeros(x.shape, requires_grad=True) for x in raw]
        for p, x in zip(params, raw):
            p.grad = torch.from_numpy(x.copy())
        opt = torch.optim.AdamW(params, lr=0.0, weight_decay=0.0,
                                fused=True)
        opt.grad_scale = clip_scale([p.grad for p in params], max_norm)
        opt.step()
        for p, ref in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref),
                                       rtol=2e-6, atol=0)

    def test_refuses_mesh_pipeline_plan(self):
        cfg = TransformerConfig(**TINY)
        # sp and pp are ported for both families (tests/test_torch_sp.py,
        # tests/test_torch_pp.py, tests/test_torch_moe_sp.py,
        # tests/test_torch_moe_pp.py), the pipeline too; an ep that does
        # not divide the experts is refused through the pipeline as it is
        # without it.
        moe = TransformerConfig(**{**TINY, "n_experts": 4})
        for axes in ({"dp": 2, "sp": 2}, {"sp": 2, "tp": 2}):
            make_train_step(cfg, _SpecMesh(**axes), device="cpu")
            make_train_step(moe, _SpecMesh(**axes), device="cpu")
        make_train_step(cfg, _SpecMesh(pp=2), device="cpu")
        make_train_step(moe, _SpecMesh(pp=2), device="cpu")
        make_train_step(moe, _SpecMesh(pp=2, ep=2), device="cpu",
                        pipeline_microbatches=2)
        with pytest.raises(ValueError, match="n_experts 3 not divisible by "
                                             "ep 2"):
            make_train_step(TransformerConfig(**{**TINY, "n_experts": 3}),
                            _SpecMesh(pp=2, ep=2), device="cpu",
                            pipeline_microbatches=2)
        # tp is ported for trunks whose heads, K/V heads, d_ff and vocab it
        # divides (tests/test_torch_tp.py, tests/test_torch_moe_tp.py),
        # an MoE trunk's experts included.
        make_train_step(moe, _SpecMesh(ep=2, tp=2), device="cpu")
        with pytest.raises(ValueError, match="must divide d_ff 63"):
            make_train_step(TransformerConfig(**{**TINY, "n_experts": 4,
                                                 "d_ff": 63}),
                            _SpecMesh(ep=2, tp=2), device="cpu")
        with pytest.raises(ValueError, match="must divide kv_heads 2"):
            make_train_step(cfg, _SpecMesh(dp=2, tp=4), device="cpu")
        with pytest.raises(ValueError, match="must divide d_ff 64"):
            make_train_step(TransformerConfig(**{**TINY, "n_heads": 3,
                                                 "n_kv_heads": 3,
                                                 "d_ff": 64}),
                            _SpecMesh(tp=3), device="cpu")
        # ep is ported (tests/test_torch_moe.py), for experts it divides.
        with pytest.raises(ValueError, match="must divide n_experts"):
            make_train_step(TransformerConfig(**{**TINY, "n_experts": 3}),
                            _SpecMesh(ep=2), device="cpu")
        cuda_mesh = _SpecMesh(dp=2)
        cuda_mesh.device_type = "cuda"
        with pytest.raises(ValueError, match="a cuda mesh cannot train on"):
            make_train_step(cfg, cuda_mesh, device="cpu")
        # The pipeline runs over a mesh's pp axis, by a known schedule.
        with pytest.raises(ValueError, match="over a mesh's pp axis"):
            make_train_step(cfg, device="cpu", pipeline_microbatches=2)
        with pytest.raises(ValueError, match="unknown schedule '1f1b'"):
            make_train_step(cfg, device="cpu", pipeline_schedule="1f1b")
        # make_train_step(plan=) is ported (tests/test_torch_stepstats.py),
        # but for a plan of more than one slice (slices are TPU pods).
        from tony_tpu_torch.parallel.plan import Plan

        with pytest.raises(ValueError, match="a plan of 2 slices"):
            make_train_step(cfg, device="cpu",
                            plan=Plan(TorchMeshSpec(dp=2), num_slices=2))

    def test_dp_step_in_two_gloo_ranks_matches_jax_and_one_process(
            self, models, tmp_path):
        """Two ranks over a dp=2 mesh, each fed its half of 3 global
        batches of 4: the losses match the JAX package's step on a dp=2
        mesh of two devices and the port's single-process step to rtol
        1e-5, and the gathered final params both to atol 1e-6 (fp32
        reordering: the global mean is a mean of the ranks' means). The
        rank program also pins the refusals (no mesh in a world of 2, an
        sp mesh) and ``sharded_batches(mesh=)``."""
        jcfg, jparams, tcfg, tparams = models
        batches = np.stack([_tokens(30 + i, b=4) for i in range(3)])
        np.savez(tmp_path / "w.npz", **_flat(jax.device_get(jparams)))
        np.save(tmp_path / "batches.npy", batches)
        corpus = np.arange(8 * 33, dtype=np.uint16).reshape(8, 33)
        corpus.tofile(tmp_path / "c.tokens")
        results = launch("train_dp", tmp_path, args=(
            tmp_path / "w.npz", tmp_path / "batches.npy",
            tmp_path / "c.tokens", 1e-3))
        got = dict(np.load(tmp_path / "train_dp.0.npz"))

        jmesh = build_mesh(MeshSpec(dp=2), devices=jax.devices()[:2])
        t_init, t_step = make_train_step(tcfg, device="cpu",
                                         learning_rate=1e-3)
        tstate = t_init(params=tparams)
        jlosses, tlosses = [], []
        with jax.sharding.set_mesh(jmesh):
            j_init, j_step = jax_make_train_step(jcfg, jmesh,
                                                 learning_rate=1e-3)
            jstate = j_init(jax.random.key(0))
            for toks in batches:
                jstate, jm = j_step(jstate, toks)
                tstate, tm = t_step(tstate, toks)
                jlosses.append(float(jm["loss"]))
                tlosses.append(float(tm["loss"]))
        for r in results:
            np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
            np.testing.assert_allclose(r["losses"], tlosses, rtol=1e-5)
        jflat = _flat(jax.device_get(jstate.params))
        tflat = _flat(params_to_numpy(tstate.params))
        for path in jflat:
            key = ".params" + "".join(f"[{k!r}]" for k in path.split("/"))
            np.testing.assert_allclose(got[key], jflat[path], atol=1e-6,
                                       err_msg=path)
            np.testing.assert_allclose(got[key], tflat[path], atol=1e-6,
                                       err_msg=path)
        # The leaves with an embed_fsdp role are split over dp, on that
        # dimension; the rest (embed, the norms) are replicated.
        split = {k: v for k, v in results[0]["split"].items()
                 if k.startswith(".params")}
        assert split == {
            ".params['layers']['wq']": [None, "dp", None, None],
            ".params['layers']['wk']": [None, "dp", None, None],
            ".params['layers']['wv']": [None, "dp", None, None],
            ".params['layers']['wo']": [None, None, None, "dp"],
            ".params['layers']['w_gate']": [None, "dp", None],
            ".params['layers']['w_up']": [None, "dp", None],
            ".params['layers']['w_down']": [None, None, "dp"],
            ".params['unembed']": ["dp", None],
        }
        refused = results[0]["refused"]
        assert refused["no_mesh"].startswith("ValueError") and \
            "build_job_mesh" in refused["no_mesh"]
        # The dense trunk over sp is taken, and an MoE trunk's step runs
        # over sp and over pp; a sequence longer than max_seq over sp (2 x
        # 17 positions) is refused.
        assert refused["sp_dense"] == ""
        assert refused["sp_mesh"] == ""
        assert refused["sp_forward"].startswith("ValueError") and \
            "exceeds max_seq 32" in refused["sp_forward"]
        assert refused["pp_mesh"] == ""
        assert "gathered parameters" in refused["pieces_forward"]
        assert "batch shard 0 of 2" in refused["wrong_shard"]
        for rank in range(2):
            first = np.load(tmp_path / f"train_dp.{rank}.npz")["first_batch"]
            np.testing.assert_array_equal(first, corpus[4 * rank:4 * rank + 2])

    def test_params_round_trip_through_numpy(self, models):
        jcfg, jparams, tcfg, tparams = models
        back = params_to_numpy(tparams)
        want = _flat(jax.device_get(jparams))
        got = _flat(back)
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path])
        bf = params_to_numpy({"w": torch.ones(2, dtype=torch.bfloat16)})
        assert bf["w"].dtype == np.float32


class TestRuntime:
    SPEC = {"worker": ["hostA:1000", "hostB:1001", "hostA:1002"],
            "evaluator": ["hostB:1003"]}

    def test_task_context_from_pytorch_runtime_env(self, monkeypatch):
        env = PyTorchRuntime().build_env(self.SPEC, "worker", 2,
                                         TonyConfiguration())
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        monkeypatch.setenv("JOB_NAME", "worker")
        monkeypatch.setenv("TASK_INDEX", "2")
        ctx = rt.task_context()
        assert (ctx.process_id, ctx.num_processes) == (2, 4)
        assert ctx.coordinator_address == "hostA:1000"
        assert ctx.is_distributed and ctx.job_name == "worker"
        assert rt.cluster_spec() == self.SPEC

    def test_local_rank_counts_earlier_tasks_on_the_same_host(self):
        # Rank order: worker 0, 1, 2, then evaluator 0.
        assert [rt.local_rank(self.SPEC, r) for r in range(4)] == [0, 0, 1, 1]
        with pytest.raises(ValueError, match="rank 4"):
            rt.local_rank(self.SPEC, 4)
        with pytest.raises(ValueError, match="'worker'"):
            rt.local_rank({"ps": ["h:1"]}, 0)

    def test_standalone_initialize_on_cpu_is_a_no_op(self, monkeypatch):
        for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                    "CLUSTER_SPEC"):
            monkeypatch.delenv(key, raising=False)
        ctx = rt.initialize(device="cpu")
        assert ctx.device == "cpu" and not ctx.is_distributed
        assert not torch.distributed.is_initialized()

    def test_initialize_joins_two_gloo_processes(self, tmp_path):
        """Two processes with a job's env (RANK, WORLD_SIZE, MASTER_*,
        CLUSTER_SPEC) join one gloo group (the rendezvous is a file store
        here), all_reduce, and get the job mesh the JAX package's
        build_job_mesh factors for two devices; make_train_step refuses
        the world without a mesh."""
        spec = json.dumps({"worker": ["127.0.0.1:1", "127.0.0.1:2"]})
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1",
               "CLUSTER_SPEC": spec}
        results = launch("initialize", tmp_path, env=env)
        assert [r["rank"] for r in results] == [0, 1]
        assert all(r["sum"] == 3.0 for r in results)
        want = list(MeshSpec.auto(2).shape)
        assert all(r["mesh"] == want for r in results)
        assert all("build_job_mesh" in r["refused"] for r in results)


TINY_CLI = ["--steps", "6", "--batch", "4", "--seq", "32", "--d-model",
            "32", "--n-layers", "2", "--n-heads", "2", "--n-kv-heads", "1",
            "--vocab", "64"]
# The model and batch flags of TINY_CLI, without --steps.
TINY_MODEL = TINY_CLI[2:]


def _motif_corpus(path, n_batches: int, fmt: str = "tokens") -> str:
    """n_batches batches of 4 records of 33 tokens: each record repeats
    one of 4 shared motifs with noise, so every batch teaches the same
    structure and the loss falls step after step."""
    rng = np.random.default_rng(0)
    motifs = rng.integers(1, 64, (4, 8))
    rows = np.tile(motifs[rng.integers(0, 4, 4 * n_batches)], 5)[:, :33]
    rows = np.where(rng.random(rows.shape) < 0.15,
                    rng.integers(1, 64, rows.shape), rows)
    if fmt == "tokens":
        rows.astype(np.uint16).tofile(path)
    else:
        write_jsonl_blocks(str(path), ({"tokens": r.tolist()} for r in rows))
    return str(path)


def _restored(ckpt_dir, step: int, model=TINY_MODEL) -> dict:
    """{path: array} of the train state checkpointed at ``step``."""
    cfg = train_cli.model_config_from_args(
        train_cli.parse_args(model), max_seq=33)
    init_fn, _ = make_train_step(cfg, device="cpu")
    state = CheckpointManager(ckpt_dir).restore(init_fn(9), step=step)
    assert state is not None, f"no step {step} under {ckpt_dir}"
    return train_state_to_numpy(state)


class TestTrainCli:
    def test_cpu_run_descends_and_exits_zero(self, capsys, tmp_path):
        assert train_cli.main(["--device", "cpu", "--ckpt-dir",
                               str(tmp_path), *TINY_CLI]) == 0
        out = capsys.readouterr().out
        assert "step 5: loss" in out and "done: loss" in out
        assert CheckpointManager(tmp_path).latest_step() == 6

    @pytest.mark.parametrize("fmt", ["tokens", "jblk"])
    def test_data_file_corpus(self, fmt, tmp_path, capsys):
        data = _motif_corpus(tmp_path / f"c.{fmt}", 3, fmt)
        ck = tmp_path / "ck"
        assert train_cli.main(["--device", "cpu", "--data", data,
                               "--lr", "3e-3", "--steps", "5",
                               "--checkpoint-every", "2", "--ckpt-dir",
                               str(ck), *TINY_MODEL]) == 0
        assert "done: loss" in capsys.readouterr().out
        assert CheckpointManager(ck)._complete_steps() == [2, 4, 5]

    def test_bad_data_is_refused(self, tmp_path):
        mixed = f"{tmp_path / 'a.jblk'},{tmp_path / 'b.tokens'}"
        with pytest.raises(ValueError, match="mixes"):
            train_cli.main(["--device", "cpu", "--data", mixed,
                            "--ckpt-dir", str(tmp_path), *TINY_CLI])
        short = _motif_corpus(tmp_path / "s.jblk", 1, "jblk")
        with pytest.raises(ValueError, match=r"seq\+1"):
            train_cli.main(["--device", "cpu", "--data", short,
                            "--ckpt-dir", str(tmp_path / "k"), *TINY_MODEL,
                            "--seq", "16"])

    def test_resumed_run_equals_a_straight_run(self, tmp_path, capsys):
        """4 + 4 steps, resumed at the end of the first epoch of a
        4-batch corpus, land bit for bit where 8 straight steps do."""
        data = _motif_corpus(tmp_path / "c.tokens", 4)
        base = ["--device", "cpu", "--data", data, "--lr", "3e-3",
                *TINY_MODEL]
        assert train_cli.main(base + ["--steps", "8", "--ckpt-dir",
                                      str(tmp_path / "a")]) == 0
        assert train_cli.main(base + ["--steps", "4", "--ckpt-dir",
                                      str(tmp_path / "b")]) == 0
        capsys.readouterr()
        assert train_cli.main(base + ["--steps", "8", "--ckpt-dir",
                                      str(tmp_path / "b")]) == 0
        assert "resumed from step 4" in capsys.readouterr().out
        a, b = _restored(tmp_path / "a", 8), _restored(tmp_path / "b", 8)
        assert set(a) == set(b)
        for path in a:
            np.testing.assert_array_equal(a[path], b[path], err_msg=path)
        # At the target already: nothing to do, exit 0.
        assert train_cli.main(base + ["--steps", "8", "--ckpt-dir",
                                      str(tmp_path / "b")]) == 0
        assert "nothing to do" in capsys.readouterr().out

    def test_resume_mid_epoch_replays_the_first_batches(self, tmp_path,
                                                         capsys):
        """The behaviour the port shares with examples/lm_train.py, pinned:
        a job resumed at step 2 of a 4-batch corpus opens a fresh reader at
        the start of the corpus, so steps 3 and 4 train on batches 0 and 1
        again, not on 2 and 3. Its step-4 state equals, bit for bit, 4
        steps on batches 0, 1, 0, 1, and differs from a straight run. Batch
        1 reads a higher loss than batch 0 here, so the resumed job's two
        losses (those of the replay's steps 3 and 4, exactly) do not
        descend and it exits 1, by the CLI's rule."""
        data = _motif_corpus(tmp_path / "c.tokens", 4)
        base = ["--device", "cpu", "--data", data, "--lr", "3e-3",
                *TINY_MODEL, "--ckpt-dir", str(tmp_path / "b")]
        assert train_cli.main(base + ["--steps", "2"]) == 0
        assert train_cli.main(base + ["--steps", "4"]) == 1
        out, err = capsys.readouterr()
        assert "resumed from step 2" in out
        cfg = train_cli.model_config_from_args(
            train_cli.parse_args(TINY_MODEL), max_seq=33)
        with ShardedRecordReader([data], 0, 1, fmt="tokens",
                                 dtype=np.uint16, record_len=33,
                                 batch_size=4) as reader:
            batches = [b.astype(np.int32) for b in reader]
        assert len(batches) == 4
        runs, losses = {}, {}
        for name, order in (("replay", (0, 1, 0, 1)),
                            ("straight", (0, 1, 2, 3))):
            init_fn, step_fn = make_train_step(cfg, device="cpu",
                                               learning_rate=3e-3)
            state = init_fn(0)
            losses[name] = []
            for i in order:
                state, metrics = step_fn(state, batches[i])
                losses[name].append(float(metrics["loss"]))
            runs[name] = train_state_to_numpy(state)
        first, last = losses["replay"][2:]
        assert f"loss did not descend: {first} -> {last}" in err
        got = _restored(tmp_path / "b", 4)
        for path in got:
            np.testing.assert_array_equal(got[path], runs["replay"][path],
                                          err_msg=path)
        assert not all(np.array_equal(got[p], runs["straight"][p])
                       for p in got)

    def test_moe_trunk_trains_resumes_and_serves(self, tmp_path, capsys):
        """--n-experts 4: the CLI trains an MoE trunk, its checkpoints
        carry the router and the expert leaves, 4 + 4 steps resumed at the
        end of the second epoch of a 2-batch corpus equal 8 straight steps
        bit for bit, and serve.py's restore of the checkpoint generates
        what a session on the restored weights does."""
        from tony_tpu_torch.models import DecodeSession

        data = _motif_corpus(tmp_path / "c.tokens", 2)
        flags = [*TINY_MODEL, "--n-experts", "4"]
        base = ["--device", "cpu", "--data", data, "--lr", "3e-3", *flags]
        assert train_cli.main(base + ["--steps", "8", "--ckpt-dir",
                                      str(tmp_path / "a")]) == 0
        assert train_cli.main(base + ["--steps", "4", "--ckpt-dir",
                                      str(tmp_path / "b")]) == 0
        assert train_cli.main(base + ["--steps", "8", "--ckpt-dir",
                                      str(tmp_path / "b")]) == 0
        assert "resumed from step 4" in capsys.readouterr().out
        cfg = train_cli.model_config_from_args(train_cli.parse_args(flags),
                                               max_seq=33)
        init_fn, _ = make_train_step(cfg, device="cpu")
        states = [CheckpointManager(tmp_path / d).restore(init_fn(9), step=8)
                  for d in ("a", "b")]
        a, b = (train_state_to_numpy(st) for st in states)
        assert ".params['layers']['router']" in a
        assert a[".params['layers']['w_gate']"].shape == (2, 4, 32, 128)
        for path in a:
            np.testing.assert_array_equal(a[path], b[path], err_msg=path)
        serve_cfg = serve_cli.model_config_from_args(
            serve_cli.parse_args(["--max-seq", "64", *flags[4:]]),
            max_seq=64)
        assert serve_cfg.n_experts == 4
        step, params = serve_cli.restore_params(str(tmp_path / "b"),
                                                serve_cfg,
                                                torch.device("cpu"))
        assert step == 8
        prompt = np.asarray([[3, 1, 4, 1, 5, 9]], np.int32)
        want = DecodeSession(states[1].params, serve_cfg,
                             device="cpu").generate(prompt, 6)
        got = DecodeSession(params, serve_cfg, device="cpu").generate(
            prompt, 6)
        np.testing.assert_array_equal(got.numpy(), want.numpy())

    def test_serve_from_the_checkpoint(self, tmp_path, capsys):
        """serve.py --ckpt answers with the restored model's greedy
        tokens."""
        import threading
        import urllib.request

        from tony_tpu_torch.models import DecodeSession

        ck = tmp_path / "ck"
        assert train_cli.main(["--device", "cpu", "--ckpt-dir", str(ck),
                               *TINY_CLI]) == 0
        addr = tmp_path / "serve.addr"
        flags = TINY_MODEL[4:]  # the model flags, without --batch/--seq
        rc = {}
        thread = threading.Thread(target=lambda: rc.setdefault(
            "rc", serve_cli.main(["--device", "cpu", "--ckpt", str(ck),
                                  "--max-seq", "64", "--slots", "2",
                                  "--port", "0", "--addr-file", str(addr),
                                  "--max-requests", "1", *flags])),
            daemon=True)
        thread.start()
        deadline = time.monotonic() + 60
        while not addr.exists():
            assert time.monotonic() < deadline and thread.is_alive()
            time.sleep(0.05)
        port = addr.read_text().strip().rpartition(":")[2]
        prompt = [3, 1, 4, 1, 5, 9]
        body = json.dumps({"prompt": prompt, "max_new_tokens": 6}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/generate", data=body),
                timeout=60) as resp:
            got = json.loads(resp.read())["tokens"]
        thread.join(timeout=60)
        assert not thread.is_alive() and rc["rc"] == 0
        assert "restored step 6" in capsys.readouterr().out
        cfg = serve_cli.model_config_from_args(serve_cli.parse_args(
            ["--max-seq", "64", *flags]), max_seq=64)
        params = serve_cli.restore_params(str(ck), cfg, torch.device("cpu"))[1]
        want = DecodeSession(params, cfg, device="cpu").generate(
            np.asarray([prompt], np.int32), 6)[0].tolist()
        assert got == want

    def test_weights_npz_start_from_jax_params(self, models, tmp_path,
                                               capsys):
        jcfg = JaxConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                         n_kv_heads=1, head_dim=16, d_ff=128, max_seq=33,
                         dtype="float32", remat=False)
        flat = _flat(jax.device_get(jax_init_params(jax.random.key(1),
                                                    jcfg)))
        path = tmp_path / "w.npz"
        np.savez(path, **flat)
        assert train_cli.main(["--device", "cpu", "--weights-npz",
                               str(path), "--ckpt-dir", str(tmp_path / "ck"),
                               *TINY_CLI]) == 0

    def test_submitted_through_the_orchestrator(self, tmp_path):
        """One worker, --framework pytorch, submitted twice with the same
        --ckpt-dir: the executor injects RANK, WORLD_SIZE, MASTER_ADDR/PORT
        and CLUSTER_SPEC; the first job trains 3 steps (one epoch of its
        corpus) and checkpoints, the second resumes and trains to 6. Its
        other --seed would give other weights from scratch, so equality
        with a straight 6-step run shows it resumed."""
        data = _motif_corpus(tmp_path / "c.tokens", 3)
        ck = tmp_path / "ck"
        env = dict(os.environ)
        env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
        run = ["--device", "cpu", "--data", data, "--lr", "3e-3",
               *TINY_MODEL]
        common = run + ["--ckpt-dir", str(ck)]
        for steps, seed in (("3", "0"), ("6", "1")):
            proc = subprocess.run(
                [sys.executable, "-m", "tony_tpu.client.cli", "local",
                 "--executes", str(REPO / "tony_tpu_torch" / "train.py"),
                 "--framework", "pytorch",
                 "--python_binary_path", sys.executable,
                 "--conf", "tony.worker.instances=1",
                 "--conf", "tony.ps.instances=0",
                 "--task_params", " ".join(common + ["--steps", steps,
                                                     "--seed", seed])],
                cwd=REPO, env=env, capture_output=True, text=True,
                timeout=300,
            )
            assert proc.returncode == 0, proc.stderr[-2000:]
        ref = tmp_path / "ref"
        assert train_cli.main(run + ["--ckpt-dir", str(ref), "--steps",
                                     "6"]) == 0
        got, want = _restored(ck, 6), _restored(ref, 6)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=path)

    def test_two_workers_train_data_parallel(self, tmp_path):
        """Two workers, --framework pytorch, on the job mesh with no spec:
        tp 2 (the model has 2 K/V heads, which tp 2 splits). Both ranks
        read data row 0 of 1, so the whole 4-batch corpus at batch 4, and
        each checkpoints its own process_<i> file of tp pieces. The final
        state equals one process trained on the same batches to atol
        1e-6. The learning rate is 1e-3: tp sums the partial products in
        another order, and AdamW's first update (m / sqrt(v), sign-like)
        turns that rounding in a gradient entry near zero into a weight
        difference proportional to the learning rate, over 1e-6 at 3e-3.
        (The dp path over processes is
        TestTrainStep::test_dp_step_in_two_gloo_ranks_matches_jax.)"""
        data = _motif_corpus(tmp_path / "c.tokens", 4)
        ck = tmp_path / "ck"
        model = [*TINY_MODEL[:-4], "--n-kv-heads", "2", *TINY_MODEL[-2:]]
        assert model[model.index("--n-heads") + 1] == "2"
        env = dict(os.environ)
        env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
        flags = ["--device", "cpu", "--data", data, "--lr", "1e-3",
                 "--steps", "4", "--checkpoint-every", "2",
                 "--dist-timeout", "60", "--ckpt-dir", str(ck), *model,
                 f"> {tmp_path}/train-$RANK.out"]
        proc = subprocess.run(
            [sys.executable, "-m", "tony_tpu.client.cli", "local",
             "--executes", str(REPO / "tony_tpu_torch" / "train.py"),
             "--framework", "pytorch",
             "--python_binary_path", sys.executable,
             "--conf", "tony.worker.instances=2",
             "--conf", "tony.ps.instances=0",
             "--task_params", " ".join(flags)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        for rank in range(2):
            out = (tmp_path / f"train-{rank}.out").read_text()
            assert (f"process {rank}/2 on cpu, mesh MeshSpec(dp=1, pp=1, "
                    f"ep=1, sp=1, tp=2), data row 0 of 1") in out, out
        for step in (2, 4):
            names = {p.name for p in (ck / f"step_{step}").iterdir()}
            assert {"process_0.npz", "process_1.npz"} <= names, names
            meta = json.loads((ck / f"step_{step}" / "metadata.json")
                              .read_text())
            assert meta["num_processes"] == 2
        cfg = train_cli.model_config_from_args(
            train_cli.parse_args(model), max_seq=33)
        with ShardedRecordReader([data], 0, 1, fmt="tokens",
                                 dtype=np.uint16, record_len=33,
                                 batch_size=4) as reader:
            batches = [b.astype(np.int32) for b in reader]
        assert len(batches) == 4
        init_fn, step_fn = make_train_step(cfg, device="cpu",
                                           learning_rate=1e-3)
        state = init_fn(0)
        for batch in batches:
            state, _ = step_fn(state, batch)
        got, want = _restored(ck, 4, model), train_state_to_numpy(state)
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_allclose(got[path], want[path], atol=1e-6,
                                       err_msg=path)

    @pytest.mark.parametrize("axes", [
        dict(dp=2), dict(tp=2), dict(dp=2, tp=2), dict(sp=2, tp=2),
        dict(ep=2, tp=2), dict(dp=2, ep=2), dict(pp=2, ep=2),
        dict(dp=2, pp=2, ep=2, sp=2, tp=2)])
    def test_data_row_of_each_rank(self, axes):
        """The corpus shard of a rank is its (dp, ep) coordinate, dp major,
        of dp x ep rows: the pp, sp and tp ranks of a data row read the
        same shard, and every row is read by pp x sp x tp ranks."""
        spec = mesh_spec(_SpecMesh(**axes))
        grid = np.arange(spec.num_devices).reshape(spec.shape)
        rows = spec.dp * spec.ep
        for rank in range(spec.num_devices):
            dp, _, ep, _, _ = (int(c[0]) for c in np.nonzero(grid == rank))
            assert data_row(spec, rank) == (dp * spec.ep + ep, rows)
        for group in axis_group_ranks(spec, ("pp", "sp", "tp")):
            assert len({data_row(spec, r) for r in group}) == 1
        counts = np.bincount([data_row(spec, r)[0]
                              for r in range(spec.num_devices)])
        assert counts.tolist() == [spec.pp * spec.sp * spec.tp] * rows

    def test_refuses_a_model_tp_does_not_split(self, monkeypatch,
                                               tmp_path):
        """On the job mesh the CLI trains the model as the mesh splits it
        or not at all: one K/V head over tp 2 raises, no fallback to dp."""
        for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                    "CLUSTER_SPEC"):
            monkeypatch.delenv(key, raising=False)
        monkeypatch.setattr(rt, "build_job_mesh",
                            lambda **kw: _SpecMesh(tp=2))
        args = train_cli.parse_args(["--device", "cpu", "--ckpt-dir",
                                     str(tmp_path), *TINY_CLI])
        ctx = rt.initialize(device="cpu")
        with pytest.raises(ValueError, match="tp 2 must divide kv_heads 1"):
            train_cli._train(args, ctx)
        assert not (tmp_path / "step_1").exists()
