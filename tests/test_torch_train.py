"""The port's training slice held against the JAX package on the CPU: the
training forward's logits, ``lm_loss`` and its gradients on the same
converted weights, remat policies, a 5-step trajectory of ``make_train_step``
(clip + AdamW) with the final params, and the clip against optax. Then the
runtime (``task_context``, ``local_rank``, ``initialize`` in two gloo
processes), the train CLI, and one run submitted through the orchestrator
with ``--framework pytorch``. Inputs come from seeded numpy generators; all
comparisons are fp32 unless a test says otherwise."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
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
from tony_tpu_torch import train as train_cli
from tony_tpu_torch.interop import params_from_numpy, params_to_numpy
from tony_tpu_torch.models import (
    TrainState,
    TransformerConfig,
    forward,
    lm_loss,
    make_train_step,
    param_roles,
)
from tony_tpu_torch.models.train import clip_by_global_norm_, leaves

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
        with pytest.raises(NotImplementedError, match="slice 4"):
            forward(tparams, toks, TransformerConfig(**{**TINY,
                                                        "n_experts": 4}))
        with pytest.raises(NotImplementedError, match="slice 3"):
            forward(tparams, toks, TransformerConfig(**TINY), mesh=object())

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
        # with no epsilon.
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
        got = [torch.from_numpy(x.copy()) for x in raw]
        clip_by_global_norm_(got, max_norm)
        for x, ref in zip(got, want):
            np.testing.assert_allclose(x.numpy(), np.asarray(ref),
                                       rtol=2e-6, atol=0)

    def test_refuses_mesh_pipeline_plan(self):
        cfg = TransformerConfig(**TINY)
        with pytest.raises(NotImplementedError, match="slice 3"):
            make_train_step(cfg, object(), device="cpu")
        with pytest.raises(NotImplementedError, match="slice 4"):
            make_train_step(cfg, device="cpu", pipeline_microbatches=2)
        with pytest.raises(NotImplementedError, match="slice 4"):
            make_train_step(cfg, device="cpu", pipeline_schedule="1f1b")
        with pytest.raises(NotImplementedError, match="slice 7"):
            make_train_step(cfg, device="cpu", plan=object())

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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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

    def test_initialize_joins_two_gloo_processes(self):
        code = textwrap.dedent("""
            import json, torch
            import tony_tpu_torch.runtime as rt
            from tony_tpu_torch.models import TransformerConfig, make_train_step
            ctx = rt.initialize(device="cpu")
            x = torch.tensor([ctx.process_id + 1.0])
            torch.distributed.all_reduce(x)
            try:
                make_train_step(TransformerConfig(), device="cpu")
                refused = ""
            except NotImplementedError as e:
                refused = str(e)
            torch.distributed.destroy_process_group()
            print(json.dumps({"rank": ctx.process_id, "sum": x.item(),
                              "refused": refused}))
        """)
        port = _free_port()
        spec = json.dumps({"worker": [f"127.0.0.1:{port}",
                                      "127.0.0.1:0"]})
        procs = []
        for rank in range(2):
            env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2",
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                   "CLUSTER_SPEC": spec,
                   "PYTHONPATH": str(REPO) + os.pathsep
                   + os.environ.get("PYTHONPATH", "")}
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        results = []
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err[-2000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
        assert sorted(r["rank"] for r in results) == [0, 1]
        assert all(r["sum"] == 3.0 for r in results)
        assert all("slice 3" in r["refused"] for r in results)


TINY_CLI = ["--steps", "6", "--batch", "4", "--seq", "32", "--d-model",
            "32", "--n-layers", "2", "--n-heads", "2", "--n-kv-heads", "1",
            "--vocab", "64"]


class TestTrainCli:
    def test_cpu_run_descends_and_exits_zero(self, capsys):
        assert train_cli.main(["--device", "cpu", *TINY_CLI]) == 0
        out = capsys.readouterr().out
        assert "step 5: loss" in out and "done: loss" in out

    def test_data_and_ckpt_wait_for_later_slices(self):
        with pytest.raises(NotImplementedError, match="input slice"):
            train_cli.main(["--device", "cpu", "--data", "x.bin"])
        with pytest.raises(NotImplementedError, match="checkpoint slice"):
            train_cli.main(["--device", "cpu", "--ckpt-dir", "ck"])

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
                               str(path), *TINY_CLI]) == 0

    def test_submitted_through_the_orchestrator(self):
        """One worker, --framework pytorch: the executor injects RANK,
        WORLD_SIZE, MASTER_ADDR/PORT and CLUSTER_SPEC; the script trains
        and exits 0 with a descending loss."""
        env = dict(os.environ)
        env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
        proc = subprocess.run(
            [sys.executable, "-m", "tony_tpu.client.cli", "local",
             "--executes", str(REPO / "tony_tpu_torch" / "train.py"),
             "--framework", "pytorch",
             "--python_binary_path", sys.executable,
             "--conf", "tony.worker.instances=1",
             "--conf", "tony.ps.instances=0",
             "--task_params", " ".join(["--device", "cpu", *TINY_CLI])],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
