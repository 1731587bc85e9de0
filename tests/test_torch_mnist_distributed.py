"""The port's distributed MNIST script held against
``examples/mnist_distributed.py`` on the CPU: the same synthetic data bit
for bit, the same loss and SGD-momentum steps as JAX's ``loss_fn`` and
``optax.sgd(lr, momentum=0.9)`` on carried weights, and two workers
submitted through the orchestrator with ``--framework pytorch`` (gloo),
the chief's metrics, and a rerun that resumes from the checkpoint."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tony_tpu_torch import mnist_distributed as port
from tony_tpu_torch.checkpoint import CheckpointManager

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _example():
    spec = importlib.util.spec_from_file_location(
        "mnist_distributed_example", REPO / "examples" / "mnist_distributed.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_mnist_is_bit_equal_to_the_example():
    example = _example()
    for seed, n in ((0, 4096), (3, 100)):
        want_x, want_y = example.synthetic_mnist(seed, n)
        got_x, got_y = port.synthetic_mnist(seed, n)
        assert got_x.dtype == want_x.dtype and got_y.dtype == want_y.dtype
        np.testing.assert_array_equal(got_x, want_x)
        np.testing.assert_array_equal(got_y, want_y)


def test_sgd_momentum_steps_equal_jax_loss_fn_and_optax_sgd():
    """From the port's weights (seed 0) on the same batches: each step's
    loss and accuracy, and the weights after each of three steps (the
    momentum trace in play from the second), within rtol 1e-5 and atol
    1e-6 of the example's loss_fn under optax.sgd(lr, momentum=0.9)."""
    example = _example()
    images, labels = port.synthetic_mnist(0, 256)
    params = port.init_params(torch.Generator().manual_seed(0), "cpu")
    trace = {k: torch.zeros_like(v) for k, v in params.items()}
    # Copies: on the CPU jnp.asarray may alias the numpy view of a tensor
    # that the port's step then updates in place.
    jparams = {k: jnp.asarray(v.numpy().copy()) for k, v in params.items()}
    tx = optax.sgd(1e-2, momentum=0.9)
    jopt = tx.init(jparams)
    grad_fn = jax.value_and_grad(example.loss_fn, has_aux=True)
    for step in range(3):
        x, y = images[64 * step:64 * (step + 1)], labels[64 * step:64 * (step + 1)]
        loss, acc = port.train_step(params, trace, torch.from_numpy(x),
                                    torch.from_numpy(y), 1e-2)
        (jloss, jacc), grads = grad_fn(jparams, jnp.asarray(x),
                                       jnp.asarray(y))
        updates, jopt = tx.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-5)
        for key, value in params.items():
            np.testing.assert_allclose(value.detach().numpy(),
                                       np.asarray(jparams[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def _submit(tmp_path: Path, flags: list[str]) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # the workers share the cores with others
    return subprocess.run(
        [sys.executable, "-m", "tony_tpu.client.cli", "local",
         "--executes", str(REPO / "tony_tpu_torch" / "mnist_distributed.py"),
         "--framework", "pytorch",
         "--python_binary_path", sys.executable,
         "--conf", "tony.worker.instances=2",
         "--conf", "tony.ps.instances=0",
         "--task_params", " ".join(flags)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )


def test_two_workers_train_write_metrics_and_resume(tmp_path):
    """Two workers over gloo: both finish, the chief writes
    mnist_metrics.json (finite loss, 2 processes), checkpoints land at
    steps 10 and 12; a rerun to 20 steps resumes from step 12 on both
    ranks and checkpoints at 20."""
    ck = tmp_path / "ck"
    flags = ["--device", "cpu", "--dist-timeout", "60",
             "--checkpoint_dir", str(ck), "--working_dir", str(tmp_path)]
    proc = _submit(tmp_path, flags + ["--steps", "12",
                                      f"> {tmp_path}/a-$RANK.out"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = json.loads((tmp_path / "mnist_metrics.json").read_text())
    assert metrics["num_processes"] == 2 and metrics["steps"] == 12
    assert np.isfinite(metrics["final_loss"])
    for rank in range(2):
        assert f"process {rank}/2 on cpu" in (
            tmp_path / f"a-{rank}.out").read_text()
    assert {p.name for p in ck.iterdir()} >= {"step_10", "step_12"}
    assert {p.name for p in (ck / "step_12").iterdir()} >= {
        "process_0.npz", "process_1.npz"}
    # The gradients were averaged over the world: both replicas hold the
    # same weights and momentum, each in its own file.
    template = {"params": port.init_params(torch.Generator(), "cpu")}
    template["opt_state"] = {"trace": dict(template["params"])}
    template["step"] = torch.zeros((), dtype=torch.int32)
    a, b = (CheckpointManager(ck, process_id=r, num_processes=2)
            .restore(template, step=12) for r in range(2))
    assert int(a["step"]) == int(b["step"]) == 12
    for key in a["params"]:
        assert torch.equal(a["params"][key], b["params"][key]), key
        assert torch.equal(a["opt_state"]["trace"][key],
                           b["opt_state"]["trace"][key]), key

    proc = _submit(tmp_path, flags + ["--steps", "20",
                                      f"> {tmp_path}/b-$RANK.out"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    for rank in range(2):
        out = (tmp_path / f"b-{rank}.out").read_text()
        assert "resumed from checkpoint step 12" in out, out
        assert "step 11:" not in out and "step 19:" in out
    metrics = json.loads((tmp_path / "mnist_metrics.json").read_text())
    assert metrics["steps"] == 20 and np.isfinite(metrics["final_loss"])
    assert (ck / "step_20").is_dir()
