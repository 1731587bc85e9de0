"""Distributed MNIST on the card: the port's counterpart of
``examples/mnist_distributed.py``, as ``train.py`` is of
``examples/lm_train.py``.

The script makes one framework call before touching the card::

    ctx = tony_tpu_torch.runtime.initialize()

and then trains data-parallel: every process computes gradients on its own
rows of the data (row ``process_id`` of every ``num_processes``), and the
gradients are averaged over the world (the port's ``pmean_gradients`` over
the dp axis of a ``MeshSpec(dp=world)`` job mesh), so the replicas step in
lockstep. The model is the example's MLP (784 -> 128 -> 10, weights normal
x 0.05 from ``--seed``), the loss its ``loss_fn``, and the optimizer SGD
with momentum 0.9 as ``optax.sgd(lr, momentum=0.9)`` computes it (trace =
g + 0.9 trace; p -= lr trace). The data is the example's synthetic MNIST,
the same numpy draws, so the arrays are bit-equal.

With ``--checkpoint_dir`` it saves every 10th step and the last one, and a
rerun resumes from the newest complete step. The chief writes
``mnist_metrics.json`` (final loss and accuracy, steps, steps/s, process
count) to ``--working_dir``.

Submit it locally (2 data-parallel workers over gloo on the CPU)::

    python -m tony_tpu.client.cli local \\
        --executes tony_tpu_torch/mnist_distributed.py \\
        --framework pytorch \\
        --conf tony.worker.instances=2 --conf tony.ps.instances=0 \\
        --task_params "--device cpu --steps 30"

``--device`` defaults to cuda, and cuda without a card raises.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import tony_tpu_torch.runtime as rt
from tony_tpu_torch import constants
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.parallel.collectives import pmean_gradients
from tony_tpu_torch.parallel.mesh import MeshSpec


def synthetic_mnist(seed: int, n: int = 4096):
    """Deterministic MNIST-shaped data: 28x28 images whose class signal is a
    bright patch at a label-dependent position (learnable, egress-free)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=(n,))
    images = rng.normal(0.0, 0.3, size=(n, 28, 28, 1)).astype(np.float32)
    for i, lbl in enumerate(labels):
        r, c = divmod(int(lbl), 4)
        images[i, 4 + 5 * r: 9 + 5 * r, 4 + 6 * c: 10 + 6 * c, 0] += 1.5
    return images, labels.astype(np.int32)


def init_params(generator: torch.Generator, device) -> dict:
    """The example's MLP: normal x 0.05 weights, zero biases (fp32)."""
    def normal(shape):
        return torch.randn(shape, generator=generator, device=device) * 0.05

    return {"w1": normal((784, 128)), "b1": torch.zeros(128, device=device),
            "w2": normal((128, 10)), "b2": torch.zeros(10, device=device)}


def loss_fn(params: dict, images: torch.Tensor, labels: torch.Tensor):
    """(mean cross-entropy, accuracy) of the MLP on images [B, 28, 28, 1]."""
    x = images.reshape(images.shape[0], -1)
    h = F.relu(x @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    picked = F.log_softmax(logits, -1).gather(-1, labels[:, None].long())
    loss = -picked.mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


def train_step(params: dict, trace: dict, images, labels, lr: float,
               mesh=None):
    """One step, in place: gradients of ``loss_fn`` (averaged over the
    mesh's dp axis when there is one), then SGD with momentum 0.9 as optax
    computes it. Returns (loss, accuracy) as 0-d tensors."""
    keys = sorted(params)
    leaves = [params[k].requires_grad_() for k in keys]
    loss, acc = loss_fn(params, images, labels)
    grads = list(torch.autograd.grad(loss, leaves))
    if mesh is not None:
        pmean_gradients(grads, mesh, "dp")
    bufs = [trace[k] for k in keys]
    with torch.no_grad():
        torch._foreach_mul_(bufs, 0.9)
        torch._foreach_add_(bufs, grads)
        torch._foreach_add_(leaves, bufs, alpha=-lr)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), acc


def parse_args(argv):
    ap = argparse.ArgumentParser(description="tony_tpu_torch MNIST")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch_size", type=int, default=64,
                    help="rows a step per process")
    ap.add_argument("--learning_rate", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--working_dir",
                    default=os.environ.get(constants.TONY_LOG_DIR, "."),
                    help="where the chief writes final metrics")
    ap.add_argument("--checkpoint_dir", default="",
                    help="save every 10th step and the last; a rerun "
                         "resumes from the newest complete step")
    ap.add_argument("--dist-timeout", type=float, default=300.0,
                    help="seconds a collective waits for a peer")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    ctx = rt.initialize(device=args.device, timeout_s=args.dist_timeout)
    try:
        return _train(args, ctx)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args, ctx) -> int:
    world = max(ctx.num_processes, 1)
    mesh = rt.build_job_mesh(MeshSpec(dp=world) if world > 1 else None,
                             ctx.device, timeout_s=args.dist_timeout)
    print(f"[{ctx.job_name}:{ctx.task_index}] process {ctx.process_id}/"
          f"{world} on {ctx.device}", flush=True)
    images, labels = synthetic_mnist(seed=0)
    images = torch.from_numpy(images[ctx.process_id::world]).to(ctx.device)
    labels = torch.from_numpy(labels[ctx.process_id::world]).to(ctx.device)

    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(args.seed)
    params = init_params(gen, ctx.device)
    state = {"params": params,
             "opt_state": {"trace": {k: torch.zeros_like(v)
                                     for k, v in params.items()}},
             "step": torch.zeros((), dtype=torch.int32, device=ctx.device)}
    mgr = None
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir,
                                process_id=ctx.process_id,
                                num_processes=world)
        restored = mgr.restore(state)
        if restored is not None:
            state = restored
            print(f"resumed from checkpoint step {int(state['step'])}",
                  flush=True)
    start = int(state["step"])
    if start >= args.steps:
        print(f"training already complete at step {start}", flush=True)
        return 0

    per_step = args.batch_size
    t0 = time.time()
    loss = acc = float("nan")
    for step in range(start, args.steps):
        lo = (step * per_step) % (len(images) - per_step or 1)
        loss_t, acc_t = train_step(
            state["params"], state["opt_state"]["trace"],
            images[lo:lo + per_step], labels[lo:lo + per_step],
            args.learning_rate, mesh)
        loss, acc = float(loss_t), float(acc_t)
        state["step"].fill_(step + 1)
        if mgr is not None and (step % 10 == 9 or step == args.steps - 1):
            mgr.save(step + 1, state)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step}: loss={loss:.4f} acc={acc:.3f}", flush=True)
    if mgr is not None:
        mgr.wait()  # the writes must be durable before exit
    elapsed = time.time() - t0
    if not math.isfinite(loss):
        print("non-finite loss", file=sys.stderr)
        return 1
    if ctx.process_id == 0:
        metrics = {
            "final_loss": loss, "final_acc": acc, "steps": args.steps,
            "steps_per_sec": (args.steps - start) / max(elapsed, 1e-9),
            "num_processes": world,
        }
        path = os.path.join(args.working_dir, "mnist_metrics.json")
        with open(path, "w") as f:
            json.dump(metrics, f)
        print(f"chief wrote {path}: {metrics}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
