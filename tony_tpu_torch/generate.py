"""LM generation from a checkpoint on the card: the port's counterpart of
``examples/lm_generate.py``, as ``train.py`` is of ``lm_train.py``.

    python -m tony_tpu_torch.generate --device cuda --ckpt CKPT_DIR \\
        --prompt 1,5,9:7,2 --max-new 16 --d-model 128 --n-layers 2

Submitted through the orchestrator with ``--framework pytorch``::

    python -m tony_tpu.client.cli local \\
        --executes tony_tpu_torch/generate.py --framework pytorch \\
        --conf tony.worker.instances=1 \\
        --task_params "--device cpu --ckpt CKPT_DIR --max-new 16"

``--ckpt`` is a checkpoint directory or ``gs://`` prefix written by
``train.py`` or by the JAX package's ``lm_train.py`` (the model flags must
match the training config; they are ``train.py``'s); the newest complete step is restored
into a ``make_train_step`` template and the script prints ``restored step
N from ...``, or exits 2 when no step is complete. Without ``--ckpt`` the
weights are fresh from ``--seed``. ``--prompt`` takes token ids, ``,``
between tokens and ``:`` between rows; ragged rows are left-padded with 0.
The script calls ``runtime.initialize()`` and ``runtime.build_job_mesh()``
with no spec: with more than one process the restored pieces are gathered
and served through ``DecodeSession(mesh=)`` (two processes: tp 2), alone
through the plain session. Every rank prints ``generated[i]: ...`` for
every row, greedy (``--temperature 0``) or sampled from ``--seed``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import tony_tpu_torch.runtime as rt
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.models import DecodeSession, init_params, make_train_step
from tony_tpu_torch.parallel import all_gather_tp
from tony_tpu_torch.parallel.mesh import mesh_spec
from tony_tpu_torch.train import add_model_args, model_config_from_args


def parse_args(argv):
    p = argparse.ArgumentParser(description="tony_tpu_torch LM generation")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    p.add_argument("--ckpt", default="",
                   help="checkpoint dir or gs:// prefix from train.py or "
                        "lm_train.py (empty: fresh weights from --seed)")
    p.add_argument("--prompt", default="1,5,9,2",
                   help="comma-separated token ids; ':' separates batch "
                        "rows (shell-safe: task params pass through "
                        "bash -c)")
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--eos", type=int, default=-1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-seq", type=int, default=256)
    add_model_args(p)
    return p.parse_args(argv)


def prompt_rows(text: str) -> np.ndarray:
    """[B, T] int32 from ``1,5,9:7,2``: ragged rows left-padded with 0 (a
    run of token 0 ahead of a short prompt)."""
    rows = [[int(t) for t in row.split(",") if t.strip()]
            for row in text.split(":")]
    width = max(len(r) for r in rows)
    return np.asarray([[0] * (width - len(r)) + r for r in rows], np.int32)


def whole_params(state, mesh) -> dict:
    """The whole parameters of a restored ``TrainState`` on every rank:
    each leaf's split dimensions all-gathered over their mesh axes
    (without a mesh the leaves are whole already)."""
    def whole(value, placement):
        if isinstance(value, dict):
            return {k: whole(v, placement and placement[k])
                    for k, v in value.items()}
        value = value.detach()
        for dim, axes in enumerate(placement.spec if placement else ()):
            if axes is not None:
                value = all_gather_tp(value, dim, axes, mesh=mesh)
        return value

    return whole(state.params, state.placements)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    ctx = rt.initialize(device=args.device)
    try:
        return _generate(args, ctx)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _generate(args, ctx) -> int:
    device = torch.device(ctx.device)
    cfg = model_config_from_args(args, max_seq=args.max_seq)
    mesh = rt.build_job_mesh(device=ctx.device)
    print(f"[{ctx.job_name}:{ctx.task_index}] process {ctx.process_id}/"
          f"{ctx.num_processes} on {device}, mesh "
          f"{mesh_spec(mesh) if mesh is not None else None}", flush=True)
    if not args.ckpt:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = init_params(cfg, gen, device)
    else:
        # The training job checkpoints the whole TrainState, so the
        # template is one; a checkpoint written on another number of
        # processes is reassembled from every shard file.
        init_fn, _ = make_train_step(cfg, mesh, device=device,
                                     learning_rate=1e-2)
        mgr = CheckpointManager(args.ckpt, process_id=ctx.process_id,
                                num_processes=ctx.num_processes)
        restored = mgr.restore(init_fn(0))
        if restored is None:
            print(f"no complete checkpoint under {args.ckpt}",
                  file=sys.stderr)
            return 2
        params = whole_params(restored, mesh)
        print(f"restored step {int(restored.step)} from {args.ckpt}",
              flush=True)
    prompt = prompt_rows(args.prompt)
    # Alone the mesh is None: the plain session. Over a mesh every rank
    # builds the session from the whole weights, keeps its pieces and gets
    # the whole batch back.
    session = DecodeSession(params, cfg, device=device, mesh=mesh)
    generator = None
    if args.temperature > 0:
        generator = torch.Generator(device=device)
        generator.manual_seed(args.seed)
    out = session.generate(
        prompt, args.max_new, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        eos_token=None if args.eos < 0 else args.eos, generator=generator,
    )
    for i, row in enumerate(out.cpu().numpy()):
        print(f"generated[{i}]: {','.join(str(int(t)) for t in row)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
