"""Flagship LM training on the card: the port's counterpart of
``examples/lm_train.py``, as ``serve.py`` is of ``lm_serve.py``.

    python -m tony_tpu_torch.train --device cuda --steps 20 --batch 8 \\
        --seq 128 --d-model 128 --n-layers 2

Submitted through the orchestrator with ``--framework pytorch``::

    python -m tony_tpu.client.cli local \\
        --executes tony_tpu_torch/train.py --framework pytorch \\
        --conf tony.worker.instances=2 --conf tony.ps.instances=0 \\
        --task_params "--device cpu --steps 10 --d-model 64 --n-layers 2"

The script calls ``runtime.initialize()`` and ``runtime.build_job_mesh()``
first: with more than one process it trains data-parallel over the job's
mesh (``--batch`` is per process, so the global batch is ``--batch`` times
the process count), each process checkpointing its own pieces; alone it
runs the single-device step. It trains on ``--data``
(comma-separated paths: ``*.jblk`` block-compressed jsonl containers with a
``tokens`` field per record, anything else fixed-width uint16 token records
of length seq+1), read through ``runtime.sharded_reader`` (each process
reads its own byte range; the reader reopens every epoch) and carried onto
the device by ``io.device_prefetch``; without ``--data``, lm_train.py's
synthetic motif corpus. Weights are fresh from ``--seed`` or read with
``--weights-npz`` from a numpy dump of JAX params.

Checkpoints go to ``--ckpt-dir``, else ``$TONY_CHECKPOINT_DIR``, else
``$TONY_LOG_DIR/lm-checkpoints``, in the JAX package's format: every
``--checkpoint-every`` steps, when the coordinator's flush order asks, and
once more (blocking) at the end. A run first restores the newest complete
step (``TONY_RESUME_STEP`` first, in a retried session), prints ``resumed
from step N``, and exits 0 at once when that is already ``--steps``. It
prints ``step N: loss X`` and exits 1 unless the loss of the steps it ran
is finite and descended.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch

import tony_tpu_torch.runtime as rt
from tony_tpu_torch import constants
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.interop import params_from_npz
from tony_tpu_torch.io import device_prefetch
from tony_tpu_torch.models import TransformerConfig, make_train_step
from tony_tpu_torch.parallel.mesh import MeshSpec, mesh_spec


def parse_args(argv):
    p = argparse.ArgumentParser(description="tony_tpu_torch LM training")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--weights-npz", default="",
                   help="numpy dump of JAX params (empty: fresh weights "
                        "from --seed)")
    p.add_argument("--data", default="",
                   help="corpus path(s, comma-sep): *.jblk = block-"
                        "compressed jsonl containers with a 'tokens' "
                        "field per record; anything else = fixed-width "
                        "uint16 token records of length seq+1. Empty: "
                        "the synthetic motif corpus.")
    p.add_argument("--checkpoint-every", type=int, default=10)
    p.add_argument("--dist-timeout", type=float, default=300.0,
                   help="seconds a collective waits for a peer before "
                        "failing (process group timeout)")
    p.add_argument("--ckpt-dir", default="",
                   help="checkpoint dir (default: $TONY_CHECKPOINT_DIR, "
                        "else $TONY_LOG_DIR/lm-checkpoints)")
    # Model flags with lm_train.py's names and defaults.
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--n-kv-heads", type=int, default=2)
    p.add_argument("--n-experts", type=int, default=0)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--dtype", default="float32",
                   help="float32 or bfloat16")
    return p.parse_args(argv)


def model_config_from_args(args, *, max_seq: int) -> TransformerConfig:
    """The arg -> config derivation of examples/lm_train.py."""
    return TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        head_dim=max(8, args.d_model // args.n_heads),
        d_ff=args.d_model * 4, max_seq=max_seq,
        n_kv_heads=args.n_kv_heads, n_experts=args.n_experts,
        dtype=args.dtype, remat=False,
    )


def synthetic_tokens(seed: int, n_docs: int, seq: int, vocab: int):
    """lm_train.py's corpus: repeated 8-token motifs per document with 15 %
    noise tokens, so the LM has structure to learn without any input
    files."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        motif = rng.integers(1, vocab, size=(8,))
        reps = -(-(seq + 1) // len(motif))
        noise = rng.integers(1, vocab, size=(seq + 1,))
        doc = np.tile(motif, reps)[: seq + 1]
        mask = rng.random(seq + 1) < 0.15
        doc = np.where(mask, noise, doc)
        docs.append(doc)
    return np.stack(docs).astype(np.int32)


def _file_batches(args, ctx):
    """Endless [batch, seq+1] int32 host batches from ``--data``, one
    reader per epoch (the splits re-shard identically), with
    examples/lm_train.py's validation."""
    paths = [p for p in args.data.split(",") if p]
    if not paths:
        raise ValueError("--data given but no paths parsed from it")
    jblk = [p.endswith(".jblk") for p in paths]
    if any(jblk) and not all(jblk):
        # A .jblk container fed to the fixed-width reader decodes
        # compressed bytes as token ids — garbage that trains without
        # erroring. Refuse the ambiguity.
        raise ValueError(
            f"--data mixes .jblk containers with raw token files: {paths}"
        )
    checked = False
    while True:
        yielded = 0
        if all(jblk):
            with rt.sharded_reader(
                paths, fmt="jsonl-blocks", batch_size=args.batch
            ) as r:
                for recs in r:
                    if not checked and recs:
                        # Validate the first record once, up front: a
                        # missing 'tokens' field or a wrong-width list would
                        # otherwise surface as an opaque error mid-training.
                        first = recs[0]
                        tokens = first.get("tokens") if isinstance(
                            first, dict) else None
                        if tokens is None or not hasattr(tokens, "__len__"):
                            fields = (sorted(first) if isinstance(first, dict)
                                      else type(first).__name__)
                            raise ValueError(
                                f"--data {args.data}: records must carry a "
                                f"'tokens' list; first record has fields "
                                f"{fields}"
                            )
                        if len(tokens) != args.seq + 1:
                            raise ValueError(
                                f"--data {args.data}: 'tokens' must be "
                                f"length seq+1 = {args.seq + 1} "
                                f"(targets are inputs shifted by one); "
                                f"first record has {len(tokens)}"
                            )
                        checked = True
                    if len(recs) == args.batch:
                        yielded += 1
                        yield np.asarray(
                            [rec["tokens"] for rec in recs], np.int32
                        )
        else:
            with rt.sharded_reader(
                paths, fmt="tokens", dtype=np.uint16,
                record_len=args.seq + 1, batch_size=args.batch,
            ) as r:
                for b in r:
                    if b.shape[0] == args.batch:
                        yielded += 1
                        yield b.astype(np.int32)
        if not yielded:
            # This process's byte-range shard holds less than one full
            # batch: re-opening forever would hang training silently.
            raise RuntimeError(
                f"--data {args.data}: process {ctx.process_id}'s shard "
                f"yielded no full batch of {args.batch} (corpus too "
                f"small for this process count / batch size)"
            )


def corpus_batches(args, ctx):
    """Endless [batch, seq+1] int32 host batches: from ``--data`` through
    the sharded reader, else from this process's shard of the synthetic
    corpus."""
    if args.data:
        yield from _file_batches(args, ctx)
        return
    corpus = synthetic_tokens(0, n_docs=64, seq=args.seq, vocab=args.vocab)
    shard = corpus[ctx.process_id::max(ctx.num_processes, 1)]
    rng = np.random.default_rng(ctx.process_id)
    while True:
        yield shard[rng.integers(0, len(shard), size=(args.batch,))]


def checkpoint_dir(args) -> str:
    """--ckpt-dir, else the coordinator-probed TONY_CHECKPOINT_DIR, else
    the job's scratch dir (TONY_LOG_DIR, or the working directory)."""
    scratch = os.environ.get(constants.TONY_LOG_DIR, ".")
    return (args.ckpt_dir
            or os.environ.get(constants.TONY_CHECKPOINT_DIR)
            or os.path.join(scratch, "lm-checkpoints"))


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    ctx = rt.initialize(device=args.device, timeout_s=args.dist_timeout)
    try:
        return _train(args, ctx)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args, ctx) -> int:
    # Data parallel over every process. The JAX example's build_job_mesh()
    # with no spec factors tp first (tp 2 from two processes), whose ranks
    # must feed the same rows, where each process reads its own shard.
    mesh = rt.build_job_mesh(MeshSpec(dp=ctx.num_processes),
                             device=ctx.device, timeout_s=args.dist_timeout)
    print(f"[{ctx.job_name}:{ctx.task_index}] process {ctx.process_id}/"
          f"{ctx.num_processes} on {ctx.device}, mesh "
          f"{mesh_spec(mesh) if mesh is not None else None}", flush=True)
    cfg = model_config_from_args(args, max_seq=args.seq + 1)
    init_fn, step_fn = make_train_step(cfg, mesh, device=ctx.device,
                                       learning_rate=args.lr)
    if args.weights_npz:
        state = init_fn(params=params_from_npz(args.weights_npz, cfg,
                                               ctx.device))
    else:
        state = init_fn(args.seed)
    mgr = CheckpointManager(checkpoint_dir(args), process_id=ctx.process_id,
                            num_processes=ctx.num_processes)
    # Checkpoint-aware restart: a retried session is told the newest step
    # the coordinator saw complete (TONY_RESUME_STEP); outside a retry the
    # newest complete step is restored. The state is restored in place.
    if mgr.restore_resumable(state) is not None:
        print(f"resumed from step {int(state.step)}", flush=True)
    step = int(state.step)
    if step >= args.steps:
        # A retried session can resume a checkpoint already at the
        # target: that is success, not a crash.
        print(f"already at step {step} >= {args.steps}; nothing to do",
              flush=True)
        return 0
    first = last = None
    with device_prefetch(corpus_batches(args, ctx), ctx.device) as batches:
        while step < args.steps:
            tokens = next(batches)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, tokens)
            loss = float(metrics["loss"])  # the step's one intended readback
            dt = time.perf_counter() - t0
            step += 1
            first = loss if first is None else first
            last = loss
            if step % 5 == 0 or step == args.steps:
                print(f"step {step}: loss {loss:.4f} "
                      f"({args.batch * args.seq / dt:.0f} tokens/s)",
                      flush=True)
            # Interval saves, plus the coordinator's flush order (checked
            # first, so an interval save at the order's target consumes
            # it too).
            flushed = mgr.flush_requested(step)
            if flushed or step % args.checkpoint_every == 0:
                mgr.save(step, state)
    mgr.save(step, state, blocking=True)
    if not math.isfinite(last) or not last < first:
        print(f"loss did not descend: {first} -> {last}", file=sys.stderr)
        return 1
    print(f"done: loss {first:.4f} -> {last:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
