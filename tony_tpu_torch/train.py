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
with no spec first, as lm_train.py does: with more than one process it
trains over the job's mesh as ``MeshSpec.auto`` factors the world (two
processes tp 2, four tp 2 x sp 2), each process checkpointing its own
pieces; alone it runs the single-device step. A model the mesh does not
split (tp must divide the heads, K/V heads, d_ff and vocab) is refused.
The corpus is read one shard a data row (the rank's dp x ep coordinate of
dp x ep rows, ``parallel.mesh.data_row``): every tp, sp and pp rank of a
row reads the same rows, and ``--batch`` is per data row. It trains on
``--data`` (comma-separated paths: ``*.jblk`` block-compressed jsonl
containers with a ``tokens`` field per record, anything else fixed-width
uint16 token records of length seq+1), read through
``runtime.sharded_reader`` (each data row reads its own byte range; the
reader reopens every epoch) and carried onto the device by
``io.device_prefetch``; without ``--data``, lm_train.py's synthetic motif
corpus, sharded and seeded by data row. Weights are fresh from ``--seed``
or read with ``--weights-npz`` from a numpy dump of JAX params.

Each step is reported through ``observability.report`` (step, loss,
tokens/s) and the step's anatomy (``make_train_step``'s ``stepstats``, fed
the batch iterator's waits) publishes its phases, ``step_time_ms`` and
``tony_mfu``: under the orchestrator the snapshot reaches the
coordinator's ``/metrics`` on the executor's heartbeat.

``--data`` paths and the checkpoint dir may be ``gs://`` URIs, read and
written through ``cloud.default_storage()`` (``TONY_GCS_EMULATOR_DIR`` maps
them onto a local directory offline). A ``TONY_FAULT_PLAN`` from the
orchestrator is obeyed as lm_train.py obeys it: ``throttle_io`` in the
loop's ``next()`` after each batch (``throttled``), ``degrade_task`` after
each step's loss readback, and the checkpoint faults in the manager's
persist stage.

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
from tony_tpu_torch import constants, observability
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.interop import params_from_npz
from tony_tpu_torch.io import device_prefetch
from tony_tpu_torch.models import TransformerConfig, make_train_step
from tony_tpu_torch.parallel.mesh import data_row, mesh_spec
from tony_tpu_torch.resilience.faults import (io_faults_from_env,
                                              step_faults_from_env)


def parse_args(argv):
    p = argparse.ArgumentParser(description="tony_tpu_torch LM training")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8,
                   help="rows a step per data row of the job mesh")
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--weights-npz", default="",
                   help="numpy dump of JAX params (empty: fresh weights "
                        "from --seed)")
    p.add_argument("--data", default="",
                   help="corpus path(s) or gs:// URI(s), comma-sep: "
                        "*.jblk = block-compressed jsonl containers with "
                        "a 'tokens' field per record; anything else = "
                        "fixed-width uint16 token records of length "
                        "seq+1. Empty: the synthetic motif corpus.")
    p.add_argument("--checkpoint-every", type=int, default=10)
    p.add_argument("--dist-timeout", type=float, default=300.0,
                   help="seconds a collective waits for a peer before "
                        "failing (process group timeout)")
    p.add_argument("--ckpt-dir", default="",
                   help="checkpoint dir or gs:// prefix (default: "
                        "$TONY_CHECKPOINT_DIR, else "
                        "$TONY_LOG_DIR/lm-checkpoints)")
    add_model_args(p)
    return p.parse_args(argv)


def add_model_args(p: argparse.ArgumentParser) -> None:
    """Model flags with lm_train.py's names and defaults, shared by the
    train, serve and generate CLIs, so a checkpoint trained with defaults
    restores with defaults."""
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--n-kv-heads", type=int, default=2)
    p.add_argument("--n-experts", type=int, default=0)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--dtype", default="float32",
                   help="float32 or bfloat16")


def model_config_from_args(args, *, max_seq: int) -> TransformerConfig:
    """The arg -> config derivation of examples/lm_train.py, shared by the
    train, serve and generate CLIs."""
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


def _unthrottled(reader):
    """The reader's batches through ``next_batch()``, not its iterator: the
    train loop applies the plan's ``throttle_io`` itself (``throttled``)."""
    while (batch := reader.next_batch()) is not None:
        yield batch


def _file_batches(args, row: int, rows: int):
    """Endless [batch, seq+1] int32 host batches of data row ``row``'s
    shard (of ``rows``) of ``--data``, one reader per epoch (the splits
    re-shard identically), with examples/lm_train.py's validation."""
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
                paths, task_index=row, num_tasks=rows, fmt="jsonl-blocks",
                batch_size=args.batch,
            ) as r:
                for recs in _unthrottled(r):
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
                paths, task_index=row, num_tasks=rows, fmt="tokens",
                dtype=np.uint16, record_len=args.seq + 1,
                batch_size=args.batch,
            ) as r:
                for b in _unthrottled(r):
                    if b.shape[0] == args.batch:
                        yielded += 1
                        yield b.astype(np.int32)
        if not yielded:
            # This data row's byte-range shard holds less than one full
            # batch: re-opening forever would hang training silently.
            raise RuntimeError(
                f"--data {args.data}: data row {row}'s shard yielded no "
                f"full batch of {args.batch} (corpus too small for "
                f"{rows} data rows / this batch size)"
            )


def corpus_batches(args, row: int, rows: int):
    """Endless [batch, seq+1] int32 host batches of data row ``row`` (of
    ``rows``): from ``--data`` through the sharded reader, else from the
    row's shard of the synthetic corpus, seeded by the row."""
    if args.data:
        yield from _file_batches(args, row, rows)
        return
    corpus = synthetic_tokens(0, n_docs=64, seq=args.seq, vocab=args.vocab)
    shard = corpus[row::rows]
    rng = np.random.default_rng(row)
    while True:
        yield shard[rng.integers(0, len(shard), size=(args.batch,))]


def throttled(batches, faults):
    """``batches`` with the fault plan's ``throttle_io`` applied after each
    batch, in the consumer's own ``next()``: the train loop's counterpart of
    the reader's iterator seam and of lm_train.py's synthetic corpus. The
    loop reads its batches through a device prefetcher, so a sleep on the
    prefetcher's thread would hide behind the running step; here it lands
    where lm_train.py's does, and the step anatomy reads it as
    data_wait."""
    for batch in batches:
        if faults is not None:
            faults.maybe_throttle()
        yield batch


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
    # The job mesh as the JAX example takes it: no spec, so the world is
    # factored tp first (tp 2 from two processes), and every rank of a data
    # row reads that row's shard.
    mesh = rt.build_job_mesh(device=ctx.device, timeout_s=args.dist_timeout)
    cfg = model_config_from_args(args, max_seq=args.seq + 1)
    init_fn, step_fn = make_train_step(cfg, mesh, device=ctx.device,
                                       learning_rate=args.lr)
    row, rows = ((0, 1) if mesh is None else
                 data_row(mesh_spec(mesh), torch.distributed.get_rank()))
    print(f"[{ctx.job_name}:{ctx.task_index}] process {ctx.process_id}/"
          f"{ctx.num_processes} on {ctx.device}, mesh "
          f"{mesh_spec(mesh) if mesh is not None else None}, data row "
          f"{row} of {rows}", flush=True)
    if args.weights_npz:
        state = init_fn(params=params_from_npz(args.weights_npz, cfg,
                                               ctx.device))
    else:
        state = init_fn(args.seed)
    mgr = CheckpointManager(checkpoint_dir(args), process_id=ctx.process_id,
                            num_processes=ctx.num_processes)
    try:
        return _resume_and_train(args, ctx, mgr, state, step_fn, row, rows)
    finally:
        # A caller that runs main() inside its own process (a test, a
        # smoke run) is left no save threads or pinned buffer sets.
        mgr.close()


def _resume_and_train(args, ctx, mgr, state, step_fn, row: int,
                      rows: int) -> int:
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
    # `degrade_task` makes this process a deterministic straggler
    # (incarnation 0 only: a replacement after a healing eviction runs
    # clean).
    step_faults = step_faults_from_env()
    # The step's anatomy recorder wraps the batch iterator, so host time
    # blocked on input reads as the data_wait phase.
    stats = step_fn.stepstats
    with device_prefetch(corpus_batches(args, row, rows),
                         ctx.device) as prefetched:
        batches = stats.wrap_batches(throttled(prefetched,
                                               io_faults_from_env()))
        while step < args.steps:
            tokens = next(batches)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, tokens)
            loss = float(metrics["loss"])  # the step's one intended readback
            step += 1
            if step_faults is not None:
                step_faults.maybe_degrade(step)
            dt = time.perf_counter() - t0
            first = loss if first is None else first
            last = loss
            # report() publishes the snapshot to TONY_METRICS_FILE (when
            # tony launched us), which the executor piggybacks on its
            # heartbeat.
            report = {"step": step, "loss": loss,
                      "tokens_per_sec": args.batch * args.seq / dt}
            if not stats.enabled or not stats.steps_observed:
                # Once the anatomy has observed a step it owns
                # step_time_ms (the dispatch-to-dispatch wall its phases
                # sum to); until then this fenced wall feeds the gauge.
                report["step_time_ms"] = dt * 1000.0
            observability.report(**report)
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
