"""Flagship LM training on the card: the port's counterpart of
``examples/lm_train.py``, as ``serve.py`` is of ``lm_serve.py``.

    python -m tony_tpu_torch.train --device cuda --steps 20 --batch 8 \\
        --seq 128 --d-model 128 --n-layers 2

Submitted through the orchestrator with ``--framework pytorch``::

    python -m tony_tpu.client.cli local \\
        --executes tony_tpu_torch/train.py --framework pytorch \\
        --conf tony.worker.instances=1 \\
        --task_params "--device cpu --steps 10 --d-model 64 --n-layers 2"

The script calls ``runtime.initialize()`` first, trains on lm_train.py's
synthetic motif corpus (sharded by process), prints ``step N: loss X`` and
exits 1 unless the loss is finite and descended. Weights are fresh from
``--seed`` or read with ``--weights-npz`` from a numpy dump of JAX params.
File corpora (``--data``) wait for the port's input slice and checkpoints
(``--ckpt-dir``) for its checkpoint slice; both raise.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np

import tony_tpu_torch.runtime as rt
from tony_tpu_torch.interop import params_from_npz
from tony_tpu_torch.models import TransformerConfig, make_train_step


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
                   help="file corpora wait for the input slice of the port "
                        "(raises); empty: the synthetic motif corpus")
    p.add_argument("--ckpt-dir", default="",
                   help="checkpoints wait for the checkpoint slice of the "
                        "port (raises)")
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


def corpus_batches(args, ctx):
    """Endless [batch, seq+1] host batches from this process's shard of the
    synthetic corpus."""
    corpus = synthetic_tokens(0, n_docs=64, seq=args.seq, vocab=args.vocab)
    shard = corpus[ctx.process_id::max(ctx.num_processes, 1)]
    rng = np.random.default_rng(ctx.process_id)
    while True:
        yield shard[rng.integers(0, len(shard), size=(args.batch,))]


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    ctx = rt.initialize(device=args.device)
    if args.data:
        raise NotImplementedError(
            "--data (sharded file corpora) waits for the input slice of the "
            "port"
        )
    if args.ckpt_dir:
        raise NotImplementedError(
            "--ckpt-dir (CheckpointManager) waits for the checkpoint slice "
            "of the port"
        )
    print(f"[{ctx.job_name}:{ctx.task_index}] process {ctx.process_id}/"
          f"{ctx.num_processes} on {ctx.device}", flush=True)
    cfg = model_config_from_args(args, max_seq=args.seq + 1)
    init_fn, step_fn = make_train_step(cfg, device=ctx.device,
                                       learning_rate=args.lr)
    if args.weights_npz:
        state = init_fn(params=params_from_npz(args.weights_npz, cfg,
                                               ctx.device))
    else:
        state = init_fn(args.seed)
    batches = corpus_batches(args, ctx)
    first = last = None
    for step in range(1, args.steps + 1):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, next(batches))
        loss = float(metrics["loss"])  # the step's one intended readback
        dt = time.perf_counter() - t0
        first = loss if first is None else first
        last = loss
        if step % 5 == 0 or step == args.steps:
            print(f"step {step}: loss {loss:.4f} "
                  f"({args.batch * args.seq / dt:.0f} tokens/s)", flush=True)
    if last is None or not math.isfinite(last) or not last < first:
        print(f"loss did not descend: {first} -> {last}", file=sys.stderr)
        return 1
    print(f"done: loss {first:.4f} -> {last:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
