"""Long-lived LM serving on the card: the port's counterpart of
``examples/lm_serve.py``.

    python -m tony_tpu_torch.serve --device cuda --d-model 1024 \\
        --n-layers 8 --n-heads 16 --n-kv-heads 4 --vocab 32000 \\
        --dtype bfloat16 --max-seq 2048 --slots 16

Weights are fresh from ``--seed``, or read with ``--weights-npz`` from a
numpy dump of JAX params (keys ``embed``, ``layers/wq``, ...; see
``interop.params_from_npz``). They are fused once through ``DecodeSession``
and served over HTTP through the continuous-batching ``ServingEngine``:
``POST /generate``, ``GET /healthz``, ``POST /shutdown``. Engine knobs
default from the ``TONY_SERVING_*`` env the executor exports from
``tony.serving.*`` conf, and the port from ``TB_PORT`` when a chief serving
task reserved one. Checkpoint restore (``--ckpt``, ``--models``) waits for
the checkpoint slice of the port.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from tony_tpu_torch import constants
from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.interop import params_from_npz
from tony_tpu_torch.models import DecodeSession, TransformerConfig, init_params
from tony_tpu_torch.serving import ServingEngine
from tony_tpu_torch.serving.http import ServingServer


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def parse_args(argv):
    p = argparse.ArgumentParser(description="tony_tpu_torch LM serving")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    p.add_argument("--ckpt", default="",
                   help="checkpoint restore waits for the checkpoint slice "
                        "of the port (raises)")
    p.add_argument("--weights-npz", default="",
                   help="numpy dump of JAX params (empty: fresh weights "
                        "from --seed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-seq", type=int, default=512)
    p.add_argument("--slots", type=int,
                   default=_env_int(constants.TONY_SERVING_SLOTS, 8))
    p.add_argument("--prefill-chunk", type=int,
                   default=_env_int(constants.TONY_SERVING_PREFILL_CHUNK, 32))
    p.add_argument("--decode-window", type=int,
                   default=_env_int(constants.TONY_SERVING_DECODE_WINDOW, 1))
    p.add_argument("--max-queue", type=int,
                   default=_env_int(constants.TONY_SERVING_MAX_QUEUE, 1024))
    p.add_argument("--port", type=int, default=-1,
                   help="HTTP port; -1 = $TB_PORT else $TONY_SERVING_PORT "
                        "else ephemeral")
    p.add_argument("--addr-file", default="",
                   help="write host:port here once listening (empty: "
                        "$TONY_LOG_DIR/serving-<job>-<idx>.addr when "
                        "tony-launched)")
    p.add_argument("--max-requests", type=int, default=0,
                   help="exit 0 after this many retired requests "
                        "(0 = serve until /shutdown)")
    p.add_argument("--models", action="append", default=[],
                   help="extra resident checkpoint as name=ckpt_dir "
                        "(waits for the checkpoint slice; raises)")
    p.add_argument("--max-resident-models", type=int, default=4)
    p.add_argument("--role", choices=("both", "prefill", "decode"),
                   default="both",
                   help="disaggregated fleet role advertised on /healthz")
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


def _resolve_port(args) -> int:
    if args.port >= 0:
        return args.port
    tb = os.environ.get(constants.TB_PORT)
    if tb:
        return int(tb)
    return _env_int(constants.TONY_SERVING_PORT, 0)


def _addr_file(args) -> str:
    if args.addr_file:
        return args.addr_file
    log_dir = os.environ.get(constants.TONY_LOG_DIR)
    if not log_dir:
        return ""
    job = os.environ.get(constants.JOB_NAME, "serving")
    idx = os.environ.get(constants.TASK_INDEX, "0")
    return os.path.join(log_dir, f"serving-{job}-{idx}.addr")


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    if args.ckpt or args.models:
        raise NotImplementedError(
            "checkpoint restore (--ckpt, --models) waits for the checkpoint "
            "slice of the port"
        )
    cfg = model_config_from_args(args, max_seq=args.max_seq)
    if args.weights_npz:
        params = params_from_npz(args.weights_npz, cfg, device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = init_params(cfg, gen, device)
    session = DecodeSession(params, cfg, device=device)
    engine = ServingEngine(
        session.params, cfg, device=device, slots=args.slots,
        prefill_chunk=args.prefill_chunk,
        decode_window=args.decode_window, max_queue=args.max_queue,
        seed=args.seed, max_resident_models=args.max_resident_models,
    )
    engine.start()
    server = ServingServer(engine, port=_resolve_port(args),
                           extra_health={"role": args.role})
    port = server.start()
    addr_file = _addr_file(args)
    if addr_file:
        # Atomic publish: a poller must never read a torn half-line.
        tmp = f"{addr_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(f"127.0.0.1:{port}\n")
        os.replace(tmp, addr_file)
    print(f"serving on :{port} (device={device}, slots={args.slots}, "
          f"chunk={args.prefill_chunk})", flush=True)
    try:
        while not server.wait_shutdown(timeout=0.2):
            if (args.max_requests
                    and engine.stats()["retired"] >= args.max_requests):
                break
    finally:
        # Graceful: stop admitting, let in-flight streams retire, then
        # tear down.
        engine.drain(timeout=60.0)
        server.stop()
        engine.close()
    print(f"serving done: {engine.stats()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
