"""Groups of ``torch.distributed`` ranks for the port's CPU tests.

``launch(program, tmp_path)`` starts one process per rank of ``program``
(a function below), each in its own session, rendezvous through a
``file://`` store under ``tmp_path`` (no TCP port, so parallel test workers
cannot collide), waits for all of them on one deadline, and in ``finally``
kills and reaps every rank still alive, so a failed or hung test leaves no
process behind. It returns each rank's JSON result; arrays go to
``<tmp_path>/<program>.<rank>.npz``. A failure reports each rank's exit
code and stderr tail.

Run as a script, this file is one rank: ``python torch_ranks.py PROGRAM
RANK WORLD STORE OUTDIR [ARGS...]``. Ranks import torch, numpy and
``tony_tpu_torch`` only, never jax: the JAX reference runs in the test
process.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# One deadline for a whole rank group, and the process-group timeout of
# every group a rank joins: a dead rank fails its peers within a minute.
DEADLINE_S = 120.0
GROUP_TIMEOUT_S = 60.0

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=64, max_seq=32, dtype="float32", remat=False)
# The MoE trunk of the expert-parallel tests: TINY with 4 experts, top-2.
MOE_TINY = dict(TINY, n_experts=4, expert_top_k=2)


def launch(program: str, tmp_path: Path, world: int = 2, *,
           args: tuple = (), env: dict | None = None,
           deadline_s: float = DEADLINE_S) -> list[dict]:
    if deadline_s > DEADLINE_S:
        raise ValueError(f"a rank group's deadline is at most {DEADLINE_S} s")
    tmp_path = Path(tmp_path)
    store = tmp_path / f"{program}.store"
    if store.exists():
        raise ValueError(f"{store} is left from an earlier launch")
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), *filter(None, [base.get("PYTHONPATH")])])
    base["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    try:
        for rank in range(world):
            out = open(tmp_path / f"{program}.{rank}.stdout", "w")
            err = open(tmp_path / f"{program}.{rank}.stderr", "w")
            logs += [out, err]
            procs.append(subprocess.Popen(
                [sys.executable, __file__, program, str(rank), str(world),
                 str(store), str(tmp_path), *map(str, args)],
                env={**base, "RANK": str(rank), "WORLD_SIZE": str(world)},
                stdout=out, stderr=err, start_new_session=True,
            ))
        deadline = time.monotonic() + deadline_s
        timed_out = False
        for proc in procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
        if timed_out or any(p.returncode != 0 for p in procs):
            for f in logs:
                f.flush()
            tails = "\n".join(
                f"--- rank {r} (exit {p.poll()}) stderr tail ---\n"
                + (tmp_path / f"{program}.{r}.stderr").read_text()[-3000:]
                for r, p in enumerate(procs))
            raise AssertionError(
                f"rank group {program!r} "
                f"{'passed its deadline' if timed_out else 'failed'}:\n"
                f"{tails}")
        return [json.loads((tmp_path / f"{program}.{r}.json").read_text())
                for r in range(world)]
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        for f in logs:
            f.close()


# ---------------------------------------------------------------------------
# The rank side
# ---------------------------------------------------------------------------

def _join(rank: int, world: int, store: str) -> None:
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=timedelta(seconds=GROUP_TIMEOUT_S))


def _mesh(**axes):
    from tony_tpu_torch.parallel import MeshSpec, build_mesh

    return build_mesh(MeshSpec(**axes), "cpu", timeout_s=GROUP_TIMEOUT_S)


def _gathered(state, mesh) -> dict:
    """{JAX keystr path: numpy array} of the whole state: every split leaf
    all-gathered from the ranks' pieces."""
    import torch

    from tony_tpu_torch.interop import (train_state_leaves,
                                        train_state_placements)
    from tony_tpu_torch.parallel import all_gather_tp

    placements = train_state_placements(state)
    out = {}
    for path, value in train_state_leaves(state):
        t = torch.as_tensor(value).detach()
        for dim, entry in enumerate(getattr(placements.get(path), "spec",
                                            ())):
            if entry is not None:
                t = all_gather_tp(t, dim, entry, mesh=mesh)
        out[path] = t.numpy().copy()
    return out


def _params(path: str, **overrides):
    from tony_tpu_torch.interop import params_from_npz
    from tony_tpu_torch.models import TransformerConfig

    cfg = TransformerConfig(**{**TINY, **overrides})
    return cfg, params_from_npz(path, cfg, "cpu")


def _gathered_grads(state, mesh) -> dict:
    """{".params" keystr path: the whole gradient} of a stepped state: the
    reduced gradient each rank holds for its piece, all-gathered."""
    import torch

    from tony_tpu_torch.interop import _param_paths
    from tony_tpu_torch.parallel import all_gather_tp

    placements = dict(_param_paths(state.placements))
    out = {}
    for path, p in _param_paths(state.params):
        g = p.grad.detach()
        for dim, entry in enumerate(placements[path].spec):
            if entry is not None:
                g = all_gather_tp(g, dim, entry, mesh=mesh)
        out[".params" + path] = torch.as_tensor(g).numpy().copy()
    return out


def _refusal(fn) -> str:
    try:
        fn()
    except (NotImplementedError, ValueError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return ""


def _moe(cfg):
    """``cfg`` with 4 experts, top-2, and its weights from seed 0 (the same
    on every rank)."""
    import dataclasses

    import torch

    from tony_tpu_torch.models import init_params

    moe = dataclasses.replace(cfg, n_experts=4, expert_top_k=2)
    return moe, init_params(moe, torch.Generator().manual_seed(0), "cpu")


def _moe_step(cfg, mesh, tokens, **trunk) -> None:
    """One step of make_train_step(cfg, mesh, **trunk) on ``tokens`` from
    the weights of seed 0; a non-finite loss raises."""
    import math

    from tony_tpu_torch.models import make_train_step

    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu", **trunk)
    _, metrics = step_fn(init_fn(0), tokens)
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise ValueError(f"non-finite metrics {metrics}")


def _moe_decode(params, cfg, mesh, prompt) -> None:
    """DecodeSession(mesh=) of ``cfg`` generating 2 greedy tokens."""
    from tony_tpu_torch.models import DecodeSession

    DecodeSession(params, cfg, "cpu", mesh=mesh).generate(prompt, 2)


def prog_initialize(rank, world, store, outdir, args):
    """runtime.initialize joins the group (MASTER_* name the job; the
    rendezvous is the file store), build_job_mesh gives dp = world, and
    make_train_step refuses a world above 1 without a mesh."""
    import torch

    import tony_tpu_torch.runtime as rt
    from tony_tpu_torch.models import TransformerConfig, make_train_step
    from tony_tpu_torch.parallel.mesh import mesh_spec

    ctx = rt.initialize(device="cpu", init_method=f"file://{store}",
                        timeout_s=GROUP_TIMEOUT_S)
    x = torch.tensor([ctx.process_id + 1.0])
    torch.distributed.all_reduce(x)
    mesh = rt.build_job_mesh(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    refused = _refusal(lambda: make_train_step(
        TransformerConfig(**TINY), device="cpu"))
    return {"rank": ctx.process_id, "sum": x.item(), "refused": refused,
            "mesh": list(mesh_spec(mesh).shape)}, {}


def prog_collectives(rank, world, store, outdir, args):
    """The five collectives on the inputs of ``args[0]`` (``<name>_<rank>``
    arrays), each over a mesh whose named axis spans the two ranks."""
    import numpy as np
    import torch

    from tony_tpu_torch.parallel import (all_gather_tp, all_to_all_ep,
                                         collectives, pmean_gradients,
                                         reduce_scatter_tp,
                                         ring_halo_exchange)

    _join(rank, world, store)
    with np.load(args[0]) as data:
        inp = {k: torch.from_numpy(data[f"{k}_{rank}"])
               for k in ("pmean_a", "pmean_b", "pmean_c", "gather",
                         "scatter", "a2a", "halo")}
    dp, ep, sp, tp = (_mesh(dp=2), _mesh(ep=2), _mesh(sp=2), _mesh(tp=2))
    out = {}
    # 56-byte buckets: pmean_a (60 bytes) is reduced in place, pmean_b and
    # pmean_c (28 and 48) take a bucket each; 1 MiB: one bucket for all.
    for tag, mesh, bucket in (("dp", dp, 56), ("ep", ep, 2 ** 20)):
        grads = {"a": inp["pmean_a"].clone(),
                 "nested": [inp["pmean_b"].clone(), inp["pmean_c"].clone()]}
        collectives.BUCKET_BYTES = bucket
        same = pmean_gradients(grads, mesh)
        assert same is grads
        out[f"pmean_{tag}_a"] = grads["a"]
        out[f"pmean_{tag}_b"], out[f"pmean_{tag}_c"] = grads["nested"]
    out["gather"] = all_gather_tp(inp["gather"], 1, mesh=tp)
    out["scatter"] = reduce_scatter_tp(inp["scatter"], 1, mesh=tp)
    out["a2a"] = all_to_all_ep(inp["a2a"], 0, 1, mesh=ep)
    out["halo_prev"], out["halo_next"] = ring_halo_exchange(
        inp["halo"], "sp", 2, axis=1, mesh=sp)
    return {"rank": rank}, {k: v.numpy() for k, v in out.items()}


def prog_train_dp(rank, world, store, outdir, args):
    """make_train_step over a dp=2 mesh from the weights of ``args[0]`` on
    the global batches of ``args[1]`` (this rank feeds its half): the
    losses and the gathered final state. Then the refusals (and that a
    dense trunk over sp, and an MoE trunk's step over sp and over pp, are
    taken), and sharded_batches(mesh=) over this rank's shard of the token
    file ``args[2]``."""
    import numpy as np

    from tony_tpu_torch.interop import train_state_placements
    from tony_tpu_torch.io import ShardedRecordReader, sharded_batches
    from tony_tpu_torch.models import forward, make_train_step

    _join(rank, world, store)
    cfg, params = _params(args[0])
    mesh = _mesh(dp=2)
    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu",
                                       learning_rate=float(args[3]))
    state = init_fn(params=params)
    split = {path: list(pl.spec) for path, pl in
             train_state_placements(state).items() if pl.sharded}
    losses = []
    batches = np.load(args[1])
    for tokens in batches:
        half = len(tokens) // world
        state, metrics = step_fn(state, tokens[rank * half:(rank + 1) * half])
        assert set(metrics) == {"loss", "cross_entropy"}
        losses.append(float(metrics["loss"]))
    sp, pp = _mesh(sp=2), _mesh(pp=2)
    moe, _ = _moe(cfg)
    refused = {
        "no_mesh": _refusal(lambda: make_train_step(cfg, device="cpu")),
        "sp_mesh": _refusal(lambda: _moe_step(moe, sp, batches[0])),
        "sp_dense": _refusal(lambda: make_train_step(cfg, sp, device="cpu")),
        "sp_forward": _refusal(lambda: forward(params, batches[0], cfg, sp)),
        "pp_mesh": _refusal(lambda: _moe_step(moe, pp, batches[0])),
        "pieces_forward": _refusal(lambda: forward(state.params, batches[0],
                                                   cfg, mesh)),
    }
    reader_kw = dict(fmt="tokens", dtype=np.uint16, record_len=33,
                     batch_size=2)
    first = next(sharded_batches(
        ShardedRecordReader([args[2]], rank, world, **reader_kw), mesh,
        device="cpu"))
    refused["wrong_shard"] = _refusal(lambda: next(sharded_batches(
        ShardedRecordReader([args[2]], 1 - rank, world, **reader_kw), mesh,
        device="cpu")))
    return ({"losses": losses, "split": split, "refused": refused},
            {"first_batch": first.numpy(), **_gathered(state, mesh)})


def prog_checkpoint(rank, world, store, outdir, args):
    """A dp=2 state from the weights of ``args[0]`` restores the 2-process
    JAX checkpoint under ``args[1]`` (the restored state, gathered, goes to
    the npz under ``restored/``), takes one step on this rank's half of
    the batch ``args[2]``, saves it under ``args[3]`` (the saved state,
    gathered, under ``saved/``), and restores that save into a fresh
    state, which must equal it bit for bit."""
    import numpy as np
    import torch

    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.interop import train_state_to_numpy
    from tony_tpu_torch.models import make_train_step

    _join(rank, world, store)
    cfg, params = _params(args[0])
    mesh = _mesh(dp=2)
    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu",
                                       learning_rate=1e-3)
    state = init_fn(params=params)
    jax_ckpt = CheckpointManager(args[1], process_id=rank, num_processes=2)
    restored_step = jax_ckpt.latest_step()
    assert jax_ckpt.restore(state) is state
    out = {f"restored/{k}": v for k, v in _gathered(state, mesh).items()}
    tokens = np.load(args[2])
    half = len(tokens) // world
    state, _ = step_fn(state, tokens[rank * half:(rank + 1) * half])
    mgr = CheckpointManager(args[3], process_id=rank, num_processes=2)
    mgr.save(int(state.step), state, blocking=True)
    out.update({f"saved/{k}": v for k, v in _gathered(state, mesh).items()})
    torch.distributed.barrier()  # both pieces of the step are written
    fresh = init_fn(0)
    assert mgr.restore(fresh) is fresh
    mine, back = train_state_to_numpy(state), train_state_to_numpy(fresh)
    equal = all(np.array_equal(mine[k], back[k]) for k in mine)
    return {"restored_step": restored_step, "step": int(state.step),
            "round_trip_equal": equal}, out


def prog_moe_ep(rank, world, store, outdir, args):
    """The MoE trunk over an ep=2 mesh (each rank holds 2 of the 4
    experts and feeds its half of the batch). ``args``: the weights npz,
    the global batches npy, the layer input npz, the JAX checkpoint dir,
    the port's checkpoint dir.

    (1) At cf = E (no drops), grad_clip 1e9 (no clip), 3 steps: each
    step's metrics and its reduced gradients, gathered, under
    ``step<i>/``. (2) One step of the same start with remat "dots": its
    gradients under ``dots/``; one over a dp=2 mesh instead (experts whole
    on each rank, split on d over dp): under ``dp2/``. (3) At cf 1.25
    (drops), ``_moe_mlp`` of
    layer 0 on this rank's half of the layer input: out and aux. (4) A
    fresh ep=2 state restores the JAX checkpoint (gathered under
    ``restored/``), takes one step, saves under the port's dir (gathered
    under ``saved/``) and restores that save into a fresh state bit for
    bit. Counts its all_to_all calls."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.interop import (train_state_placements,
                                        train_state_to_numpy)
    from tony_tpu_torch.models import make_train_step
    from tony_tpu_torch.models.transformer import _moe_mlp

    _join(rank, world, store)
    calls = {"all_to_all": 0}
    real = dist.all_to_all_single

    def counted(*a, **kw):
        calls["all_to_all"] += 1
        return real(*a, **kw)

    dist.all_to_all_single = counted
    mesh = _mesh(ep=2)
    batches = np.load(args[1])
    half = batches.shape[1] // world
    mine = batches[:, rank * half:(rank + 1) * half]
    arrays, result = {}, {"metrics": []}

    cfg, params = _params(args[0], n_experts=4, expert_top_k=2,
                          capacity_factor=4.0)
    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu",
                                       learning_rate=1e-3, grad_clip=1e9)
    state = init_fn(params=params)
    result["split"] = {path: list(pl.spec) for path, pl in
                       train_state_placements(state).items()
                       if path.startswith(".params") and pl.sharded}
    for i, tokens in enumerate(mine):
        state, metrics = step_fn(state, tokens)
        result["metrics"].append({k: float(v) for k, v in metrics.items()})
        arrays.update({f"step{i}/{k}": v for k, v in
                       _gathered_grads(state, mesh).items()})
    cfg_dots, _ = _params(args[0], n_experts=4, expert_top_k=2,
                          capacity_factor=4.0, remat=True,
                          remat_policy="dots")
    init_dots, step_dots = make_train_step(cfg_dots, mesh, device="cpu",
                                           learning_rate=1e-3, grad_clip=1e9)
    dots, metrics = step_dots(init_dots(params=params), mine[0])
    result["dots_loss"] = float(metrics["loss"])
    arrays.update({f"dots/{k}": v for k, v in
                   _gathered_grads(dots, mesh).items()})
    dp_mesh = _mesh(dp=2)
    init_dp, step_dp = make_train_step(cfg, dp_mesh, device="cpu",
                                       learning_rate=1e-3, grad_clip=1e9)
    dp_state, metrics = step_dp(init_dp(params=params), mine[0])
    result["dp_loss"] = float(metrics["loss"])
    arrays.update({f"dp2/{k}": v for k, v in
                   _gathered_grads(dp_state, dp_mesh).items()})

    cfg_drop, _ = _params(args[0], n_experts=4, expert_top_k=2,
                          capacity_factor=1.25)
    with np.load(args[2]) as data:
        x = torch.from_numpy(data["x"])
    rows = x.shape[0] // world
    lp = {k: v[0] for k, v in params["layers"].items()}
    for k in ("w_gate", "w_up", "w_down"):
        lp[k] = lp[k][2 * rank:2 * rank + 2]
    with torch.no_grad():
        out, aux = _moe_mlp(x[rank * rows:(rank + 1) * rows], lp, cfg_drop,
                            mesh)
    arrays["layer/out"] = out.numpy()
    result["layer_aux"] = {k: float(v) for k, v in aux.items()}

    init_ck, step_ck = init_fn, step_fn
    state = init_ck(params=params)
    assert CheckpointManager(args[3], process_id=rank,
                             num_processes=2).restore(state) is state
    arrays.update({f"restored/{k}": v for k, v in
                   _gathered(state, mesh).items()})
    state, _ = step_ck(state, mine[0])
    mgr = CheckpointManager(args[4], process_id=rank, num_processes=2)
    mgr.save(int(state.step), state, blocking=True)
    arrays.update({f"saved/{k}": v for k, v in
                   _gathered(state, mesh).items()})
    dist.barrier()
    fresh = init_ck(0)
    assert mgr.restore(fresh) is fresh
    a, b = train_state_to_numpy(state), train_state_to_numpy(fresh)
    result["round_trip_equal"] = all(np.array_equal(a[k], b[k]) for k in a)
    result["step"] = int(state.step)
    result["all_to_all_calls"] = calls["all_to_all"]
    return result, arrays


def prog_moe_dp_ep(rank, world, store, outdir, args):
    """The MoE trunk over a dp=2 x ep=2 mesh of four ranks (each holds 2
    of the 4 experts, their d dimension split over dp, and feeds its
    quarter of the batch). ``args``: the weights npz, the global batches
    npy, grad_clip. At cf = E (no drops): each step's metrics and its
    reduced, clipped gradients, gathered, under ``step<i>/``; the rank
    list and size of the dp x ep group."""
    import numpy as np
    import torch.distributed as dist

    from tony_tpu_torch.interop import train_state_placements
    from tony_tpu_torch.models import make_train_step
    from tony_tpu_torch.parallel.collectives import axis_group

    _join(rank, world, store)
    mesh = _mesh(dp=2, ep=2)
    group, size = axis_group(mesh, ("ep", "dp"))
    result = {"dp_ep_ranks": dist.get_process_group_ranks(group),
              "dp_ep_size": size, "metrics": []}
    batches = np.load(args[1])
    rows = batches.shape[1] // world
    mine = batches[:, rank * rows:(rank + 1) * rows]
    cfg, params = _params(args[0], n_experts=4, expert_top_k=2,
                          capacity_factor=4.0)
    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu",
                                       learning_rate=1e-3,
                                       grad_clip=float(args[2]))
    state = init_fn(params=params)
    result["split"] = {path: list(pl.spec) for path, pl in
                       train_state_placements(state).items()
                       if path.startswith(".params") and pl.sharded}
    arrays = {}
    for i, tokens in enumerate(mine):
        state, metrics = step_fn(state, tokens)
        result["metrics"].append({k: float(v) for k, v in metrics.items()})
        arrays.update({f"step{i}/{k}": v for k, v in
                       _gathered_grads(state, mesh).items()})
    return result, arrays


def _local_grads(state, names) -> dict:
    """This rank's own gradient of each layer leaf of ``names``."""
    return {f"local/{k}": state.params["layers"][k].grad.numpy().copy()
            for k in names}


def prog_train_tp(rank, world, store, outdir, args):
    """The dense trunk over a tp=2 mesh, both ranks fed the same batches.
    ``args``: the weights npz, the global batches npy [3, B, T+1],
    grad_clip, the JAX checkpoint dir, the port's checkpoint dir, the
    decode prompt npy.

    (1) 3 steps at remat none and "full", 1 at "dots", from the same
    weights: each step's metrics and its clipped gradients, gathered,
    under ``<remat>/step<i>/``; this rank's own gradients of the
    replicated norms under ``local/``. (2) A fresh tp=2 state restores the
    JAX checkpoint (gathered under ``restored/``), takes one step, saves
    under the port's dir (gathered under ``saved/``) and restores that
    save into a fresh state bit for bit. (3) DecodeSession(mesh=) over the
    tp=2 mesh and over a dp=2 mesh of the same ranks: greedy tokens, the
    pieces of qkv/gate_up and the cache shape; the session without a mesh;
    a temperature draw from a generator seeded by rank. (4) The
    refusals (K/V heads tp does not divide), and that an MoE trunk trains
    and decodes over tp, sp and pp (its forward over pp)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.interop import (train_state_placements,
                                        train_state_to_numpy)
    from tony_tpu_torch.models import (DecodeSession, TransformerConfig,
                                       forward, init_cache, make_train_step)

    _join(rank, world, store)
    mesh = _mesh(tp=2)
    batches = np.load(args[1])
    clip = float(args[2])
    cfg, params = _params(args[0])
    result, arrays = {"metrics": {}}, {}
    for tag, n_steps, kw in (("none", 3, {}),
                             ("full", 3, dict(remat=True)),
                             ("dots", 1, dict(remat=True,
                                              remat_policy="dots"))):
        init_fn, step_fn = make_train_step(
            dataclasses.replace(cfg, **kw), mesh, device="cpu",
            learning_rate=1e-3, grad_clip=clip)
        state = init_fn(params=params)
        result["metrics"][tag] = []
        for i in range(n_steps):
            state, metrics = step_fn(state, batches[i])
            result["metrics"][tag].append(
                {k: float(v) for k, v in metrics.items()})
            arrays.update({f"{tag}/step{i}/{k}": v for k, v in
                           _gathered_grads(state, mesh).items()})
            if tag == "none" and i == 0:
                arrays.update(_local_grads(state, ("ln1", "ln2")))
                arrays["local/final_norm"] = (
                    state.params["final_norm"].grad.numpy().copy())
    result["split"] = {path: list(pl.spec) for path, pl in
                       train_state_placements(state).items()
                       if path.startswith(".params") and pl.sharded}

    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu",
                                       learning_rate=1e-3, grad_clip=clip)
    state = init_fn(params=params)
    assert CheckpointManager(args[3], process_id=rank,
                             num_processes=2).restore(state) is state
    arrays.update({f"restored/{k}": v for k, v in
                   _gathered(state, mesh).items()})
    state, _ = step_fn(state, batches[2])
    mgr = CheckpointManager(args[4], process_id=rank, num_processes=2)
    mgr.save(int(state.step), state, blocking=True)
    arrays.update({f"saved/{k}": v for k, v in
                   _gathered(state, mesh).items()})
    dist.barrier()
    fresh = init_fn(0)
    assert mgr.restore(fresh) is fresh
    a, b = train_state_to_numpy(state), train_state_to_numpy(fresh)
    result["round_trip_equal"] = all(np.array_equal(a[k], b[k]) for k in a)
    result["step"] = int(state.step)

    prompt = np.load(args[5])
    new = 6
    arrays["decode/plain"] = DecodeSession(params, cfg, device="cpu").generate(
        prompt, new).numpy()
    dp = _mesh(dp=2)
    for tag, m in (("tp", mesh), ("dp", dp)):
        session = DecodeSession(params, cfg, device="cpu", mesh=m)
        arrays[f"decode/{tag}"] = session.generate(prompt, new).numpy()
        for part in ("qkv", "gate_up", "wo", "w_down"):
            arrays[f"decode/{tag}/{part}"] = (
                session.params["layers"][part].numpy().copy())
        arrays[f"decode/{tag}/unembed"] = session.params["unembed"].numpy()
        result[f"cache_{tag}"] = list(init_cache(
            cfg, len(prompt), 12, "cpu", m)["k"].shape)
        session.refresh(params)
        result[f"refresh_{tag}"] = list(session.params["layers"]["qkv"].shape)
    gen = torch.Generator().manual_seed(100 + rank)
    arrays["decode/temperature"] = DecodeSession(
        params, cfg, device="cpu", mesh=mesh).generate(
        prompt, new, temperature=1.0, generator=gen).numpy()

    moe, moe_params = _moe(cfg)
    kv1 = TransformerConfig(**{**TINY, "n_kv_heads": 1})
    sp, pp = _mesh(sp=2), _mesh(pp=2)
    result["refused"] = {
        "moe_train": _refusal(lambda: _moe_step(moe, mesh, batches[0])),
        "moe_decode": _refusal(lambda: _moe_decode(moe_params, moe, mesh,
                                                   prompt)),
        "kv_train": _refusal(lambda: make_train_step(kv1, mesh,
                                                     device="cpu")),
        "kv_decode": _refusal(lambda: DecodeSession(params, kv1, "cpu",
                                                    mesh=mesh)),
        "sp_train": _refusal(lambda: _moe_step(moe, sp, batches[0])),
        "pp_forward": _refusal(lambda: forward(
            moe_params, torch.as_tensor(batches[0]), moe, pp)),
        "sp_decode": _refusal(lambda: _moe_decode(moe_params, moe, sp,
                                                  prompt)),
        "pp_decode": _refusal(lambda: _moe_decode(moe_params, moe, pp,
                                                  prompt)),
    }
    return result, arrays


def prog_tp_dp(rank, world, store, outdir, args):
    """The dense trunk over a dp=2 x tp=2 mesh of four ranks: each dp row
    (two tp ranks) feeds its half of the batch. ``args``: the weights npz,
    the global batches npy, grad_clip, a tokens corpus, a checkpoint dir.
    Each step's metrics and its reduced, clipped gradients, gathered,
    under ``step<i>/``; the placements; the rank lists of the dp and tp
    groups; the first batch ``sharded_batches(mesh=)`` gives this rank
    from its dp row's shard of the corpus; and the state after the last
    step saved to the checkpoint dir (gathered under ``saved/``)."""
    import numpy as np
    import torch.distributed as dist

    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.interop import train_state_placements
    from tony_tpu_torch.io import ShardedRecordReader, sharded_batches
    from tony_tpu_torch.models import make_train_step
    from tony_tpu_torch.parallel.collectives import axis_group
    from tony_tpu_torch.parallel.mesh import axis_coordinate, axis_size

    _join(rank, world, store)
    mesh = _mesh(dp=2, tp=2)
    row, rows = axis_coordinate(mesh, ("dp", "ep")), axis_size(mesh, "dp")
    result = {"metrics": [], "dp_row": row, "groups": {
        a: dist.get_process_group_ranks(axis_group(mesh, a)[0])
        for a in ("dp", "tp")}}
    batches = np.load(args[1])
    per_row = batches.shape[1] // rows
    mine = batches[:, row * per_row:(row + 1) * per_row]
    cfg, params = _params(args[0])
    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu",
                                       learning_rate=1e-3,
                                       grad_clip=float(args[2]))
    state = init_fn(params=params)
    result["split"] = {path: list(pl.spec) for path, pl in
                       train_state_placements(state).items()
                       if path.startswith(".params") and pl.sharded}
    arrays = {}
    for i, tokens in enumerate(mine):
        state, metrics = step_fn(state, tokens)
        result["metrics"].append({k: float(v) for k, v in metrics.items()})
        arrays.update({f"step{i}/{k}": v for k, v in
                       _gathered_grads(state, mesh).items()})
    reader = ShardedRecordReader([args[3]], row, rows, fmt="tokens",
                                 dtype=np.uint16, record_len=33,
                                 batch_size=2)
    arrays["first_batch"] = next(sharded_batches(reader, mesh,
                                                 device="cpu")).numpy()
    CheckpointManager(args[4], process_id=rank, num_processes=world).save(
        int(state.step), state, blocking=True)
    arrays.update({f"saved/{k}": v for k, v in
                   _gathered(state, mesh).items()})
    return result, arrays


def prog_ring(rank, world, store, outdir, args):
    """ring_attention over an sp=2 mesh (real ppermute over gloo) on the
    cases of the npz ``args[0]`` (``<case>/q``, ``k``, ``v``, ``g`` whole
    over the sequence, ``<case>/causal``): this rank's blocks of the output
    and of dq, dk and dv for the cotangent ``g``, under ``<case>/``; the
    send/recv batches each case issued."""
    import numpy as np
    import torch

    from tony_tpu_torch.parallel import ring_attention

    _join(rank, world, store)
    mesh = _mesh(sp=world)
    calls = _count_p2p()
    arrays, batches = {}, {}
    with np.load(args[0]) as data:
        cases = sorted({k.split("/")[0] for k in data.files})
        for case in cases:
            whole = {n: torch.from_numpy(data[f"{case}/{n}"])
                     for n in ("q", "k", "v", "g")}
            t_q = whole["q"].shape[1] // world
            t_k = whole["k"].shape[1] // world
            mine = {n: (x[:, rank * t_q:(rank + 1) * t_q] if n in "qg"
                        else x[:, rank * t_k:(rank + 1) * t_k])
                    .clone().requires_grad_(n != "g")
                    for n, x in whole.items()}
            calls["n"] = 0
            out = ring_attention(mine["q"], mine["k"], mine["v"], mesh,
                                 causal=bool(data[f"{case}/causal"]))
            out.backward(mine["g"])
            batches[case] = calls["n"]
            arrays[f"{case}/out"] = out.detach().numpy()
            for n in "qkv":
                arrays[f"{case}/d{n}"] = mine[n].grad.numpy()
    return {"batches": batches}, arrays


def _count_p2p():
    """Count dist.batch_isend_irecv calls (the ring's rotations, the
    pipeline's sends) into the returned dict: all of them under "n", and
    under "bwd" those autograd's engine makes (the backward), under "fwd"
    the others."""
    import torch
    import torch.distributed as dist

    calls = {"n": 0, "fwd": 0, "bwd": 0}
    real = dist.batch_isend_irecv

    def counted(ops):
        calls["n"] += 1
        node = torch._C._current_autograd_node()
        calls["fwd" if node is None else "bwd"] += 1
        return real(ops)

    dist.batch_isend_irecv = counted
    return calls


def prog_train_sp(rank, world, store, outdir, args):
    """The dense trunk over an sp=2 mesh, both ranks fed the same rows
    (each keeps its block of the shifted sequence). ``args``: the weights
    npz, the global batches npy [3, B, T+1], grad_clip, the JAX checkpoint
    dir, the port's checkpoint dir, the decode prompt npy.

    (1) 3 steps at remat none, "full" and "dots" from the same weights:
    each step's metrics, and the first step's clipped gradients under
    ``<remat>/``; the ring's send/recv batches of the first step. (2) A
    fresh sp=2 state restores the JAX checkpoint (gathered under
    ``restored/``), takes one step, saves under the port's dir (under
    ``saved/``) and restores that save into a fresh state bit for bit.
    (3) DecodeSession(mesh=) over the sp=2 mesh: greedy tokens. (4) The
    refusals: a pipeline whose pp does not divide the layers, an sp that
    does not divide the sequence; and that an MoE trunk trains and decodes
    over sp."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.interop import (train_state_placements,
                                        train_state_to_numpy)
    from tony_tpu_torch.models import DecodeSession, make_train_step

    _join(rank, world, store)
    mesh = _mesh(sp=2)
    calls = _count_p2p()
    batches = np.load(args[1])
    clip = float(args[2])
    cfg, params = _params(args[0])
    result, arrays = {"metrics": {}, "p2p_first_step": {}}, {}
    for tag, kw in (("none", {}), ("full", dict(remat=True)),
                    ("dots", dict(remat=True, remat_policy="dots"))):
        init_fn, step_fn = make_train_step(
            dataclasses.replace(cfg, **kw), mesh, device="cpu",
            learning_rate=1e-3, grad_clip=clip)
        state = init_fn(params=params)
        result["metrics"][tag] = []
        for i, tokens in enumerate(batches):
            calls["n"] = 0
            state, metrics = step_fn(state, tokens)
            result["metrics"][tag].append(
                {k: float(v) for k, v in metrics.items()})
            if i == 0:
                result["p2p_first_step"][tag] = calls["n"]
                arrays.update({f"{tag}/{k}": v for k, v in
                               _gathered_grads(state, mesh).items()})
    result["split"] = {path: list(pl.spec) for path, pl in
                       train_state_placements(state).items() if pl.sharded}

    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu",
                                       learning_rate=1e-3, grad_clip=clip)
    state = init_fn(params=params)
    assert CheckpointManager(args[3], process_id=rank,
                             num_processes=2).restore(state) is state
    arrays.update({f"restored/{k}": v for k, v in
                   _gathered(state, mesh).items()})
    state, _ = step_fn(state, batches[2])
    mgr = CheckpointManager(args[4], process_id=rank, num_processes=2)
    mgr.save(int(state.step), state, blocking=True)
    arrays.update({f"saved/{k}": v for k, v in
                   _gathered(state, mesh).items()})
    dist.barrier()
    fresh = init_fn(0)
    assert mgr.restore(fresh) is fresh
    a, b = train_state_to_numpy(state), train_state_to_numpy(fresh)
    result["round_trip_equal"] = all(np.array_equal(a[k], b[k]) for k in a)
    result["step"] = int(state.step)

    arrays["decode/sp"] = DecodeSession(params, cfg, device="cpu",
                                        mesh=mesh).generate(
        np.load(args[5]), 6).numpy()

    moe, moe_params = _moe(cfg)
    pp = _mesh(pp=2)
    result["refused"] = {
        "moe_train": _refusal(lambda: _moe_step(moe, mesh, batches[0])),
        "moe_decode": _refusal(lambda: _moe_decode(moe_params, moe, mesh,
                                                   np.load(args[5]))),
        "pp_train": _refusal(lambda: make_train_step(
            dataclasses.replace(cfg, n_layers=3), pp, device="cpu",
            pipeline_microbatches=2)),
        "odd_sequence": _refusal(lambda: step_fn(state, batches[0][:, :16])),
    }
    return result, arrays


def _mesh_steps(mesh, args, batches, tag: str, arrays: dict) -> list:
    """The steps of make_train_step(cfg, mesh) on ``batches`` from the
    weights ``args[0]`` with grad_clip ``args[2]``: each step's metrics,
    and its clipped gradients, gathered, under ``<tag>/step<i>/``."""
    from tony_tpu_torch.models import make_train_step

    cfg, params = _params(args[0])
    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu",
                                       learning_rate=1e-3,
                                       grad_clip=float(args[2]))
    state = init_fn(params=params)
    metrics_out = []
    for i, tokens in enumerate(batches):
        state, metrics = step_fn(state, tokens)
        metrics_out.append({k: float(v) for k, v in metrics.items()})
        arrays.update({f"{tag}/step{i}/{k}": v for k, v in
                       _gathered_grads(state, mesh).items()})
    return metrics_out


def prog_sp_mesh(rank, world, store, outdir, args):
    """The dense trunk over sp=2 x tp=2 (every rank fed the whole batch)
    and over dp=2 x sp=2 (each dp row its half) on four ranks. ``args``:
    the weights npz, the global batches npy, grad_clip, the decode prompt
    npy. Each mesh's step metrics and clipped gradients, gathered, under
    ``<mesh>/step<i>/``; the rank lists of the data-axes group of each
    mesh; DecodeSession(mesh=) greedy tokens over sp=2 x tp=2."""
    import numpy as np
    import torch.distributed as dist

    from tony_tpu_torch.models import DecodeSession
    from tony_tpu_torch.parallel.collectives import axis_group
    from tony_tpu_torch.parallel.mesh import (DATA_AXES, axis_coordinate,
                                              axis_size)

    _join(rank, world, store)
    batches = np.load(args[1])
    result, arrays = {"metrics": {}, "data_group": {}}, {}
    for tag, axes in (("sp_tp", dict(sp=2, tp=2)), ("dp_sp", dict(dp=2,
                                                                  sp=2))):
        mesh = _mesh(**axes)
        result["data_group"][tag] = dist.get_process_group_ranks(
            axis_group(mesh, DATA_AXES)[0])
        rows = axis_size(mesh, "dp")
        per_row = batches.shape[1] // rows
        row = axis_coordinate(mesh, "dp") if rows > 1 else 0
        result["metrics"][tag] = _mesh_steps(
            mesh, args, batches[:, row * per_row:(row + 1) * per_row], tag,
            arrays)
        if tag == "sp_tp":
            cfg, params = _params(args[0])
            arrays["decode"] = DecodeSession(params, cfg, device="cpu",
                                             mesh=mesh).generate(
                np.load(args[3]), 6).numpy()
    return result, arrays


# The pipelined trunks of the pp tests: the unpipelined trunk over pp (the
# layer stack gathered, meaning (a)), GPipe and interleaved with 2 virtual
# stages, each over 4 microbatches.
PP_TRUNKS = {"plain": {},
             "gpipe": dict(pipeline_microbatches=4),
             "interleaved": dict(pipeline_microbatches=4,
                                 pipeline_schedule="interleaved",
                                 pipeline_virtual=2)}
# TINY at 4 layers, so that pp 2 x virtual 2 has whole chunks.
PP_TINY = dict(TINY, n_layers=4)
# The four-rank pp runs: run -> (mesh axes, trunk of PP_TRUNKS).
PP_MESH_RUNS = {"pp_tp_gpipe": (dict(pp=2, tp=2), "gpipe"),
                "pp_tp_interleaved": (dict(pp=2, tp=2), "interleaved"),
                "pp_sp": (dict(pp=2, sp=2), "gpipe"),
                "dp_pp": (dict(dp=2, pp=2), "gpipe")}


def _replicated(state, over: str) -> dict:
    """{path: this rank's value} of every params and AdamW leaf of
    ``state`` not split over mesh axis ``over``."""
    import numpy as np
    import torch

    from tony_tpu_torch.interop import (train_state_leaves,
                                        train_state_placements)

    placements = train_state_placements(state)
    out = {}
    for path, value in train_state_leaves(state):
        spec = getattr(placements.get(path), "spec", ())
        if not any(e == over or (isinstance(e, tuple) and over in e)
                   for e in spec):
            out[path] = (value.detach().numpy().copy()
                         if torch.is_tensor(value) else np.asarray(value))
    return out


def _pp_steps(mesh, cfg, params, batches, clip: float, trunk: dict,
              tag: str, arrays: dict, calls=None) -> dict:
    """make_train_step(cfg, mesh, **trunk) from ``params`` over
    ``batches``: each step's metrics, its clipped gradients, gathered,
    under ``<tag>/step<i>/``; with ``calls`` (``_count_p2p``) the
    first step's P2P batches, forward and backward."""
    from tony_tpu_torch.models import make_train_step

    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu",
                                       learning_rate=1e-3, grad_clip=clip,
                                       **trunk)
    state = init_fn(params=params)
    out = {"metrics": []}
    for i, tokens in enumerate(batches):
        if calls is not None:
            calls.update(fwd=0, bwd=0)
        state, metrics = step_fn(state, tokens)
        if calls is not None and i == 0:
            out["p2p_first_step"] = {k: calls[k] for k in ("fwd", "bwd")}
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        arrays.update({f"{tag}/step{i}/{k}": v for k, v in
                       _gathered_grads(state, mesh).items()})
    out["state"] = state
    return out


def prog_train_pp(rank, world, store, outdir, args):
    """The dense trunk (PP_TINY) over a pp=2 mesh, both ranks fed the same
    batches. ``args``: the weights npz, the global batches npy [3, B,
    T+1], grad_clip, the JAX checkpoint dir, the port's checkpoint dir,
    the decode prompt npy.

    (1) 3 steps of each trunk of PP_TRUNKS: each step's metrics and its
    clipped gradients, gathered, under ``<trunk>/step<i>/``; the first
    step's P2P batches, forward and backward, and the chunk exchange's
    all_to_all calls; every leaf not split over pp after the steps under
    ``rep/<trunk>/``. Then one GPipe step at remat "full"
    (``gpipe_remat/``). (2) A fresh state restores the JAX checkpoint
    (gathered under ``restored/``), takes one step of the plain trunk and
    one of GPipe's from it, each saved under ``<port dir>/<trunk>``
    (gathered under ``saved/<trunk>/``) and restored into a fresh state
    bit for bit. (3) DecodeSession(mesh=) over pp=2: greedy tokens. (4)
    The refusals: layers pp x virtual does not divide, a batch the
    microbatches do not divide, interleaved microbatches pp does not
    divide, K/V heads tp does not divide; and that an MoE trunk trains and
    decodes over pp."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.interop import (train_state_placements,
                                        train_state_to_numpy)
    from tony_tpu_torch.models import DecodeSession, make_train_step

    _join(rank, world, store)
    mesh = _mesh(pp=2)
    calls = _count_p2p()
    a2a = {"n": 0}
    real_a2a = dist.all_to_all_single

    def counted_a2a(*a, **kw):
        a2a["n"] += 1
        return real_a2a(*a, **kw)

    dist.all_to_all_single = counted_a2a
    batches = np.load(args[1])
    clip = float(args[2])
    cfg, params = _params(args[0], n_layers=4)
    result, arrays = {"metrics": {}, "p2p_first_step": {},
                      "all_to_all_per_step": {}}, {}
    for tag, trunk in PP_TRUNKS.items():
        a2a["n"] = 0
        run = _pp_steps(mesh, cfg, params, batches, clip, trunk, tag,
                        arrays, calls)
        result["metrics"][tag] = run["metrics"]
        result["p2p_first_step"][tag] = run["p2p_first_step"]
        result["all_to_all_per_step"][tag] = a2a["n"] / len(batches)
        arrays.update({f"rep/{tag}/{k}": v for k, v in
                       _replicated(run["state"], "pp").items()})
    result["split"] = {path: list(pl.spec) for path, pl in
                       train_state_placements(run["state"]).items()
                       if pl.sharded}
    # Under remat the stages recompute their layers in the backward; the
    # sends between them are outside the layers and run once.
    run = _pp_steps(mesh, dataclasses.replace(cfg, remat=True), params,
                    batches[:1], clip, PP_TRUNKS["gpipe"], "gpipe_remat",
                    arrays, calls)
    result["metrics"]["gpipe_remat"] = run["metrics"]
    result["p2p_first_step"]["gpipe_remat"] = run["p2p_first_step"]

    result["round_trip_equal"] = {}
    for tag in ("plain", "gpipe"):
        init_fn, step_fn = make_train_step(cfg, mesh, device="cpu",
                                           learning_rate=1e-3,
                                           grad_clip=clip, **PP_TRUNKS[tag])
        state = init_fn(params=params)
        assert CheckpointManager(args[3], process_id=rank,
                                 num_processes=2).restore(state) is state
        arrays.update({f"restored/{tag}/{k}": v for k, v in
                       _gathered(state, mesh).items()})
        state, _ = step_fn(state, batches[2])
        mgr = CheckpointManager(f"{args[4]}/{tag}", process_id=rank,
                                num_processes=2)
        mgr.save(int(state.step), state, blocking=True)
        arrays.update({f"saved/{tag}/{k}": v for k, v in
                       _gathered(state, mesh).items()})
        dist.barrier()
        fresh = init_fn(0)
        assert mgr.restore(fresh) is fresh
        a, b = train_state_to_numpy(state), train_state_to_numpy(fresh)
        result["round_trip_equal"][tag] = all(np.array_equal(a[k], b[k])
                                              for k in a)

    arrays["decode/pp"] = DecodeSession(params, cfg, device="cpu",
                                        mesh=mesh).generate(
        np.load(args[5]), 6).numpy()

    moe, moe_params = _moe(cfg)
    kv1 = dataclasses.replace(cfg, n_kv_heads=1)
    tp = _mesh(tp=2)
    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu",
                                       **PP_TRUNKS["gpipe"])
    state = init_fn(params=params)
    result["refused"] = {
        "moe_train": _refusal(lambda: _moe_step(moe, mesh, batches[0])),
        "moe_decode": _refusal(lambda: _moe_decode(moe_params, moe, mesh,
                                                   np.load(args[5]))),
        "layers": _refusal(lambda: make_train_step(
            cfg, mesh, device="cpu", pipeline_microbatches=4,
            pipeline_schedule="interleaved", pipeline_virtual=4)),
        "batch": _refusal(lambda: step_fn(state, batches[0][:3])),
        "interleaved_microbatches": _refusal(lambda: make_train_step(
            cfg, mesh, device="cpu", pipeline_microbatches=3,
            pipeline_schedule="interleaved", pipeline_virtual=2)),
        "kv_heads": _refusal(lambda: make_train_step(
            kv1, tp, device="cpu", pipeline_microbatches=2)),
    }
    return result, arrays


def prog_pp_mesh(rank, world, store, outdir, args):
    """The dense trunk (PP_TINY) on four ranks over the meshes of
    PP_MESH_RUNS: pp=2 x tp=2 (GPipe and interleaved; every rank fed the
    whole batch), pp=2 x sp=2 (GPipe; every rank the whole batch, each sp
    rank its block of the sequence) and dp=2 x pp=2 (GPipe; each dp row
    its half). ``args``: the weights
    npz, the global batches npy, grad_clip. Each run's step metrics and
    clipped gradients, gathered, under ``<run>/step<i>/``; every leaf not
    split over pp after the steps under ``rep/<run>/``."""
    import numpy as np

    from tony_tpu_torch.parallel.mesh import axis_coordinate, axis_size

    _join(rank, world, store)
    batches = np.load(args[1])
    clip = float(args[2])
    cfg, params = _params(args[0], n_layers=4)
    result, arrays = {"metrics": {}}, {}
    for tag, (axes, trunk) in PP_MESH_RUNS.items():
        mesh = _mesh(**axes)
        rows = axis_size(mesh, "dp")
        per_row = batches.shape[1] // rows
        row = axis_coordinate(mesh, "dp") if rows > 1 else 0
        run = _pp_steps(mesh, cfg, params,
                        batches[:, row * per_row:(row + 1) * per_row],
                        clip, PP_TRUNKS[trunk], tag, arrays)
        result["metrics"][tag] = run["metrics"]
        arrays.update({f"rep/{tag}/{k}": v for k, v in
                       _replicated(run["state"], "pp").items()})
    return result, arrays


# The MoE trunk of the model-axis tests: the JAX package's MoE test config
# (vocab 128, d 32, 2 layers, E 4, top-2, fp32) with GQA 4/2 heads of 8,
# which tp 2 divides, at capacity factor E (nothing drops).
MOE_MESH = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, head_dim=8, d_ff=64, max_seq=64,
                dtype="float32", remat=False, n_experts=4, expert_top_k=2,
                capacity_factor=4.0)
# The sharded MoE decode test's trunk: the JAX package's sharded MoE decode
# test config (vocab 64, d 32, 2 layers, GQA 4/2 heads of 8, E 4, top-2).
MOE_DECODE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                  n_kv_heads=2, head_dim=8, d_ff=64, max_seq=64,
                  dtype="float32", remat=False, n_experts=4,
                  expert_top_k=2)
# The four-rank MoE train runs of the tp and sp tests: run -> mesh axes.
MOE_TP_RUNS = {"dp_tp": dict(dp=2, tp=2), "ep_tp": dict(ep=2, tp=2)}
MOE_SP_RUNS = {"dp_sp": dict(dp=2, sp=2), "ep_sp": dict(ep=2, sp=2)}
# The pp test's runs over four ranks: run -> (mesh axes, trunk of
# PP_TRUNKS), at 4 layers.
MOE_PP_RUNS = {"pp_ep_plain": (dict(pp=2, ep=2), "plain"),
               "pp_ep_gpipe1": (dict(pp=2, ep=2), "gpipe1"),
               "pp_ep_gpipe": (dict(pp=2, ep=2), "gpipe2"),
               "pp_ep_interleaved": (dict(pp=2, ep=2), "interleaved2"),
               "pp_tp_gpipe": (dict(pp=2, tp=2), "gpipe2")}
MOE_PP_TRUNKS = {"plain": {},
                 "gpipe1": dict(pipeline_microbatches=1),
                 "gpipe2": dict(pipeline_microbatches=2),
                 "interleaved2": dict(pipeline_microbatches=2,
                                      pipeline_schedule="interleaved",
                                      pipeline_virtual=2)}


def _data_rows(mesh, x):
    """This rank's rows of ``x`` [B, ...], a global batch split over
    dp x ep (the pp, sp and tp ranks of a data row take the same rows)."""
    from tony_tpu_torch.parallel.mesh import axis_coordinate, axis_size

    n = axis_size(mesh, ("dp", "ep"))
    per = x.shape[0] // n
    row = axis_coordinate(mesh, ("dp", "ep"))
    return x[row * per:(row + 1) * per]


def _moe_layer_out(mesh, cfg, params, x) -> tuple:
    """``_moe_mlp`` of layer 0 on this rank: its data rows of ``x`` [B, T,
    d] (over sp its block of the T positions), its E/ep experts and their
    F/tp columns. Returns (out, aux) as numpy and floats."""
    import torch

    from tony_tpu_torch.models.transformer import EXPERT_LEAVES, _moe_mlp
    from tony_tpu_torch.parallel.mesh import axis_coordinate, axis_size

    lp = {k: v[0] for k, v in params["layers"].items()}
    ep, tp, sp = (axis_size(mesh, a) for a in ("ep", "tp", "sp"))
    e, f = cfg.n_experts // ep, cfg.d_ff // tp
    i, j = axis_coordinate(mesh, "ep"), axis_coordinate(mesh, "tp")
    for k in EXPERT_LEAVES:
        w = lp[k][i * e:(i + 1) * e]
        lp[k] = (w[:, j * f:(j + 1) * f] if k == "w_down"
                 else w[..., j * f:(j + 1) * f])
    x = _data_rows(mesh, torch.as_tensor(x))
    t = x.shape[1] // sp
    x = x[:, axis_coordinate(mesh, "sp") * t:][:, :t]
    with torch.no_grad():
        out, aux = _moe_mlp(x, lp, cfg, mesh)
    return out.numpy(), {k: float(v) for k, v in aux.items()}


def _moe_steps(mesh, cfg, params, batches, clip, tag, arrays,
               trunk=None) -> list:
    """``_pp_steps`` on this rank's data rows of ``batches`` [steps, B,
    T+1]: each step's metrics, its clipped gradients, gathered, under
    ``<tag>/step<i>/``."""
    import numpy as np

    rows = [np.asarray(_data_rows(mesh, b)) for b in batches]
    return _pp_steps(mesh, cfg, params, rows, clip, trunk or {}, tag,
                     arrays)["metrics"]


def _checkpoint_round(mesh, cfg, params, tokens, clip, jax_dir, port_dir,
                      arrays, rank, world, trunk=None) -> dict:
    """A fresh state on ``mesh`` restores the JAX checkpoint under
    ``jax_dir`` (gathered under ``restored/``), takes one step on this
    rank's rows of ``tokens``, saves under ``port_dir`` (gathered under
    ``saved/``) and restores that save into a fresh state bit for bit."""
    import numpy as np
    import torch.distributed as dist

    from tony_tpu_torch.checkpoint import CheckpointManager
    from tony_tpu_torch.interop import train_state_to_numpy
    from tony_tpu_torch.models import make_train_step

    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu",
                                       learning_rate=1e-3, grad_clip=clip,
                                       **(trunk or {}))
    state = init_fn(params=params)
    assert CheckpointManager(jax_dir, process_id=rank,
                             num_processes=world).restore(state) is state
    arrays.update({f"restored/{k}": v for k, v in
                   _gathered(state, mesh).items()})
    state, _ = step_fn(state, np.asarray(_data_rows(mesh, tokens)))
    mgr = CheckpointManager(port_dir, process_id=rank, num_processes=world)
    mgr.save(int(state.step), state, blocking=True)
    arrays.update({f"saved/{k}": v for k, v in
                   _gathered(state, mesh).items()})
    dist.barrier()
    fresh = init_fn(0)
    assert mgr.restore(fresh) is fresh
    a, b = train_state_to_numpy(state), train_state_to_numpy(fresh)
    return {"round_trip_equal": all(np.array_equal(a[k], b[k]) for k in a),
            "step": int(state.step)}


def prog_moe_tp(rank, world, store, outdir, args):
    """The MoE trunk (MOE_MESH) over tp on four ranks. ``args``: the
    weights npz, the global batches npy [2, B, T+1], grad_clip, the layer
    input npz, the JAX checkpoint dir (its ep=2 x tp=2 state), the port's
    checkpoint dir, the decode weights npz (the decode config), the
    decode prompt npy.

    (1) ``_moe_mlp`` of layer 0 at cf 1.25 (drops) over dp=2 x tp=2 and
    ep=2 x tp=2: this rank's out and aux under ``layer/<run>/``. (2) 2
    steps over each mesh of MOE_TP_RUNS at cf = E, each step's metrics and
    clipped gradients gathered under ``<run>/step<i>/``; one step over
    ep=2 x tp=2 at remat "dots" under ``dots/step0/``. (3) The checkpoint
    round over ep=2 x tp=2 (``_checkpoint_round``). (4) DecodeSession(mesh=)
    over ep=2 x tp=2 of the decode config, dense and routed: greedy tokens
    under ``decode/<mode>``, the pieces of gate_up and w_down; the session
    without a mesh under ``decode/plain``."""
    import dataclasses

    import numpy as np

    from tony_tpu_torch.models import DecodeSession

    _join(rank, world, store)
    cfg, params = _params(args[0], **MOE_MESH)
    batches, clip = np.load(args[1]), float(args[2])
    with np.load(args[3]) as data:
        x = data["x"]
    meshes = {tag: _mesh(**axes) for tag, axes in MOE_TP_RUNS.items()}
    drop = dataclasses.replace(cfg, capacity_factor=1.25)
    result, arrays = {"metrics": {}, "layer_aux": {}}, {}
    for tag, mesh in meshes.items():
        arrays[f"layer/{tag}"], result["layer_aux"][tag] = _moe_layer_out(
            mesh, drop, params, x)
        result["metrics"][tag] = _moe_steps(mesh, cfg, params, batches,
                                            clip, tag, arrays)
    mesh = meshes["ep_tp"]
    result["metrics"]["dots"] = _moe_steps(
        mesh, dataclasses.replace(cfg, remat=True, remat_policy="dots"),
        params, batches[:1], clip, "dots", arrays)
    result["split"] = {
        path: list(pl.spec) for path, pl in _split_paths(
            mesh, cfg, params).items()}
    result.update(_checkpoint_round(mesh, cfg, params, batches[1], clip,
                                    args[4], args[5], arrays, rank, world))

    dcfg, dparams = _params(args[6], **MOE_DECODE)
    prompt = np.load(args[7])
    arrays["decode/plain"] = DecodeSession(dparams, dcfg, "cpu").generate(
        prompt, 5).numpy()
    for mode in ("dense", "routed"):
        mcfg = dataclasses.replace(dcfg, moe_decode_mode=mode)
        session = DecodeSession(dparams, mcfg, "cpu", mesh=mesh)
        arrays[f"decode/{mode}"] = session.generate(prompt, 5).numpy()
    for part in ("gate_up", "w_down"):
        arrays[f"decode/{part}"] = session.params["layers"][part].numpy()
    return result, arrays


def _split_paths(mesh, cfg, params) -> dict:
    """{keystr path: Placement} of the split params leaves on ``mesh``."""
    from tony_tpu_torch.interop import _param_paths
    from tony_tpu_torch.models import param_roles
    from tony_tpu_torch.parallel import shard_pytree

    _, placements = shard_pytree(params, param_roles(cfg), mesh)
    return {path: pl for path, pl in _param_paths(placements)
            if pl.sharded}


def prog_moe_sp(rank, world, store, outdir, args):
    """The MoE trunk (MOE_MESH) over sp on four ranks. ``args``: the
    weights npz, the global batches npy [2, B, T+1], grad_clip, the layer
    input npz. (1) ``_moe_mlp`` of layer 0 at cf 1.25 (drops) over ep=2 x
    sp=2, each rank routing its block of positions: out and aux under
    ``layer/ep_sp``. (2) 2 steps over each mesh of MOE_SP_RUNS at cf = E,
    each step's metrics and clipped gradients gathered under
    ``<run>/step<i>/``; one step over ep=2 x sp=2 at remat "dots" under
    ``dots/step0/``; this rank's own router gradient of the first step
    under ``local/<run>``; the rank lists of each mesh's data-axes
    group."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from tony_tpu_torch.parallel.collectives import axis_group
    from tony_tpu_torch.parallel.mesh import DATA_AXES

    _join(rank, world, store)
    cfg, params = _params(args[0], **MOE_MESH)
    batches, clip = np.load(args[1]), float(args[2])
    with np.load(args[3]) as data:
        x = data["x"]
    result = {"metrics": {}, "data_group": {}, "layer_aux": {}}
    arrays = {}
    for tag, axes in MOE_SP_RUNS.items():
        mesh = _mesh(**axes)
        result["data_group"][tag] = dist.get_process_group_ranks(
            axis_group(mesh, DATA_AXES)[0])
        result["metrics"][tag] = _moe_steps(mesh, cfg, params, batches,
                                            clip, tag, arrays)
    arrays["layer/ep_sp"], result["layer_aux"]["ep_sp"] = _moe_layer_out(
        mesh, dataclasses.replace(cfg, capacity_factor=1.25), params, x)
    result["metrics"]["dots"] = _moe_steps(
        mesh, dataclasses.replace(cfg, remat=True, remat_policy="dots"),
        params, batches[:1], clip, "dots", arrays)
    return result, arrays


def prog_moe_pp(rank, world, store, outdir, args):
    """The MoE trunk (MOE_MESH at 4 layers) over pp on four ranks.
    ``args``: the weights npz, the global batches npy [2, B, T+1],
    grad_clip, the JAX checkpoint dir (its pp=2 x ep=2 state), the port's
    checkpoint dir. (1) 2 steps of each run of MOE_PP_RUNS (the layer
    stack gathered over pp, GPipe over 1 and 2 microbatches and
    interleaved over 2 over pp=2 x ep=2, GPipe over 2 over pp=2 x tp=2)
    at cf = E: each step's metrics and
    clipped gradients gathered under ``<run>/step<i>/``, every leaf not
    split over pp after the steps under ``rep/<run>/``. (2) The checkpoint
    round (``_checkpoint_round``) over pp=2 x ep=2 through GPipe: the
    state's layer stack staged over pp, its experts over ep."""
    import numpy as np

    _join(rank, world, store)
    cfg, params = _params(args[0], **dict(MOE_MESH, n_layers=4))
    batches, clip = np.load(args[1]), float(args[2])
    result, arrays, meshes = {"metrics": {}}, {}, {}
    for tag, (axes, trunk) in MOE_PP_RUNS.items():
        key = tuple(sorted(axes.items()))
        mesh = meshes.setdefault(key, _mesh(**axes))
        rows = [np.asarray(_data_rows(mesh, b)) for b in batches]
        run = _pp_steps(mesh, cfg, params, rows, clip, MOE_PP_TRUNKS[trunk],
                        tag, arrays)
        result["metrics"][tag] = run["metrics"]
        arrays.update({f"rep/{tag}/{k}": v for k, v in
                       _replicated(run["state"], "pp").items()})
    mesh = meshes[(("ep", 2), ("pp", 2))]
    result["split"] = {path: list(pl.spec) for path, pl in _split_paths(
        mesh, cfg, params).items()}
    result.update(_checkpoint_round(mesh, cfg, params, batches[1], clip,
                                    args[3], args[4], arrays, rank, world,
                                    MOE_PP_TRUNKS["gpipe2"]))
    return result, arrays


def prog_classifier_dp(rank, world, store, outdir, args):
    """make_classifier_step (the MNIST CNN, fp32) over a dp mesh of every
    rank from the port's init at seed 0, each rank fed its block of rows
    of every batch in the npz ``args[0]`` (images [steps, B, 28, 28, 1],
    labels [steps, B]): each step's metrics and the final state."""
    import numpy as np

    from tony_tpu_torch.interop import train_state_to_numpy
    from tony_tpu_torch.models import MnistConfig, make_classifier_step

    _join(rank, world, store)
    mesh = _mesh(dp=world)
    init_fn, step_fn = make_classifier_step(
        MnistConfig(arch="cnn", dtype="float32"), mesh, device="cpu")
    state = init_fn(0)
    data = np.load(args[0])
    rows = data["labels"].shape[1] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    metrics = []
    for images, labels in zip(data["images"], data["labels"]):
        state, m = step_fn(state, images[mine], labels[mine])
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics}, train_state_to_numpy(state)


def prog_lm_stepstats(rank, world, store, outdir, args):
    """make_train_step (TINY) over a dp mesh of every rank, each rank fed
    its own [2, 17] tokens for 4 steps: how the step's anatomy sized the
    workload, and the anatomy gauges of this rank's registry."""
    import numpy as np

    from tony_tpu_torch import observability
    from tony_tpu_torch.models import TransformerConfig, make_train_step

    _join(rank, world, store)
    mesh = _mesh(dp=world)
    init_fn, step_fn = make_train_step(TransformerConfig(**TINY), mesh,
                                       device="cpu")
    state = init_fn(0)
    rng = np.random.default_rng(rank)
    for _ in range(4):
        state, metrics = step_fn(state, rng.integers(0, 64, (2, 17)))
        float(metrics["loss"])
    stats = step_fn.stepstats
    snap = observability.default_registry().snapshot()
    return {"global_batch": stats.global_batch, "seq": stats.seq,
            "plan": stats.plan.key(), "steps_observed": stats.steps_observed,
            "gauges": snap["gauges"], "counters": snap["counters"]}, {}


PROGRAMS = {name[len("prog_"):]: fn for name, fn in globals().items()
            if name.startswith("prog_")}


def main(argv: list[str]) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    program, rank, world, store, outdir, *args = argv
    rank, world = int(rank), int(world)
    try:
        result, arrays = PROGRAMS[program](rank, world, store, outdir, args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out = Path(outdir)
    if arrays:
        np.savez(out / f"{program}.{rank}.npz", **arrays)
    (out / f"{program}.{rank}.json").write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
