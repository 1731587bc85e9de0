"""The port's checkpoint slice held against the JAX package on the CPU.

Cross-restore both ways: the JAX ``CheckpointManager`` writes a JAX
``TrainState`` and the port's manager restores it into the port's
``TrainState`` (params, AdamW moments, count and step exactly equal; one more
step on each side agrees within slice 2's tolerance), and the other way
round; bf16 leaves both ways; the same tree gives the same manifest and
blobs from both managers. Then the JAX manager's scenarios replayed on the
port's (torn and corrupt steps, differential chains, GC, multi-process
completeness, cross-topology restore, the flush signal, ``TONY_RESUME_STEP``),
the in-place snapshot, and the port's refusals. Last, data-parallel states in
two gloo ranks (``torch_ranks.launch``): they restore a checkpoint two JAX
managers wrote, and their own save carries the shard coordinates JAX writes
for a dp=2 mesh and restores bit for bit in the JAX manager."""

from __future__ import annotations

import ast
import io
import json
import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.checkpoint import CheckpointManager as JaxManager
from tony_tpu.checkpoint import _FsCheckpointStore as JaxStore
from tony_tpu.checkpoint import _MANIFEST as JAX_MANIFEST
from tony_tpu.checkpoint import _encode as jax_encode
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.checkpoint.manager import _normalize_index
from tony_tpu.models import param_roles as jax_param_roles
from tony_tpu.models.train import _sharding_for_tree
from tony_tpu.models.train import make_train_step as jax_make_train_step
from tony_tpu.parallel.mesh import MeshSpec, build_mesh
from tony_tpu_torch import constants
from tony_tpu_torch.checkpoint import CheckpointManager, FlushSignal
from tony_tpu_torch.checkpoint import stores as port_stores
from tony_tpu_torch.interop import (
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from tony_tpu_torch.models import TransformerConfig, make_train_step
from torch_ranks import launch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=64, max_seq=32, dtype="float32", remat=False)
LR = 1e-3


@pytest.fixture(scope="module")
def mesh():
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    with jax.sharding.set_mesh(mesh):
        yield mesh


def _tokens(seed, b=2, t=17):
    return np.random.default_rng(seed).integers(0, 64, (b, t)).astype(
        np.int32)


def _jax_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.fixture(scope="module")
def trained(mesh):
    """A JAX TrainState and a port TrainState from the same weights, each
    after 2 steps on the same batches."""
    jcfg, tcfg = JaxConfig(**TINY), TransformerConfig(**TINY)
    j_init, j_step = jax_make_train_step(jcfg, mesh, learning_rate=LR)
    jstate = j_init(jax.random.key(0))
    t_init, t_step = make_train_step(tcfg, device="cpu", learning_rate=LR)
    tstate = t_init(params=params_from_numpy(jax.device_get(jstate.params),
                                             tcfg, "cpu"))
    for i in range(2):
        jstate, _ = j_step(jstate, _tokens(i))
        tstate, _ = t_step(tstate, _tokens(i))
    return j_init, j_step, t_init, t_step, _jax_flat(jstate), tstate


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


class TestCrossRestore:
    def test_port_restores_a_jax_train_state_exactly(self, trained, mesh,
                                                     tmp_path):
        j_init, j_step, t_init, t_step, _, _ = trained
        jstate = j_init(jax.random.key(0))
        for i in range(2):
            jstate, _ = j_step(jstate, _tokens(i))
        JaxManager(tmp_path).save(2, jstate, blocking=True)
        want = _jax_flat(jstate)
        template = t_init(5)
        state = CheckpointManager(tmp_path).restore(template)
        assert state is template  # restored in place
        _assert_same(train_state_to_numpy(state), want)
        # The optimizer still drives the state's own tensors.
        assert state.opt_state.param_groups[0]["params"][0] is \
            state.params["embed"]
        # One more step on each side: slice 2's tolerance (fp32
        # reordering, Adam moves each weight by ~lr).
        jstate, jm = j_step(jstate, _tokens(2))
        state, tm = t_step(state, _tokens(2))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5)
        after_j, after_t = _jax_flat(jstate), train_state_to_numpy(state)
        for path in after_j:
            np.testing.assert_allclose(after_t[path], after_j[path],
                                       atol=1e-5, err_msg=path)

    def test_jax_restores_a_port_train_state_exactly(self, trained, mesh,
                                                     tmp_path):
        j_init, _, _, _, _, tstate = trained
        CheckpointManager(tmp_path).save(2, tstate, blocking=True)
        restored = JaxManager(tmp_path).restore(j_init(jax.random.key(1)))
        _assert_same(_jax_flat(restored), train_state_to_numpy(tstate))

    def test_port_and_jax_trajectories_agree_after_two_steps(self, trained):
        # The two states the cross-restore tests start from: the same
        # paths, and values within slice 2's tolerance.
        _, _, _, _, jflat, tstate = trained
        tflat = train_state_to_numpy(tstate)
        assert set(tflat) == set(jflat)
        for path in jflat:
            np.testing.assert_allclose(tflat[path], jflat[path], atol=1e-5,
                                       err_msg=path)

    def test_train_state_from_numpy_round_trips(self, trained):
        _, _, t_init, _, jflat, _ = trained
        state = train_state_from_numpy(jflat, t_init(9))
        _assert_same(train_state_to_numpy(state), jflat)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_bf16_leaves_round_trip_exactly(self, writer, tmp_path):
        vals = np.asarray([1.5, -2.25, 3.0, 1e-3, -7e4], np.float32)
        if writer == "jax":
            JaxManager(tmp_path).save(1, {
                "w": jnp.asarray(vals, jnp.bfloat16),
                "step": jnp.asarray(4, jnp.int32)}, blocking=True)
            out = CheckpointManager(tmp_path).restore({
                "w": torch.zeros(5, dtype=torch.bfloat16),
                "step": torch.zeros((), dtype=torch.int32)})
            assert out["w"].dtype == torch.bfloat16
            got = out["w"].float().numpy()
            assert int(out["step"]) == 4
        else:
            CheckpointManager(tmp_path).save(1, {
                "w": torch.from_numpy(vals).to(torch.bfloat16),
                "step": torch.tensor(4, dtype=torch.int32)}, blocking=True)
            out = JaxManager(tmp_path).restore({
                "w": jnp.zeros(5, jnp.bfloat16),
                "step": jnp.zeros((), jnp.int32)})
            assert out["w"].dtype == jnp.bfloat16
            got = np.asarray(out["w"], np.float32)
            assert int(out["step"]) == 4
        want = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, want)

    def test_same_tree_gives_the_same_manifest_and_blobs(self, tmp_path):
        rng = np.random.default_rng(3)
        tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
                "n": {"k": np.arange(5, dtype=np.int32)},
                "s": np.asarray(7, np.int32)}
        JaxManager(tmp_path / "j").save(1, tree, blocking=True)
        CheckpointManager(tmp_path / "t").save(1, tree, blocking=True)
        files = []
        for d in ("j", "t"):
            with np.load(tmp_path / d / "step_1" / "process_0.npz") as npz:
                files.append({k: npz[k].tobytes() for k in npz.files})
            meta = json.loads((tmp_path / d / "step_1" /
                               "metadata.json").read_text())
            assert meta == {"step": 1, "num_processes": 1, "format": 2}
        assert files[0] == files[1]
        side = [json.loads((tmp_path / d / "step_1" /
                            "process_0.json").read_text()) for d in "jt"]
        assert {k: v for k, v in side[0].items() if k != "sha256"} == \
            {k: v for k, v in side[1].items() if k != "sha256"}


def _state(val: float) -> dict:
    return {"step": torch.tensor(int(val), dtype=torch.int32),
            "params": {"w": torch.full((8, 4), val),
                       "b": torch.full((4,), val / 2.0)}}


def _diff_state(val: float, static: float = 1.0) -> dict:
    return {"hot": torch.full((16, 4), float(val)),
            "frozen": torch.full((512, 8), float(static)),
            "step": torch.tensor(int(val), dtype=torch.int32)}


def _step_of(out) -> int:
    return int(out["step"])


def _torn_step(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state(1.0), blocking=True)
    mgr.save(2, _state(2.0), blocking=True)
    (tmp_path / "step_9").mkdir()
    (tmp_path / "step_9" / ".tmp_process_0.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 2
    assert _step_of(mgr.restore(_state(0.0))) == 2
    assert mgr.restore(_state(0.0), step=9) is None


def _corrupt_checksum(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path)
    for s in (1, 2):
        mgr.save(s, _state(float(s)), blocking=True)
    shard = tmp_path / "step_2" / "process_0.npz"
    raw = bytearray(shard.read_bytes())
    raw[-1] ^= 0xFF
    shard.write_bytes(bytes(raw))
    assert mgr.latest_step() == 2  # the listing cannot see bit rot
    assert mgr.restore(_state(0.0), step=2) is None
    assert _step_of(mgr.restore(_state(0.0))) == 1


def _broken_chain(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, max_to_keep=10, full_every=3)
    for s in (1, 2, 3, 4):  # 1 full, 2-3 diff (base 1), 4 full
        mgr.save(s, _diff_state(s), blocking=True)
    (tmp_path / "step_1" / "process_0.npz").unlink()
    assert mgr._complete_steps() == [4]
    assert mgr.restore(_diff_state(0), step=3) is None
    assert _step_of(mgr.restore(_diff_state(0))) == 4


def _differential_skip(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, full_every=100)
    for s in (1, 2, 3):
        mgr.save(s, _diff_state(s), blocking=True)
    sc1 = json.loads((tmp_path / "step_1/process_0.json").read_text())
    sc3 = json.loads((tmp_path / "step_3/process_0.json").read_text())
    assert sc1["kind"] == "full" and sc1["base_steps"] == []
    assert sc3["kind"] == "diff" and sc3["base_steps"] == [1]
    full = (tmp_path / "step_1/process_0.npz").stat().st_size
    diff = (tmp_path / "step_3/process_0.npz").stat().st_size
    assert diff < full * 0.5, (full, diff)
    out = CheckpointManager(tmp_path).restore(_diff_state(0))
    assert _step_of(out) == 3 and float(out["hot"][0, 0]) == 3.0
    assert float(out["frozen"][0, 0]) == 1.0  # read from step 1
    # The JAX manager follows the same reference.
    jout = JaxManager(tmp_path).restore({
        "hot": jnp.zeros((16, 4)), "frozen": jnp.zeros((512, 8)),
        "step": jnp.zeros((), jnp.int32)})
    assert int(jout["step"]) == 3 and float(jout["frozen"][0, 0]) == 1.0


def _full_every_compaction(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, max_to_keep=2, full_every=3)
    for s in range(1, 8):
        mgr.save(s, _diff_state(s), blocking=True)
    kinds = {s: json.loads((tmp_path / f"step_{s}/process_0.json")
                           .read_text()) for s in (4, 6, 7)}
    assert kinds[4]["kind"] == "full"
    assert kinds[6]["kind"] == "diff" and kinds[6]["base_steps"] == [4]
    assert kinds[7]["kind"] == "full"
    present = {int(p.name.split("_")[1]) for p in tmp_path.iterdir()}
    assert present == {4, 6, 7}  # kept {6, 7} and the donor 4
    out = mgr.restore(_diff_state(0), step=6)
    assert _step_of(out) == 6 and float(out["frozen"][0, 0]) == 1.0


def _gc_keeps_newest(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, max_to_keep=2, torn_gc_grace_s=0.0)
    (tmp_path / "step_0").mkdir()
    (tmp_path / "step_0" / ".tmp_process_0.npz").write_bytes(b"torn")
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(float(s)), blocking=True)
    assert mgr._complete_steps() == [3, 4]
    assert not (tmp_path / "step_0").exists()


def _multiprocess_incomplete(tmp_path, monkeypatch):
    p0 = CheckpointManager(tmp_path, process_id=0, num_processes=2)
    p1 = CheckpointManager(tmp_path, process_id=1, num_processes=2)
    p0.save(1, _state(1.0), blocking=True)
    assert p0.latest_step() is None  # process 1 has not written
    p1.save(1, _state(1.5), blocking=True)
    assert p0.latest_step() == 1
    assert float(p1.restore(_state(0.0))["params"]["w"][0, 0]) == 1.5


def _cross_topology(tmp_path, monkeypatch):
    # A 2-process checkpoint in the JAX manager's format, each process
    # holding a slab of w and a replicated b, restored by one process.
    w = np.arange(16.0, dtype=np.float32).reshape(8, 2)
    b = np.asarray([9.0, -3.0], np.float32)
    store = JaxStore(tmp_path)
    for pid, (lo, hi) in enumerate(((0, 4), (4, 8))):
        leaves = {"['w']": (w[lo:hi], [[lo, hi], [0, 2]], (8, 2)),
                  "['b']": (b, [[0, 2]], (2,))}
        manifest, blobs = {}, {}
        for key, (piece, index, gshape) in leaves.items():
            manifest[key] = {"dtype": str(piece.dtype), "shape": list(gshape),
                             "num_shards": 1,
                             "shard_shapes": [list(piece.shape)],
                             "shard_indices": [index]}
            blobs[f"{key}#s0"] = jax_encode(piece)
        buf = io.BytesIO()
        np.savez(buf, **blobs, **{JAX_MANIFEST: np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8)})
        store.put_file(4, f"process_{pid}.npz", buf.getvalue())
    store.put_file(4, "metadata.json",
                   json.dumps({"step": 4, "num_processes": 2}).encode())
    out = CheckpointManager(tmp_path).restore(
        {"w": torch.zeros(8, 2), "b": torch.zeros(2)})
    np.testing.assert_array_equal(out["w"].numpy(), w)
    np.testing.assert_array_equal(out["b"].numpy(), b)
    with pytest.raises(ValueError, match="does not match the template"):
        CheckpointManager(tmp_path).restore({"w": torch.zeros(4, 2),
                                             "b": torch.zeros(2)})


def _flush_signal(tmp_path, monkeypatch):
    f = tmp_path / "flush.json"
    monkeypatch.setenv(constants.TONY_CKPT_FLUSH_FILE, str(f))
    sig = FlushSignal()
    assert sig.active and not sig.requested(5)
    f.write_text(json.dumps({"req_id": "r1", "step": 7}))
    assert not sig.requested(6)
    assert sig.requested(7)
    assert not sig.requested(8)  # once per order
    f.write_text(json.dumps({"req_id": "r2"}))
    assert CheckpointManager(tmp_path / "ck").flush_requested(1)
    f.write_text("{not json")
    assert not sig.requested(3)
    monkeypatch.delenv(constants.TONY_CKPT_FLUSH_FILE)
    assert not CheckpointManager(tmp_path / "ck").flush_requested(1)


def _resume_step_env(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, max_to_keep=5)
    for s in (1, 2, 3):
        mgr.save(s, _state(float(s)), blocking=True)
    monkeypatch.setenv(constants.TONY_RESUME_STEP, "2")
    assert _step_of(mgr.restore_resumable(_state(0.0))) == 2
    monkeypatch.setenv(constants.TONY_RESUME_STEP, "7")  # gone: newest
    assert _step_of(mgr.restore_resumable(_state(0.0))) == 3
    monkeypatch.setenv(constants.TONY_RESUME_STEP, "x")  # ignored
    assert _step_of(mgr.restore_resumable(_state(0.0))) == 3
    monkeypatch.delenv(constants.TONY_RESUME_STEP)
    assert _step_of(mgr.restore_resumable(_state(0.0))) == 3


def _async_write_failure(tmp_path, monkeypatch):
    def boom(path, tmp, data):
        raise OSError("disk full")

    monkeypatch.setattr(port_stores, "_fsync_write", boom)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state(1.0))
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    monkeypatch.undo()
    mgr.save(2, _state(2.0), blocking=True)  # usable again
    assert mgr.latest_step() == 2


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _torn_step, _corrupt_checksum, _broken_chain, _differential_skip,
    _full_every_compaction, _gc_keeps_newest, _multiprocess_incomplete,
    _cross_topology, _flush_signal, _resume_step_env, _async_write_failure,
)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_manager_scenario(scenario, tmp_path, monkeypatch):
    """The JAX manager's scenarios (tests/test_checkpoint.py) on the
    port's manager."""
    monkeypatch.delenv(constants.TONY_RESUME_STEP, raising=False)
    SCENARIOS[scenario](tmp_path, monkeypatch)


def test_snapshot_survives_the_next_in_place_step(trained, tmp_path):
    """save(k) returns before the persist; the next step_fn updates the
    same tensors in place, and step k's values are still what lands."""
    _, _, t_init, t_step, _, _ = trained
    state = t_init(4)
    state, _ = t_step(state, _tokens(0))
    want = train_state_to_numpy(state)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state)
    for i in range(3):
        state, _ = t_step(state, _tokens(i + 1))
    mgr.wait()
    got = train_state_to_numpy(mgr.restore(t_init(5)))
    _assert_same(got, want)
    assert not np.array_equal(train_state_to_numpy(state)[".params['embed']"],
                              want[".params['embed']"])


def test_fresh_optimizer_saves_optax_init_state(tmp_path, mesh):
    """A state that has not stepped: count 0 and zero moments, which is
    what the JAX template's optax.adamw(...).init holds."""
    t_init, _ = make_train_step(TransformerConfig(**TINY), device="cpu")
    state = t_init(2)
    CheckpointManager(tmp_path).save(0, state, blocking=True)
    j_init, _ = jax_make_train_step(JaxConfig(**TINY), mesh,
                                    learning_rate=LR)
    restored = _jax_flat(JaxManager(tmp_path).restore(
        j_init(jax.random.key(3))))
    assert int(restored[".opt_state[1][0].count"]) == 0
    assert not restored[".opt_state[1][0].mu['embed']"].any()
    back = train_state_to_numpy(CheckpointManager(tmp_path).restore(
        t_init(8)))
    _assert_same(back, train_state_to_numpy(state))


def test_background_snapshot_is_refused(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="in place"):
        CheckpointManager(tmp_path, background_snapshot=True)
    monkeypatch.setenv(constants.TONY_CKPT_BG_SNAPSHOT, "1")
    with pytest.raises(ValueError, match="in place"):
        CheckpointManager(tmp_path)
    CheckpointManager(tmp_path, background_snapshot=False)


def test_structure_change_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state(1.0), blocking=True)
    with pytest.raises(ValueError, match="structure changed"):
        mgr.restore({"totally": torch.zeros(2)})


def test_close_stops_the_save_threads_and_drops_buffer_sets(tmp_path):
    """The port's manager has close() (the JAX one does not): its pipeline
    threads exit, the host buffer sets go, a later async save raises, and
    what was saved before stays readable."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state(1.0))
    mgr.save(2, _state(2.0))
    mgr.wait()
    threads = list(mgr._pipeline._threads)
    assert threads and all(t.is_alive() for t in threads)
    assert mgr._buffers._free
    mgr.close()
    assert not any(t.is_alive() for t in threads)
    assert not mgr._buffers._free
    with pytest.raises(RuntimeError, match="closed"):
        mgr.save(3, _state(3.0))
    assert mgr.latest_step() == 2
    restored = CheckpointManager(tmp_path).restore(_state(0.0))
    assert torch.equal(restored["params"]["w"], torch.full((8, 4), 2.0))


def test_train_cli_leaves_no_save_threads(tmp_path):
    """main() run inside a process closes its manager: the async saves'
    threads do not outlive the run."""
    import threading

    from tony_tpu_torch import train as train_cli

    rng = np.random.default_rng(0)
    motifs = rng.integers(1, 64, (4, 8))
    rows = np.tile(motifs[rng.integers(0, 4, 12)], 5)[:, :33]
    rows.astype(np.uint16).tofile(tmp_path / "c.tokens")

    def save_threads():
        return {t for t in threading.enumerate()
                if t.name.startswith("ckpt-") and t.is_alive()}

    before = save_threads()
    assert train_cli.main([
        "--device", "cpu", "--batch", "4", "--seq", "32", "--d-model", "32",
        "--n-layers", "2", "--n-heads", "2", "--n-kv-heads", "1",
        "--vocab", "64", "--lr", "3e-3", "--data", str(tmp_path / "c.tokens"),
        "--steps", "4", "--checkpoint-every", "2",
        "--ckpt-dir", str(tmp_path / "ck")]) == 0
    assert CheckpointManager(tmp_path / "ck").latest_step() == 4
    assert save_threads() <= before


def test_no_port_module_imports_ml_dtypes():
    files = sorted((REPO / "tony_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            assert not any(n.split(".")[0] == "ml_dtypes" for n in names), \
                path


def test_two_rank_sharded_checkpoints_cross_restore_with_jax(
        trained, mesh, tmp_path):
    """Two gloo ranks over a dp=2 mesh (embed_fsdp leaves split, their
    moments too). (1) They restore a step-2 JAX TrainState that two JAX
    managers (process 0 and 1 of 2) wrote: the gathered state equals it
    bit for bit. (2) After one more step each rank saves its pieces: the
    manifests hold the global shapes and the shard_indices JAX's dp=2
    shardings give each device, a fresh dp=2 state restores them bit for
    bit (the fast path), and the JAX manager at one process restores the
    step bit-equal to the gathered state."""
    j_init, j_step, *_ = trained
    jstate = j_init(jax.random.key(0))
    for i in range(2):
        jstate, _ = j_step(jstate, _tokens(i))
    for pid in range(2):
        JaxManager(tmp_path / "jax", process_id=pid, num_processes=2).save(
            2, jstate, blocking=True)
    params = jax.tree_util.tree_flatten_with_path(
        jax.device_get(jstate.params))[0]
    np.savez(tmp_path / "w.npz", **{"/".join(k.key for k in p): np.asarray(v)
                                    for p, v in params})
    np.save(tmp_path / "batch.npy", _tokens(5, b=4))
    results = launch("checkpoint", tmp_path, args=(
        tmp_path / "w.npz", tmp_path / "jax", tmp_path / "batch.npy",
        tmp_path / "port"))
    assert [(r["restored_step"], r["step"], r["round_trip_equal"])
            for r in results] == [(2, 3, True)] * 2
    ranks = [np.load(tmp_path / f"checkpoint.{r}.npz") for r in range(2)]
    want = _jax_flat(jstate)
    for data in ranks:
        _assert_same({k[len("restored/"):]: data[k] for k in data.files
                      if k.startswith("restored/")}, want)
    saved = {k[len("saved/"):]: ranks[0][k] for k in ranks[0].files
             if k.startswith("saved/")}

    jmesh = build_mesh(MeshSpec(dp=2), devices=jax.devices()[:2])
    shardings = {jax.tree_util.keystr(p): sh for p, sh in
                 jax.tree_util.tree_flatten_with_path(_sharding_for_tree(
                     jstate, jax_param_roles(JaxConfig(**TINY)), jmesh))[0]}
    split = 0
    for pid, device in enumerate(jmesh.devices.reshape(-1)):
        with np.load(tmp_path / "port" / "step_3" / f"process_{pid}.npz") \
                as npz:
            manifest = json.loads(bytes(npz[JAX_MANIFEST]).decode())
        assert set(manifest) == set(want)
        for path, info in manifest.items():
            shape = tuple(want[path].shape)
            index = _normalize_index(
                shardings[path].devices_indices_map(shape)[device], shape)
            assert info["shape"] == list(shape), path
            assert info["shard_indices"] == [index], path
            assert info["shard_shapes"] == [[b - a for a, b in index]], path
            split += index != [[0, d] for d in shape]
    assert split == 2 * 3 * 8  # 8 split params, their mu and nu, 2 ranks
    restored = JaxManager(tmp_path / "port").restore(j_init(jax.random.key(1)))
    _assert_same(_jax_flat(restored), saved)

# -- gs:// prefixes through one object store shared by both packages -------

@pytest.fixture
def gcs(tmp_path, monkeypatch):
    """Both packages' default storage on one ``FileObjectStorage`` root
    (each package keeps its own process-wide singleton)."""
    from tony_tpu import cloud as jax_cloud
    from tony_tpu_torch import cloud as port_cloud

    root = tmp_path / "gcs"
    monkeypatch.setattr(jax_cloud, "_default_storage",
                        jax_cloud.FileObjectStorage(root))
    monkeypatch.setattr(port_cloud, "_default_storage",
                        port_cloud.FileObjectStorage(root))
    return port_cloud.default_storage()


class TestGsCheckpoints:
    def test_port_state_on_gs_restores_exactly_in_jax(self, trained, mesh,
                                                      gcs):
        j_init, _, _, _, _, tstate = trained
        mgr = CheckpointManager("gs://bkt/runs/a")
        assert mgr.directory == "gs://bkt/runs/a"  # no Path() collapse
        mgr.save(2, tstate, blocking=True)
        assert (gcs.root / "bkt" / "runs" / "a" / "step_2" /
                "metadata.json").is_file()
        jmgr = JaxManager("gs://bkt/runs/a")
        assert jmgr.latest_step() == 2
        restored = jmgr.restore(j_init(jax.random.key(1)))
        _assert_same(_jax_flat(restored), train_state_to_numpy(tstate))

    def test_jax_state_on_gs_restores_exactly_in_the_port(self, trained,
                                                          mesh, gcs):
        j_init, j_step, t_init, _, _, _ = trained
        jstate = j_init(jax.random.key(0))
        for i in range(2):
            jstate, _ = j_step(jstate, _tokens(i))
        JaxManager("gs://bkt/runs/j").save(2, jstate, blocking=True)
        mgr = CheckpointManager("gs://bkt/runs/j")
        assert mgr.latest_step() == 2
        state = mgr.restore(t_init(5))
        _assert_same(train_state_to_numpy(state), _jax_flat(jstate))

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_bf16_leaves_round_trip_on_gs(self, writer, gcs):
        vals = np.asarray([1.5, -2.25, 3.0, 1e-3, -7e4], np.float32)
        uri = f"gs://bkt/bf16-{writer}"
        if writer == "jax":
            JaxManager(uri).save(1, {"w": jnp.asarray(vals, jnp.bfloat16)},
                                 blocking=True)
            out = CheckpointManager(uri).restore(
                {"w": torch.zeros(5, dtype=torch.bfloat16)})
            got = out["w"].float().numpy()
        else:
            CheckpointManager(uri).save(1, {"w": torch.from_numpy(vals).to(
                torch.bfloat16)}, blocking=True)
            out = JaxManager(uri).restore({"w": jnp.zeros(5, jnp.bfloat16)})
            assert out["w"].dtype == jnp.bfloat16
            got = np.asarray(out["w"], np.float32)
        want = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, want)

    def test_gs_writes_the_same_objects_as_jax(self, gcs):
        tree = {"a": np.arange(12, dtype=np.float32).reshape(4, 3),
                "s": np.asarray(7, np.int32)}
        JaxManager("gs://bkt/j").save(1, tree, blocking=True)
        CheckpointManager("gs://bkt/t").save(1, tree, blocking=True)
        names = [sorted(n.split("/", 1)[1] for n in gcs.list_prefix(
            f"gs://bkt/{d}/")) for d in "jt"]
        assert names[0] == names[1] == [
            "step_1/metadata.json", "step_1/process_0.json",
            "step_1/process_0.npz"]
        assert (gcs.get_bytes("gs://bkt/j/step_1/process_0.npz")
                == gcs.get_bytes("gs://bkt/t/step_1/process_0.npz"))

    def test_a_partial_write_on_gs_is_torn_for_both(self, gcs, monkeypatch):
        from tony_tpu.resilience import faults as jax_faults
        from tony_tpu_torch.resilience import faults

        monkeypatch.setenv(constants.TONY_FAULT_PLAN, json.dumps(
            {"faults": [{"action": "fail_checkpoint_write", "step": 2,
                         "mode": "partial"}]}))
        for mod in (faults, jax_faults):
            monkeypatch.setattr(mod, "_env_plan", None)
            monkeypatch.setattr(mod, "_ckpt_faults", False)
        mgr = CheckpointManager("gs://bkt/torn")
        mgr.save(1, _state(1.0), blocking=True)
        mgr.save(2, _state(2.0), blocking=True)
        assert gcs.exists("gs://bkt/torn/step_2/process_0.npz")
        assert not gcs.exists("gs://bkt/torn/step_2/metadata.json")
        assert mgr.latest_step() == 1
        assert JaxManager("gs://bkt/torn").latest_step() == 1
        assert int(mgr.restore(_state(0.0))["step"]) == 1

    def _stamp(self, gcs, prefix: str, when: float) -> None:
        for key in gcs.list_prefix(prefix):
            os.utime(gcs.root / "bkt" / key, (when, when))

    def test_gc_reads_torn_step_ages_from_the_listing(self, gcs,
                                                     monkeypatch):
        """The grace window is measured against the newest stamp of the
        same listing: the local clock (here a day ahead) plays no part."""
        from tony_tpu_torch.checkpoint import manager as manager_mod

        mgr = CheckpointManager("gs://bkt/gc", max_to_keep=2,
                                torn_gc_grace_s=100.0)
        for step in (3, 4):
            mgr.save(step, _state(float(step)), blocking=True)
        gcs.put_bytes("gs://bkt/gc/step_1/process_0.npz", b"torn")
        real_time = time.time
        monkeypatch.setattr(manager_mod.time, "time",
                            lambda: real_time() + 86400.0)
        base = 1.7e9
        self._stamp(gcs, "gs://bkt/gc/step_1/", base)
        for step in (3, 4):
            self._stamp(gcs, f"gs://bkt/gc/step_{step}/", base + 50.0)
        mgr._gc()
        assert gcs.exists("gs://bkt/gc/step_1/process_0.npz")  # 50 s old
        self._stamp(gcs, "gs://bkt/gc/step_4/", base + 150.0)
        mgr._gc()
        assert not gcs.list_prefix("gs://bkt/gc/step_1/")  # 150 s old
        assert mgr.latest_step() == 4

    def test_gc_keeps_a_torn_step_of_unknown_age(self, gcs, monkeypatch):
        """A store whose listing carries no stamps: every age is unknown,
        so no torn step is ever quiescent."""
        class NoStamps:
            def __init__(self, inner):
                self._inner = inner

            def __getattr__(self, name):
                if name == "list_prefix_mtimes":
                    raise AttributeError(name)
                return getattr(self._inner, name)

        from tony_tpu_torch import cloud as port_cloud

        monkeypatch.setattr(port_cloud, "_default_storage", NoStamps(gcs))
        mgr = CheckpointManager("gs://bkt/u", max_to_keep=1,
                                torn_gc_grace_s=0.0)
        mgr.save(3, _state(3.0), blocking=True)
        gcs.put_bytes("gs://bkt/u/step_1/process_0.npz", b"torn")
        mgr.save(4, _state(4.0), blocking=True)
        assert gcs.exists("gs://bkt/u/step_1/process_0.npz")
        assert not gcs.list_prefix("gs://bkt/u/step_3/")  # stale complete
        assert mgr.latest_step() == 4

    def test_train_cli_reads_and_resumes_on_gs(self, gcs, tmp_path,
                                               monkeypatch):
        from tony_tpu_torch import train as train_cli

        rng = np.random.default_rng(0)
        motifs = rng.integers(1, 64, (4, 8))
        rows = np.tile(motifs[rng.integers(0, 4, 12)], 5)[:, :33]
        gcs.put_bytes("gs://bkt/data/c.tokens",
                      rows.astype(np.uint16).tobytes())
        model = ["--device", "cpu", "--batch", "4", "--seq", "32",
                 "--d-model", "32", "--n-layers", "2", "--n-heads", "2",
                 "--n-kv-heads", "1", "--vocab", "64", "--lr", "3e-3",
                 "--checkpoint-every", "2"]
        remote = model + ["--data", "gs://bkt/data/c.tokens"]
        assert train_cli.main(remote + ["--steps", "3", "--ckpt-dir",
                                        "gs://bkt/ck"]) == 0
        # TONY_CHECKPOINT_DIR may name the prefix too.
        monkeypatch.setenv(constants.TONY_CHECKPOINT_DIR, "gs://bkt/ck")
        assert train_cli.main(remote + ["--steps", "6"]) == 0
        local = tmp_path / "c.tokens"
        rows.astype(np.uint16).tofile(local)
        assert train_cli.main(model + ["--data", str(local), "--steps", "6",
                                       "--ckpt-dir", str(tmp_path / "ck")]
                              ) == 0
        t_init, _ = make_train_step(TransformerConfig(
            vocab_size=64, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
            head_dim=16, d_ff=128, max_seq=33, dtype="float32",
            remat=False), device="cpu")
        got = train_state_to_numpy(CheckpointManager("gs://bkt/ck").restore(
            t_init(1), step=6))
        want = train_state_to_numpy(CheckpointManager(tmp_path / "ck")
                                    .restore(t_init(2), step=6))
        _assert_same(got, want)
