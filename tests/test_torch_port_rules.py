"""Rules of the PyTorch/CUDA port, checked on the CPU.

* No module of ``tony_tpu_torch`` — nor ``chip_smoke.py``, nor the rank
  programs of the multi-process tests — imports JAX or anything of the JAX
  package ``tony_tpu``: the port keeps its own copies.
* The port runs on the card unless the caller asks for the CPU: on a machine
  without CUDA every entry point raises instead of falling back, and
  ``chip_smoke.py`` exits non-zero without printing a result.
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
# The rank programs of the multi-process tests (tests/torch_ranks.py) run
# as port code too: ranks never import JAX.
PORT_FILES = sorted((REPO / "tony_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "flash_bwd_study.py",
    REPO / "dp_study.py", REPO / "attention_chain_study.py",
    REPO / "anatomy_study.py", REPO / "telemetry_study.py",
    REPO / "tests" / "torch_ranks.py",
]

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=64, max_seq=96, dtype="float32", remat=False)


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "tony_tpu", "flax", "optax")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax_or_tony_tpu(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scanner_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\n"
                     "from tony_tpu.ops import rms_norm\n"
                     "import importlib\nimportlib.import_module('tony_tpu')\n"
                     "import tony_tpu_torch\n")
    assert [n for n in _imported_modules(probe) if _forbidden(n)] == [
        "jax.numpy", "tony_tpu.ops", "tony_tpu"]


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    from tony_tpu_torch.models import (DecodeSession, TransformerConfig,
                                       generate, init_params)
    from tony_tpu_torch.serving import ServingEngine

    cfg = TransformerConfig(**TINY)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeSession(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(params, prompt, cfg, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(params, cfg)
    # Asked for explicitly, the CPU works.
    assert generate(params, prompt, cfg, 2, device="cpu").shape == (1, 2)


def test_training_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    from tony_tpu_torch import runtime
    from tony_tpu_torch.models import (TransformerConfig, forward,
                                       init_params, make_train_step)
    from tony_tpu_torch.ops import rope_frequencies

    cfg = TransformerConfig(**TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runtime.initialize()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rope_frequencies(16, 8)
    # forward runs where its params live and never picks a device itself:
    # the default params come from the card, so without one there are
    # none; params placed on the CPU by the caller run there.
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits = forward(params, torch.zeros(1, 4, dtype=torch.long), cfg)
    assert logits.device.type == "cpu"
    init_fn, step_fn = make_train_step(cfg, device="cpu")
    _, metrics = step_fn(init_fn(0), np.zeros((1, 5), np.int64))
    assert metrics["loss"].device.type == "cpu"


def test_train_cli_defaults_to_cuda():
    _no_cuda()
    from tony_tpu_torch import train

    assert train.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1"])


def test_serve_cli_defaults_to_cuda():
    _no_cuda()
    from tony_tpu_torch import serve

    assert serve.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--max-requests", "1"])


def test_serve_cli_on_cpu_answers_and_exits(tmp_path):
    """The CLI on the CPU when asked: serves one /generate and exits."""
    import json
    import threading
    import time
    import urllib.request

    from tony_tpu_torch import serve

    addr = tmp_path / "serve.addr"
    rc = {}
    thread = threading.Thread(target=lambda: rc.setdefault("rc", serve.main([
        "--device", "cpu", "--d-model", "32", "--n-layers", "1",
        "--n-heads", "2", "--n-kv-heads", "1", "--vocab", "64",
        "--max-seq", "64", "--slots", "2", "--port", "0",
        "--addr-file", str(addr), "--max-requests", "1",
    ])), daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while not addr.exists():
        assert time.monotonic() < deadline and thread.is_alive()
        time.sleep(0.05)
    port = addr.read_text().strip().rpartition(":")[2]
    body = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 4}).encode()
    with urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=body,
    ), timeout=60) as resp:
        assert json.loads(resp.read())["length"] == 4
    thread.join(timeout=60)
    assert not thread.is_alive() and rc["rc"] == 0


def test_kernel_build_has_no_fallback_without_nvcc(monkeypatch, tmp_path):
    from tony_tpu_torch import kernels

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has a CUDA toolkit")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build(["rms_norm"])


def test_entry_points_of_one_source_build_one_library(monkeypatch, tmp_path):
    """B2 and B3 live in one source: asking for both starts one compiler
    process, whose output is the library both entry points load."""
    from tony_tpu_torch import kernels

    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    log = tmp_path / "calls"
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {log}\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    "touch \"$2\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    built = kernels.build(["flash_bwd_dq", "flash_bwd_dkv"])
    assert list(built) == ["flash_bwd"]
    calls = log.read_text().splitlines()
    assert len(calls) == 1 and calls[0].endswith("csrc/flash_bwd.cu")
    assert "arch=compute_90a,code=sm_90a" in calls[0]
    assert kernels.library_path("flash_bwd.cu").is_file()
    # Built once, present afterwards: nothing to do.
    assert kernels.build(["flash_bwd_dkv"]) == {}
    assert {src for src, _, _ in kernels.KERNELS.values()} == {
        p.name for p in kernels.CSRC.glob("*.cu")}


def test_library_path_follows_shared_headers(monkeypatch, tmp_path):
    """A source may include any ``csrc/*.cuh``: editing, adding or removing
    a header gives its library a new path, so a stale one is never
    loaded; editing an unrelated ``.cu`` does not."""
    from tony_tpu_torch import kernels

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "helpers.cuh"\n')
    (csrc / "b.cu").write_text("// another source\n")
    header = csrc / "helpers.cuh"
    header.write_text("#pragma once\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    first = kernels.library_path("a.cu")
    assert kernels.library_path("a.cu") == first
    (csrc / "b.cu").write_text("// edited\n")
    assert kernels.library_path("a.cu") == first
    header.write_text("#pragma once\n// edited\n")
    edited = kernels.library_path("a.cu")
    assert edited != first and edited.name.startswith("liba-")
    (csrc / "more.cuh").write_text("#pragma once\n")
    added = kernels.library_path("a.cu")
    assert added not in (first, edited)
    (csrc / "more.cuh").unlink()
    assert kernels.library_path("a.cu") == edited


def test_every_local_include_is_a_digested_header():
    """A source's quoted includes are ``csrc/*.cuh`` files, the headers
    ``library_path`` hashes; the flash kernels take their tensor-core
    helpers from one."""

    from tony_tpu_torch import kernels

    headers = {p.name for p in kernels.CSRC.glob("*.cuh")}
    included = set()
    for path in [*kernels.CSRC.glob("*.cu"), *kernels.CSRC.glob("*.cuh")]:
        local = re.findall(r'^#include "([^"]+)"', path.read_text(), re.M)
        assert set(local) <= headers, f"{path.name} includes {local}"
        included |= set(local)
    assert "hopper.cuh" in included


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_cuda():
    _no_cuda()
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def _torch_attention():
    from tony_tpu_torch.ops import attention

    return attention


def _repo_module(name: str):
    sys.path.insert(0, str(REPO))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(REPO))


_HMMA = "HMMA.16816.F32.BF16 R24, R4, R20, R24 ;"
_HGMMA = ("HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;")


def _sass(mma: dict[str, int], op: str = _HMMA) -> str:
    """A cuobjdump listing with one function per (kernel, head_dim) key,
    each holding that many ``op`` lines (default HMMA) among FMAs."""
    out = ["\tcode for sm_90a"]
    for key, n in mma.items():
        kernel, d = re.fullmatch(r"(\w+_(?:bf16|fp32))(\d+)", key).groups()
        out.append(f"\t\tFunction : _ZN45_GLOBAL__N__0_12_flash_bwd_cu_0"
                   f"{len(kernel)}{kernel}ILi{d}EEEvNS_6ParamsE")
        out += [f"        /*0a70*/   {op}"] * n
        out.append("        /*0100*/   FFMA R3, R4, R5, R3 ;")
    return "\n".join(out) + "\n"


def test_chip_smoke_counts_tensor_core_instructions_per_kernel():
    """chip_smoke.py reads the SASS of the flash backward: it must list
    the 8 instances, bf16 ones with wgmma instructions (HGMMA) and fp32
    (FMA) ones with no tensor-core instruction; bf16 instances that hold
    only mma.sync's HMMA are refused."""
    chip_smoke = _repo_module("chip_smoke")
    want = {f"flash_bwd_{k}_kernel_{dt}{d}": (2 if dt == "bf16" else 0)
            for k in ("dq", "dkv") for dt in ("bf16", "fp32")
            for d in (64, 128)}
    assert set(want) == chip_smoke.BWD_INSTANCES
    assert chip_smoke.sass_mma_counts(_sass(want, _HGMMA)) == want
    no_mma = _sass(want, _HGMMA).replace("HGMMA.64x64x16.F32.BF16", "FFMA")
    with pytest.raises(AssertionError, match="bf16 instances need some"):
        chip_smoke.sass_mma_counts(no_mma)
    with pytest.raises(AssertionError,
                       match=r"bf1664: no HGMMA instruction \(2 tensor-core"):
        chip_smoke.sass_mma_counts(_sass(want))
    fp32_mma = dict(want, flash_bwd_dkv_kernel_fp3264=1)
    with pytest.raises(AssertionError,
                       match="fp3264: 1 tensor-core instructions"):
        chip_smoke.sass_mma_counts(_sass(fp32_mma, _HGMMA))
    missing = dict(want)
    del missing["flash_bwd_dkv_kernel_bf16128"]
    with pytest.raises(AssertionError, match="not the instances"):
        chip_smoke.sass_mma_counts(_sass(missing, _HGMMA))
    with pytest.raises(AssertionError, match="listed no flash_bwd kernel"):
        chip_smoke.sass_mma_counts("")


def test_chip_smoke_counts_tensor_core_instructions_in_the_forward():
    """The same SASS check on the flash forward's library: exactly the 4
    instances, the bf16 ones with wgmma instructions (HGMMA) and the fp32
    (FMA) ones with none; bf16 instances that hold only mma.sync's HMMA
    are refused; the backward's instances do not count there."""
    chip_smoke = _repo_module("chip_smoke")
    want = {f"flash_fwd_kernel_{dt}{d}": (3 if dt == "bf16" else 0)
            for dt in ("bf16", "fp32") for d in (64, 128)}
    assert set(want) == chip_smoke.FWD_INSTANCES
    fwd = chip_smoke.FWD_INSTANCES
    both = _sass({**want, "flash_bwd_dq_kernel_bf1664": 2}, _HGMMA)
    assert chip_smoke.sass_mma_counts(both, fwd) == want
    with pytest.raises(AssertionError,
                       match=r"bf1664: no HGMMA instruction \(3 tensor-core"):
        chip_smoke.sass_mma_counts(_sass(want), fwd)
    missing = dict(want)
    del missing["flash_fwd_kernel_bf16128"]
    with pytest.raises(AssertionError, match="not the instances"):
        chip_smoke.sass_mma_counts(_sass(missing, _HGMMA), fwd)
    no_mma = dict(want, flash_fwd_kernel_bf1664=0)
    with pytest.raises(AssertionError, match="bf16 instances need some"):
        chip_smoke.sass_mma_counts(_sass(no_mma, _HGMMA), fwd)
    fp32_mma = dict(want, flash_fwd_kernel_fp32128=1)
    with pytest.raises(AssertionError,
                       match="fp32128: 1 tensor-core instructions"):
        chip_smoke.sass_mma_counts(_sass(fp32_mma, _HGMMA), fwd)
    with pytest.raises(AssertionError, match="listed no flash_fwd kernel"):
        chip_smoke.sass_mma_counts(
            _sass({"flash_bwd_dq_kernel_bf1664": 2}, _HGMMA), fwd)
    assert chip_smoke.kernel_name(
        "_ZN45_GLOBAL__N__0_12_flash_fwd_cu_021flash_fwd_kernel_bf16ILi128E"
        "EEvNS_6ParamsE") == "flash_fwd_kernel_bf16128"


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0_12_flash_bwd_cu_025flash_bwd_dkv_kernel_bf16ILi128EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__0_12_flash_bwd_cu_025flash_bwd_dkv_kernel_bf16ILi128EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 240 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z14tony_rms_normPv' for 'sm_90a'
ptxas info    : Function properties for _Z14tony_rms_normPv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 384 bytes cmem[0]
"""


def test_chip_smoke_fails_a_build_that_spills():
    """chip_smoke.py reads registers and spills from ptxas's report and
    fails the build phase when a function spills or none is listed."""
    chip_smoke = _repo_module("chip_smoke")
    assert chip_smoke.ptxas_kernels(_PTXAS) == {
        "flash_bwd_dkv_kernel_bf16128": {"registers": 240, "spill_bytes": 0},
        "_Z14tony_rms_normPv": {"registers": 32, "spill_bytes": 0}}
    chip_smoke.check_no_spills({"flash_bwd": _PTXAS})
    spilled = _PTXAS.replace("0 bytes spill stores, 0 bytes spill loads",
                             "8 bytes spill stores, 12 bytes spill loads", 1)
    with pytest.raises(AssertionError, match="spills.*bf16128': 20"):
        chip_smoke.check_no_spills({"flash_bwd": spilled})
    with pytest.raises(AssertionError, match="no function for rms_norm"):
        chip_smoke.check_no_spills({"rms_norm": ""})


def test_bwd_row_error_sees_a_fault_in_small_rows():
    """The row error of chip_smoke.py: a 10 % fault in the rows of small
    gradients reads 0.1 while the max abs error stays under TOL's limit;
    rows that are zero in the plain version read against the floor."""
    chip_smoke = _repo_module("chip_smoke")
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((64, 16)).astype(np.float32)
    rows *= (1.0 / np.arange(1, 65))[:, None].astype(np.float32)
    rows[0] = 0.0
    want = torch.from_numpy(rows).reshape(1, 64, 1, 16)
    got = want.clone()
    got[:, 32:] *= 1.1
    got[:, 0] = 1e-6
    errs = chip_smoke.bwd_errors(torch, (got,) * 3, (want,) * 3)
    e = errs["dq"]
    assert e["max_want"] == pytest.approx(float(np.abs(rows).max()))
    assert e["max_abs_err"] < 2e-2 * max(1.0, e["max_want"])
    assert e["row_err"] == pytest.approx(0.1, rel=1e-4)
    assert chip_smoke.bwd_errors(torch, (want,) * 3, (want,) * 3)[
        "dk"]["row_err"] == 0.0


def test_row_error_of_an_all_zero_reference():
    """A pipeline's bubble ticks run the kernels on zero activations and
    zero cotangents, where the plain version's rows are all zero: the row
    error of chip_smoke.py reads 0 for an exact result and fails any
    other (not NaN, which no comparison fails)."""
    chip_smoke = _repo_module("chip_smoke")
    want = torch.zeros(8, 16)
    assert chip_smoke.row_error(want - want, want) == 0.0
    got = want.clone()
    got[3, 5] = 1e-6
    assert chip_smoke.row_error(got - want, want) > chip_smoke.ROW_TOL
    errs = chip_smoke.fwd_errors((want.reshape(1, 8, 1, 16), want[0]),
                                 (want.reshape(1, 8, 1, 16), want[0]))
    assert all(chip_smoke.fwd_checks(errs, torch.bfloat16, rows=True)
               .values())


def test_fwd_row_error_sees_a_fault_in_small_late_rows():
    """B1's row error in chip_smoke.py: a 10 % fault in the late rows of a
    causal output, which are small, reads 0.1 while the max abs error of
    out stays under TOL (and lse is untouched), so only the row check
    fails it."""
    chip_smoke = _repo_module("chip_smoke")
    rng = np.random.default_rng(1)
    t, d = 2048, 64
    # Row i of a causal output averages i + 1 unit-variance values.
    rows = rng.standard_normal((t, d)) / np.sqrt(np.arange(1, t + 1))[:, None]
    want = torch.from_numpy(rows.astype(np.float32)).reshape(1, t, 1, d)
    lse = torch.from_numpy(rng.standard_normal((1, 1, t)).astype(np.float32))
    got = want.clone()
    got[:, 1024:] *= 1.1
    errs = chip_smoke.fwd_errors((got, lse), (want, lse))
    assert errs["max_abs_err"] < chip_smoke.TOL[("flash_fwd",
                                                 "torch.bfloat16")]
    assert errs["lse_err"] == 0.0
    assert errs["row_err"] == pytest.approx(0.1, rel=1e-4)
    dt = torch.bfloat16
    assert chip_smoke.fwd_checks(errs, dt) == {"max_abs": True, "lse": True}
    assert chip_smoke.fwd_checks(errs, dt, rows=True)["row"] is False
    with pytest.raises(AssertionError, match="row tol"):
        chip_smoke._check_fwd("late rows", (got, lse), (want, lse), dt,
                              rows=True)
    sound = chip_smoke.fwd_errors((want, lse), (want, lse))
    assert sound["row_err"] == 0.0
    assert all(chip_smoke.fwd_checks(sound, dt, rows=True).values())
    with pytest.raises(AssertionError, match="flash: out"):
        chip_smoke.fwd_errors((got.to(dt), lse), (want, lse))


def test_flash_fwd_study_variants_apply_to_the_source():
    """Every substitution of the study's forward sweep and controls
    matches flash_fwd.cu exactly once, each variant but the shipped one
    changes it, and each sweep variant moves just its own constant."""
    study = _repo_module("flash_bwd_study")
    from tony_tpu_torch import kernels

    text = (kernels.CSRC / "flash_fwd.cu").read_text()
    variants = study.fwd_sweep_variants(text)
    for name, subs in {**variants, **study.FWD_CONTROLS}.items():
        changed = study.substitute(text, name, subs, "flash_fwd.cu")
        assert (changed == text) == (name == "shipped"), name
    comments = study.FWD_TILE_COMMENTS
    shipped = study.shipped_tiles(text, comments)
    assert set(shipped) == set(study.FWD_SWEEP) == set(comments)
    for key, values in study.FWD_SWEEP.items():
        for v in values:
            if str(v) == shipped[key]:
                continue
            changed = study.substitute(text, f"{key}{v}",
                                       variants[f"{key}{v}"], "flash_fwd.cu")
            assert study.shipped_tiles(changed, comments) == {
                **shipped, key: str(v)}
    ring = study.substitute(text, "ring", study.FWD_CONTROLS[
        "fwd_ring_loses_a_stage"], "flash_fwd.cu")
    assert ring.count("% S % (S - 1))") == 1
    with pytest.raises(ValueError, match="occurs 0 times in flash_fwd.cu"):
        study.substitute(text, "bad", [("no such line", "")], "flash_fwd.cu")


def test_flash_bwd_study_variants_apply_to_the_source():
    """Every substitution of flash_bwd_study.py (tile sweep and fault
    controls) matches flash_bwd.cu exactly once, so the study builds what
    it says it builds."""
    study = _repo_module("flash_bwd_study")
    from tony_tpu_torch import kernels

    text = (kernels.CSRC / "flash_bwd.cu").read_text()
    variants = {**study.sweep_variants(text), **study.CONTROLS}
    for name, subs in variants.items():
        changed = study.substitute(text, name, subs)
        assert (changed == text) == (name == "shipped"), name
    shipped = study.shipped_tiles(text)
    assert set(shipped) == set(study.SWEEP)
    for key, values in study.SWEEP.items():
        for v in values:
            if str(v) == shipped[key]:
                continue
            name = f"{key}{v}"
            changed = study.substitute(text, name,
                                       study.sweep_variants(text)[name])
            assert study.shipped_tiles(changed) == {**shipped, key: str(v)}
    with pytest.raises(ValueError, match="occurs 0 times"):
        study.substitute(text, "bad", [("no such line", "")])


def test_chip_smoke_fwd_tiles_match_the_source():
    """chip_smoke.py's FWD_TILES, which its B1 tile-edge cases straddle,
    are the bf16 B1 tiles flash_fwd.cu compiles, ops/attention.py's TILES
    names the same one instance, and the edge cases sit one below, at and
    one above one and two query tiles, one key tile and the ring's keys, at
    both head_dims and both mask modes."""
    chip_smoke = _repo_module("chip_smoke")
    study = _repo_module("flash_bwd_study")
    from tony_tpu_torch import kernels

    shipped = study.shipped_tiles(
        (kernels.CSRC / "flash_fwd.cu").read_text(), study.FWD_TILE_COMMENTS)
    assert set(chip_smoke.FWD_TILES) == {64, 128}
    square = {(c["t_q"], c["d"], c["causal"])
              for c in chip_smoke.FLASH_FWD_CASES if c["t_q"] == c["t_k"]}
    for d, want in chip_smoke.FWD_TILES.items():
        tiles = {k: study.tile_value(shipped[k], d)
                 for k in ("fwd_warpgroups", "fwd_keys", "fwd_stages")}
        assert want == {
            "rows": 64 * tiles["fwd_warpgroups"],
            "keys": tiles["fwd_keys"],
            "ring_keys": tiles["fwd_stages"] * tiles["fwd_keys"]}, d
        assert _torch_attention().TILES["flash_fwd"][d] == (want["rows"],)
        edges = [n * want["rows"] for n in (1, 2)] + [want["keys"],
                                                     want["ring_keys"]]
        for edge in edges:
            for step in (-1, 0, 1):
                for causal in (True, False):
                    assert (edge + step, d, causal) in square, (edge, d)


def test_chip_smoke_bwd_tiles_match_the_source():
    """chip_smoke.py's BWD_TILES, which its tile-edge cases straddle, are
    the bf16 B2/B3 tiles flash_bwd.cu compiles, ops/attention.py's TILES
    names the same one instance of each, and the edge cases sit one below,
    at and one above one and two of each tile at both head_dims."""
    chip_smoke = _repo_module("chip_smoke")
    study = _repo_module("flash_bwd_study")
    from tony_tpu_torch import kernels

    shipped = study.shipped_tiles(
        (kernels.CSRC / "flash_bwd.cu").read_text())
    assert set(chip_smoke.BWD_TILES) == {64, 128}
    square = {(c["t_q"], c["d"]) for c in chip_smoke.FLASH_BWD_CASES
              if c["t_q"] == c["t_k"]}
    for d, want in chip_smoke.BWD_TILES.items():
        tiles = {k: study.tile_value(v, d) for k, v in shipped.items()}
        assert want == {
            "dq_rows": 64 * tiles["dq_warpgroups"],
            "dq_keys": tiles["dq_keys"],
            "dkv_keys": 64 * tiles["dkv_warpgroups"],
            "dkv_rows": tiles["dkv_rows"]}, d
        attention = _torch_attention()
        assert attention.TILES["flash_bwd_dq"][d] == (want["dq_rows"],)
        assert attention.TILES["flash_bwd_dkv"][d] == (want["dkv_keys"],)
        for tile in want.values():
            for n in (1, 2):
                for step in (-1, 0, 1):
                    assert (n * tile + step, d) in square, (n, tile, d)
    assert study.tile_value("D == 64 ? 3 : 2", 64) == 3
    assert study.tile_value("D == 64 ? 3 : 2", 128) == 2
    with pytest.raises(ValueError, match="not a number"):
        study.tile_value("kWgRows * 2", 64)


def test_tile_knob_built_set_is_the_tuners_candidates():
    """The tile knob's values at each head_dim (block_q: B1's and B2's
    common rows, None where they differ; block_k: B3's keys) are exactly
    the non-default points of autotune.flash_block_candidates, which leads
    with Knobs()."""
    from tony_tpu_torch.parallel import autotune

    attention = _torch_attention()
    for d in (64, 128):
        built_q, built_k = attention.built_blocks(d)
        cands = autotune.flash_block_candidates(d)
        assert cands[0] == autotune.Knobs()
        assert [(k.block_q, k.block_k) for k in cands[1:]] == [
            (bq, bk) for bq in built_q or (None,) for bk in built_k]
    assert attention.built_blocks(64) == ((192,), (192,))
    assert attention.built_blocks(128) == ((), (128,))
    assert attention.built_blocks(32) == ((), ())


def test_the_compile_plan_tune_modules_fall_under_the_import_scan():
    for rel in ("tony_tpu_torch/analysis/__init__.py",
                "tony_tpu_torch/analysis/jit_sanitizer.py",
                "tony_tpu_torch/parallel/autotune.py",
                "tony_tpu_torch/parallel/plan.py"):
        assert REPO / rel in PORT_FILES, rel


def test_the_slice_s_modules_fall_under_the_import_scan():
    for rel in ("tony_tpu_torch/observability/metrics.py",
                "tony_tpu_torch/observability/stepstats.py",
                "tony_tpu_torch/parallel/plan.py",
                "tony_tpu_torch/models/mnist.py",
                "tony_tpu_torch/models/resnet.py",
                "tony_tpu_torch/mnist_distributed.py"):
        assert REPO / rel in PORT_FILES, rel


def test_the_telemetry_modules_fall_under_the_import_scan():
    for rel in ("tony_tpu_torch/observability/trace.py",
                "tony_tpu_torch/observability/profiling.py",
                "tony_tpu_torch/profiling.py",
                "tony_tpu_torch/observability/__init__.py",
                "tony_tpu_torch/serving/scheduler.py",
                "tony_tpu_torch/checkpoint/manager.py",
                "tony_tpu_torch/io/reader.py",
                "tony_tpu_torch/runtime.py"):
        assert REPO / rel in PORT_FILES, rel


def test_classifier_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    from tony_tpu_torch.models import (MnistConfig, ResNetConfig,
                                       make_classifier_step,
                                       make_image_classifier_step,
                                       mnist_init, resnet_init)

    cfg = MnistConfig(dtype="float32")
    for call in (lambda: mnist_init(cfg),
                 lambda: resnet_init(ResNetConfig(depth=18, width=8)),
                 lambda: make_classifier_step(cfg),
                 lambda: make_image_classifier_step(None, None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    init_fn, step_fn = make_classifier_step(cfg, device="cpu")
    _, metrics = step_fn(init_fn(0), np.zeros((2, 28, 28, 1), np.float32),
                         np.zeros((2,), np.int64))
    assert metrics["loss"].device.type == "cpu"


def test_mnist_distributed_defaults_to_cuda():
    _no_cuda()
    from tony_tpu_torch import mnist_distributed

    assert mnist_distributed.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mnist_distributed.main(["--steps", "1"])


def test_chip_smoke_holds_the_classifier_path_to_zero_launches():
    """The classifier path runs none of B1-B4 by design: chip_smoke.py
    checks that each of its counts is 0 (any launch fails the run), and
    every other path it checks must launch every kernel it counts."""
    import inspect

    chip_smoke = _repo_module("chip_smoke")
    assert chip_smoke.ZERO_LAUNCH_PATHS == ("classifier",)
    zeros = {"rms_norm": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
             "flash_bwd_dkv": 0}
    chip_smoke.check_path_launches({"classifier": zeros})
    with pytest.raises(AssertionError, match="launched 2 times on the "
                                             "classifier path"):
        chip_smoke.check_path_launches({"classifier": {**zeros,
                                                       "flash_fwd": 2}})
    with pytest.raises(AssertionError, match="never launched on the "
                                             "anatomy path"):
        chip_smoke.check_path_launches({"anatomy": {**zeros, "rms_norm": 5}})
    src = inspect.getsource(chip_smoke.classifier_phase)
    assert 'check_path_launches({"classifier": launches})' in src
    assert "_reset_launches(attention, norms)" in src
    main = inspect.getsource(chip_smoke.main)
    assert '"classifier": classifier["launches"][row["name"]]' in main


def test_the_job_path_modules_fall_under_the_import_scan():
    for rel in ("tony_tpu_torch/cloud/__init__.py",
                "tony_tpu_torch/cloud/gcs.py",
                "tony_tpu_torch/cloud/transport.py",
                "tony_tpu_torch/resilience/__init__.py",
                "tony_tpu_torch/resilience/faults.py",
                "tony_tpu_torch/io/native.py",
                "tony_tpu_torch/io/storage.py",
                "tony_tpu_torch/checkpoint/stores.py"):
        assert REPO / rel in PORT_FILES, rel


def _job_c_inputs(chip_smoke) -> dict:
    """Records of jobs A and C, sleeps, persist times and a torn step that
    pass chip_smoke.check_job_c: what a good run of the phase reads."""
    steps_a = [{"step": i + 1, "loss": 10.0 - i * 0.5, "wall_s": 0.106}
               for i in range(chip_smoke.JOB_STEPS)]
    steps_a[2]["phases_ms"] = [{"data_wait": 0.4}]
    steps_c = [{k: v for k, v in r.items() if k != "phases_ms"}
               for r in steps_a[:chip_smoke.JOB_C_STEPS]]
    steps_c[0]["wall_s"] = 2.5  # the first step's one-off costs
    steps_c[1]["phases_ms"] = [{"data_wait": 100.2}]
    steps_c[chip_smoke.JOB_C_DEGRADE_AFTER]["wall_s"] = 0.106 + 0.1502
    return {
        "records_a": steps_a, "records_c": steps_c,
        "slept": {"throttle": [(2, 0.1), (3, 0.1)], "degrade": [0.15]},
        "persist_ms": [204.3, 210.9],
        "torn": {"latest": chip_smoke.JOB_C_RESUME, "complete": False,
                 "shard": True, "marker": False},
    }


@pytest.mark.parametrize("fault", [
    None, "losses", "torn_complete", "torn_marker", "latest", "persist",
    "throttle", "data_wait", "degrade_sleep", "degrade_wall"])
def test_chip_smoke_job_c_checks_fail_on_a_fault(fault):
    """chip_smoke's job C checks pass a good run and fail each fault: a
    loss that differs from job A's, a torn step listed complete, a save
    faster than the delay, a throttle elsewhere, no extra data_wait, a
    degrade missing from the step wall."""
    chip_smoke = _repo_module("chip_smoke")
    got = _job_c_inputs(chip_smoke)
    if fault == "losses":
        got["records_c"][3]["loss"] = np.nextafter(
            got["records_c"][3]["loss"], 0.0)
    elif fault == "torn_complete":
        got["torn"]["complete"] = True
    elif fault == "torn_marker":
        got["torn"]["marker"] = True
    elif fault == "latest":
        got["torn"]["latest"] = chip_smoke.JOB_C_STEPS
    elif fault == "persist":
        got["persist_ms"][1] = 150.0
    elif fault == "throttle":
        got["slept"]["throttle"] = [(1, 0.1), (2, 0.1)]
    elif fault == "data_wait":
        got["records_c"][1]["phases_ms"] = [{"data_wait": 0.3}]
    elif fault == "degrade_sleep":
        got["slept"]["degrade"] = []
    elif fault == "degrade_wall":
        got["records_c"][chip_smoke.JOB_C_DEGRADE_AFTER]["wall_s"] = 0.2
    args = (got["records_a"], got["records_c"], got["slept"],
            got["persist_ms"], got["torn"])
    if fault is None:
        checked = chip_smoke.check_job_c(*args)
        assert checked["losses_equal"] == chip_smoke.JOB_C_STEPS
        assert checked["data_wait_ms"] == {"a": 0.4, "c": 100.2}
        return
    with pytest.raises(AssertionError):
        chip_smoke.check_job_c(*args)


def test_chip_smoke_job_c_plan_is_valid_and_tears_the_last_save():
    from tony_tpu_torch.resilience import faults

    chip_smoke = _repo_module("chip_smoke")
    plan = faults.FaultPlan.parse(json.dumps(chip_smoke.JOB_C_PLAN))
    ckpt = faults.CheckpointFaults(plan, "worker:0")
    decisions = []
    for step in (2, 4, 6, 6):  # the interval saves and the final one
        decisions.append((ckpt.write_delay_ms(step), ckpt.partial_write(step)))
    assert decisions == [(200, False), (200, False), (200, True),
                         (200, True)]
    assert chip_smoke.JOB_C_RESUME == chip_smoke.JOB_C_STEPS - \
        chip_smoke.JOB_EVERY


@pytest.mark.parametrize("where", ["local", "local_preadv", "gs"])
def test_chip_smoke_read_counts_see_the_read_path(tmp_path, monkeypatch,
                                                  where):
    """chip_smoke.io_counts around a real read: local spans through the
    native library pass check_native_reads, a run whose spans never
    reached pread_records (the preadv path) fails it, and gs:// spans pass
    check_gs_reads and fail the native check."""
    from tony_tpu_torch import cloud
    from tony_tpu_torch.io import ShardedRecordReader, native

    chip_smoke = _repo_module("chip_smoke")
    path = tmp_path / "c.tokens"
    np.arange(40 * 8, dtype=np.uint16).tofile(path)
    uri = str(path)
    if where == "gs":
        store = cloud.FileObjectStorage(tmp_path / "gcs")
        monkeypatch.setattr(cloud, "_default_storage", store)
        uri = "gs://b/c.tokens"
        store.upload_file(path, uri)
    if where == "local_preadv":
        monkeypatch.setattr(native, "available", lambda: False)
    with chip_smoke.io_counts() as counts:
        with ShardedRecordReader([uri], fmt="tokens", record_len=8,
                                 dtype=np.uint16, batch_size=4,
                                 chunk_records=2) as reader:
            assert sum(len(b) for b in reader) == 40
        seen = counts()
    assert native.pread_records.__name__ == "pread_records"  # unpatched
    if where == "local":
        chip_smoke.check_native_reads("run", seen)
        assert seen["local_spans"] > 1
    elif where == "local_preadv":
        assert seen["pread"] == 0 and seen["local_spans"] > 1
        with pytest.raises(AssertionError, match="pread_records"):
            chip_smoke.check_native_reads("run", seen)
    else:
        chip_smoke.check_gs_reads("run", seen)
        with pytest.raises(AssertionError):
            chip_smoke.check_native_reads("run", seen)


def test_chip_smoke_drives_the_job_gs_path():
    import inspect

    chip_smoke = _repo_module("chip_smoke")
    src = inspect.getsource(chip_smoke.job_gs_phase)
    assert "_reset_launches(attention, norms)" in src
    assert 'check_path_launches({"job_gs": launches})' in src
    main = inspect.getsource(chip_smoke.main)
    assert '"job_gs": job_gs["launches"][row["name"]]' in main
