"""Rules of the PyTorch/CUDA port, checked on the CPU.

* No module of ``tony_tpu_torch`` — nor ``chip_smoke.py`` — imports JAX or
  anything of the JAX package ``tony_tpu``: the port keeps its own copies.
* The port runs on the card unless the caller asks for the CPU: on a machine
  without CUDA every entry point raises instead of falling back, and
  ``chip_smoke.py`` exits non-zero without printing a result.
"""

from __future__ import annotations

import ast
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
PORT_FILES = sorted((REPO / "tony_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "flash_bwd_study.py"
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
    ``library_path`` hashes; flash_bwd.cu takes its tensor-core helpers
    from one."""

    from tony_tpu_torch import kernels

    headers = {p.name for p in kernels.CSRC.glob("*.cuh")}
    included = set()
    for path in [*kernels.CSRC.glob("*.cu"), *kernels.CSRC.glob("*.cuh")]:
        local = re.findall(r'^#include "([^"]+)"', path.read_text(), re.M)
        assert set(local) <= headers, f"{path.name} includes {local}"
        included |= set(local)
    assert "mma_sync.cuh" in included


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


def _repo_module(name: str):
    sys.path.insert(0, str(REPO))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(REPO))


def _sass(mma: dict[str, int]) -> str:
    """A cuobjdump listing with one function per (kernel, head_dim) key,
    each holding that many HMMA lines among FMAs."""
    out = ["\tcode for sm_90a"]
    for key, n in mma.items():
        kernel, d = re.fullmatch(r"(\w+_(?:bf16|fp32))(\d+)", key).groups()
        out.append(f"\t\tFunction : _ZN45_GLOBAL__N__0_12_flash_bwd_cu_0"
                   f"{len(kernel)}{kernel}ILi{d}EEEvNS_6ParamsE")
        out += ["        /*0a70*/   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;"
                ] * n
        out.append("        /*0100*/   FFMA R3, R4, R5, R3 ;")
    return "\n".join(out) + "\n"


def test_chip_smoke_counts_tensor_core_instructions_per_kernel():
    """chip_smoke.py reads the SASS of the flash backward: it must list
    the 8 instances, bf16 ones with tensor-core instructions and fp32
    (FMA) ones with none."""
    chip_smoke = _repo_module("chip_smoke")
    want = {f"flash_bwd_{k}_kernel_{dt}{d}": (2 if dt == "bf16" else 0)
            for k in ("dq", "dkv") for dt in ("bf16", "fp32")
            for d in (64, 128)}
    assert set(want) == chip_smoke.BWD_INSTANCES
    assert chip_smoke.sass_mma_counts(_sass(want)) == want
    no_mma = _sass(want).replace("HMMA.16816.F32.BF16", "FFMA")
    with pytest.raises(AssertionError, match="bf16 instances need some"):
        chip_smoke.sass_mma_counts(no_mma)
    missing = dict(want)
    del missing["flash_bwd_dkv_kernel_bf16128"]
    with pytest.raises(AssertionError, match="not the instances"):
        chip_smoke.sass_mma_counts(_sass(missing))
    with pytest.raises(AssertionError, match="listed no flash_bwd kernel"):
        chip_smoke.sass_mma_counts("")


def test_chip_smoke_counts_tensor_core_instructions_in_the_forward():
    """The same SASS check on the flash forward's library: exactly the 4
    instances, the bf16 ones with tensor-core instructions and the fp32
    (FMA) ones with none; the backward's instances do not count there."""
    chip_smoke = _repo_module("chip_smoke")
    want = {f"flash_fwd_kernel_{dt}{d}": (3 if dt == "bf16" else 0)
            for dt in ("bf16", "fp32") for d in (64, 128)}
    assert set(want) == chip_smoke.FWD_INSTANCES
    fwd = chip_smoke.FWD_INSTANCES
    both = _sass({**want, "flash_bwd_dq_kernel_bf1664": 2})
    assert chip_smoke.sass_mma_counts(both, fwd) == want
    missing = dict(want)
    del missing["flash_fwd_kernel_bf16128"]
    with pytest.raises(AssertionError, match="not the instances"):
        chip_smoke.sass_mma_counts(_sass(missing), fwd)
    no_mma = dict(want, flash_fwd_kernel_bf1664=0)
    with pytest.raises(AssertionError, match="bf16 instances need some"):
        chip_smoke.sass_mma_counts(_sass(no_mma), fwd)
    fp32_mma = dict(want, flash_fwd_kernel_fp32128=1)
    with pytest.raises(AssertionError,
                       match="fp32128: 1 tensor-core instructions"):
        chip_smoke.sass_mma_counts(_sass(fp32_mma), fwd)
    with pytest.raises(AssertionError, match="listed no flash_fwd kernel"):
        chip_smoke.sass_mma_counts(_sass({"flash_bwd_dq_kernel_bf1664": 2}),
                                   fwd)
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
    matches flash_fwd.cu exactly once, and each control changes it."""
    study = _repo_module("flash_bwd_study")
    from tony_tpu_torch import kernels

    text = (kernels.CSRC / "flash_fwd.cu").read_text()
    for name, subs in {**study.fwd_sweep_variants(),
                       **study.FWD_CONTROLS}.items():
        changed = study.substitute(text, name, subs, "flash_fwd.cu")
        if name in study.FWD_CONTROLS:
            assert changed != text, name
    m128 = study.substitute(text, "m128_n32",
                            study.fwd_sweep_variants()["m128_n32"],
                            "flash_fwd.cu")
    assert "static constexpr int kM = 128;" in m128
    assert "static constexpr int kN = 32;" in m128
    with pytest.raises(ValueError, match="occurs 0 times in flash_fwd.cu"):
        study.substitute(text, "bad", [("no such line", "")], "flash_fwd.cu")


def test_flash_bwd_study_variants_apply_to_the_source():
    """Every substitution of flash_bwd_study.py (tile sweep and fault
    controls) matches flash_bwd.cu exactly once, so the study builds what
    it says it builds."""
    study = _repo_module("flash_bwd_study")
    from tony_tpu_torch import kernels

    text = (kernels.CSRC / "flash_bwd.cu").read_text()
    variants = {**study.sweep_variants(), **study.CONTROLS}
    for name, subs in variants.items():
        changed = study.substitute(text, name, subs)
        assert (changed == text) == (name == "shipped"), name
    assert "static constexpr int kN = 64;" in study.substitute(
        text, "tiles64", study.sweep_variants()["tiles64"])
    with pytest.raises(ValueError, match="occurs 0 times"):
        study.substitute(text, "bad", [("no such line", "")])
