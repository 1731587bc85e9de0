"""The port's generate CLI (``python -m tony_tpu_torch.generate``) on the CPU.

It restores a checkpoint the port's train CLI wrote and prints the same
``generated[i]`` lines as the JAX package's ``examples/lm_generate.py`` on
that checkpoint (the two packages' checkpoints cross-restore): greedy,
fp32, ragged prompts left-padded with 0. Through the orchestrator two
workers take the job mesh with no spec (tp 2) and print the one process's
tokens on both ranks."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tony_tpu_torch import generate as gen_cli
from tony_tpu_torch import train as train_cli

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# Two heads and two K/V heads: the model splits over tp 2.
MODEL = ["--d-model", "32", "--n-layers", "2", "--n-heads", "2",
         "--n-kv-heads", "2", "--vocab", "64"]
PROMPT = "1,5,9,2:7,2:3,8,8,1,4"
GEN = ["--prompt", PROMPT, "--max-new", "8", *MODEL]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory) -> Path:
    """A checkpoint of 4 steps of the port's train CLI (synthetic corpus)."""
    path = tmp_path_factory.mktemp("gen") / "ck"
    assert train_cli.main(["--device", "cpu", "--steps", "4", "--batch",
                           "4", "--seq", "32", "--checkpoint-every", "2",
                           "--ckpt-dir", str(path), *MODEL]) == 0
    return path


def _generated(out: str) -> list[str]:
    return re.findall(r"^generated\[\d+\]: .*$", out, re.M)


def _port_lines(ckpt: Path, capsys, *extra) -> list[str]:
    capsys.readouterr()
    assert gen_cli.main(["--device", "cpu", "--ckpt", str(ckpt), *GEN,
                         *extra]) == 0
    out = capsys.readouterr().out
    assert "restored step 4 from" in out
    return _generated(out)


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "CLUSTER_SPEC")}
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_cli_prints_jax_lm_generate_lines(ckpt, capsys):
    """Greedy fp32 on the same checkpoint: the port's lines equal JAX's
    examples/lm_generate.py's (run as its own process, one CPU device),
    token for token, ragged rows included."""
    got = _port_lines(ckpt, capsys)
    assert len(got) == 3
    assert all(len(line.split(": ")[1].split(",")) == 8 for line in got)
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "lm_generate.py"),
         "--ckpt", str(ckpt), *GEN],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "restored step 4 from" in proc.stdout
    assert _generated(proc.stdout) == got


def test_prompt_rows_left_pad_with_zero():
    rows = gen_cli.prompt_rows("1,5,9:7, 2:3")
    assert rows.tolist() == [[1, 5, 9], [0, 7, 2], [0, 0, 3]]


def test_sampling_is_seeded(ckpt, capsys):
    """--temperature with --top-k draws from a generator seeded by --seed:
    two runs print the same lines, another seed other ones."""
    flags = ["--temperature", "1.0", "--top-k", "8"]
    first = _port_lines(ckpt, capsys, *flags, "--seed", "3")
    assert _port_lines(ckpt, capsys, *flags, "--seed", "3") == first
    assert _port_lines(ckpt, capsys, *flags, "--seed", "4") != first


def test_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    assert gen_cli.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gen_cli.main(["--max-new", "1"])


def test_exits_2_without_a_complete_checkpoint(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert gen_cli.main(["--device", "cpu", "--ckpt", str(empty),
                         *GEN]) == 2
    assert "no complete checkpoint" in capsys.readouterr().err


def test_two_workers_take_the_job_mesh_at_tp2(ckpt, capsys, tmp_path):
    """Two workers through ``cli local --framework pytorch``: the job mesh
    has no spec, so it is tp 2; each rank restores its pieces, gathers the
    whole weights, serves through DecodeSession(mesh=) and prints every
    row. Both ranks print the one process's lines (task stdout goes to
    files named by rank through the task's bash -c)."""
    want = _port_lines(ckpt, capsys)
    params = " ".join(["--device", "cpu", "--ckpt", str(ckpt), *GEN,
                       f"> {tmp_path}/gen-$RANK.out"])
    proc = subprocess.run(
        [sys.executable, "-m", "tony_tpu.client.cli", "local",
         "--executes", str(REPO / "tony_tpu_torch" / "generate.py"),
         "--framework", "pytorch",
         "--python_binary_path", sys.executable,
         "--conf", "tony.worker.instances=2",
         "--conf", "tony.ps.instances=0",
         "--task_params", params],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    for rank in range(2):
        out = (tmp_path / f"gen-{rank}.out").read_text()
        assert f"process {rank}/2 on cpu, mesh MeshSpec(dp=1, pp=1, ep=1, " \
               f"sp=1, tp=2)" in out, out
        assert _generated(out) == want, out
