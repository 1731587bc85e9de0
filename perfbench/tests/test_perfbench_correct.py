"""The comparison that decides ``correct`` fails what it must, at a size a
test run holds: the harness's look for a card skipped, the rest of a run
driven on the CPU with the timed path broken underneath.

The limits of the tiny cells (``data/limits``) were set as the cells'
were: from the program's readings over 14 seeds and the fp8 control's
over 4 (dense: loss 2.70e-4, grad 8.67e-4, change 1.71e-3 at most against
the control's least 8.09e-4, 6.74e-3, 2.90e-3). At this size the MoE
cell's routing flips under bf16 read as much as the control does, so the
control is held on the dense cell."""

import time

import pytest
import torch

from perfbench.lib import cell as cell_lib, cli, faults
from perfbench.lib.shape import Shape
from perfbench.tests.helpers import SEED, TINY, tiny_cell


def _run(workload, seed=SEED):
    return cell_lib.run(tiny_cell(workload), seed, 0.2, False,
                        started=time.perf_counter(), device="cpu")


@pytest.mark.parametrize("workload", TINY)
def test_the_program_is_correct(workload, capsys):
    result, checks = _run(workload)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_tokens_per_s", "peak_mem_gib",
                                      "setup_s"}
    assert cli.emit(result, checks) == 0
    out, err = capsys.readouterr()
    last = __import__("json").loads(out.strip().splitlines()[-1])
    assert list(last)[-1] == "checks"
    assert err.strip().splitlines()[-1] == "correct True"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", TINY)
def test_a_planted_fault_is_not_correct(workload, fault):
    with faults.FAULTS[fault]():
        result, checks = _run(workload)
    assert not result["correct"], (fault, checks)


def test_the_control_is_not_correct(monkeypatch):
    """The reference one precision below the configuration's (fp8 for
    bfloat16) in the program's place."""
    real = cell_lib.set_up

    def control(s: Shape, tr, steps, seed, dev, torch_):
        prog = real(s, tr, steps, seed, dev, torch_)
        prog.readings = cell_lib.reference_readings(s, tr, steps, seed, dev,
                                                    "fp8")
        return prog

    monkeypatch.setattr(cell_lib, "set_up", control)
    result, checks = _run("tiny-dense-train")
    assert not result["correct"], checks
    assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]


def test_a_traced_run_reports_its_layers():
    # A window of several steps: the step anatomy reads from the second.
    result, _ = cell_lib.run(tiny_cell("tiny-moe-train"), SEED, 1.0, True,
                             started=time.perf_counter(), device="cpu")
    assert result["attempted"] >= 2
    # No device events on the CPU: only the step anatomy's metrics.
    assert set(result["metrics"]) == {"data_wait_ms", "host_dispatch_ms"}
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert torch.isfinite(torch.tensor(result["device"]["window_s"]))


def test_half_a_single_row_is_half_its_positions(monkeypatch):
    """The 32k cell feeds one row: there the fault keeps the first half of
    its positions."""
    from tony_tpu_torch.models import train

    seen = []
    monkeypatch.setattr(train, "lm_loss",
                        lambda params, tokens, *a, **k:
                        seen.append(tuple(tokens.shape)))
    with faults.half_batch():
        train.lm_loss(None, torch.zeros(1, 33))
        train.lm_loss(None, torch.zeros(4, 33))
    assert seen == [(1, 17), (2, 33)]
