"""The reference against the port at tiny widths on the CPU, and what the
benchmark's processes load."""

import subprocess
import sys

import pytest
import torch

from perfbench.lib import cell as cell_lib, compare, spec, weights
from perfbench.lib.shape import Shape
from perfbench.tests.helpers import SEED, TINY, tiny_cell


@pytest.mark.parametrize("workload", TINY)
def test_port_and_reference_agree_in_fp32(workload):
    """The port's train step (CPU path, fp32) and the reference take the
    same three steps: each step's loss, the first clipped gradient's norm
    a leaf and each leaf's change, to fp32 reordering."""
    cell = tiny_cell(workload, dtype="float32")
    s = Shape.from_config(cell.config)
    dev = torch.device("cpu")
    steps = cell.limits["check_steps"]
    prog = cell_lib.set_up(s, cell.traffic, steps, SEED, dev, torch)
    prog.close(torch)
    ref = cell_lib.reference_readings(s, cell.traffic, steps, SEED, dev)
    found = compare.gaps(prog.readings, ref)
    assert found["loss_gap"][0] < 1e-6, found
    assert found["grad_gap"][0] < 1e-4, found
    assert found["change_gap"][0] < 1e-4, found
    assert len(ref["grad"]) == len(weights.leaf_table(s))


def test_a_piece_draws_again_alike():
    s = Shape.from_config(tiny_cell("tiny-moe-train").config)
    tree = weights.draw(s, SEED, "cpu")
    again = weights.draw_leaf(s, SEED, "layers.w_up", "cpu")
    assert torch.equal(tree["layers"]["w_up"], again)
    assert not torch.equal(tree["layers"]["w_up"][0, 0],
                           tree["layers"]["w_up"][0, 1])
    assert all(float(v) == 0.0
               for v in weights.change_norms(s, SEED, tree).values())


_LOADS = """
import json, sys, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(body: str) -> set:
    code = _LOADS.format(root=str(spec.ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    return set(__import__("json").loads(out.strip().splitlines()[-1]))


BANNED = {"jax", "jaxlib", "flax", "tony_tpu"}


def test_the_reference_loads_neither_jax_nor_the_port():
    loaded = _loaded("import perfbench.reference.model, "
                     "perfbench.lib.compare, perfbench.lib.counts, "
                     "perfbench.lib.feed")
    assert not loaded & (BANNED | {"tony_tpu_torch"}), loaded


def test_a_run_loads_no_jax():
    """A whole run of a tiny cell on the CPU, the harness's look for a
    card skipped: compared by whole top-level names (``tony_tpu_torch``
    is loaded, ``tony_tpu`` must not be)."""
    loaded = _loaded(
        "from perfbench.tests.helpers import tiny_cell\n"
        "from perfbench.lib import cell\n"
        "res, _ = cell.run(tiny_cell('tiny-moe-train'), 7, 0.2, True, "
        "started=time.perf_counter(), device='cpu')\n"
        "assert res['correct'], res\n"
        "assert not cell.loaded_jax()")
    assert "tony_tpu_torch" in loaded
    assert not loaded & BANNED, loaded & BANNED
