"""The fault "unchanged" patches the optimizer the program holds, so it
holds for an optimizer with a ``step`` of its own, not only for
``torch.optim.AdamW``'s."""

import time
from unittest import mock

import torch

from perfbench.lib import cell as cell_lib, faults
from perfbench.tests.helpers import SEED, tiny_cell


class OwnStep(torch.optim.AdamW):
    step = torch.optim.AdamW.step  # an attribute of its own class


def test_an_optimizer_with_its_own_step_is_left_unchanged():
    from tony_tpu_torch import models

    real = models.make_train_step

    def make_train_step(*args, **kwargs):
        init_fn, step_fn = real(*args, **kwargs)

        def init(*a, **kw):
            state = init_fn(*a, **kw)
            state.opt_state.__class__ = OwnStep
            return state

        return init, step_fn

    own = OwnStep.__dict__["step"]
    with mock.patch.object(models, "make_train_step", make_train_step):
        sound, _ = cell_lib.run(tiny_cell("tiny-dense-train"), SEED, 0.2,
                                False, started=time.perf_counter(),
                                device="cpu")
        with faults.unchanged():
            result, checks = cell_lib.run(
                tiny_cell("tiny-dense-train"), SEED, 0.2, False,
                started=time.perf_counter(), device="cpu")
    assert sound["correct"]
    assert not result["correct"], checks
    assert checks["change_gap"]["value"] == 1.0
    assert OwnStep.__dict__["step"] is own  # restored on leaving
