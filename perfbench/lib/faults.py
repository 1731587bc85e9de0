"""Faults planted under the timed path, for the check that the comparison
deciding ``correct`` catches them (the control script on the card and
the CPU test): each is a context manager that patches the program."""

from __future__ import annotations

import contextlib
from unittest import mock


def _nothing(*args, **kwargs):
    return None


@contextlib.contextmanager
def unchanged():
    """Every step returns its state unchanged: the step of the optimizer
    the program holds does nothing. The state does not exist yet when the
    fault is entered, so ``make_train_step``'s ``init_fn`` is wrapped:
    once it has built the state, ``step`` of ``state.opt_state``'s class
    is patched, until the fault is left."""
    from tony_tpu_torch import models

    real = models.make_train_step
    with contextlib.ExitStack() as patches:
        def make_train_step(*args, **kwargs):
            init_fn, step_fn = real(*args, **kwargs)

            def init(*a, **kw):
                state = init_fn(*a, **kw)
                patches.enter_context(mock.patch.object(
                    type(state.opt_state), "step", _nothing))
                return state

            return init, step_fn

        patches.enter_context(
            mock.patch.object(models, "make_train_step", make_train_step))
        yield


@contextlib.contextmanager
def half_batch():
    """Half of the batch left out: the loss is the mean over the first
    half of the rows, or of a single row's positions."""
    from tony_tpu_torch.models import train

    real = train.lm_loss

    def lm_loss(params, tokens, *args, **kwargs):
        rows, cols = tokens.shape
        if rows > 1:
            return real(params, tokens[: rows // 2], *args, **kwargs)
        return real(params, tokens[:, : (cols - 1) // 2 + 1], *args,
                    **kwargs)

    with mock.patch.object(train, "lm_loss", lm_loss):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
