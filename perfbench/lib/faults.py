"""Faults planted under the timed path, for the check that the comparison
deciding ``correct`` catches them (the control script on the card and
the CPU test): each is a context manager that patches the program."""

from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def unchanged():
    """Every step returns its state unchanged: AdamW's step does nothing."""
    import torch

    with mock.patch.object(torch.optim.AdamW, "step",
                           lambda self, closure=None: None):
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
