"""A family: the code of one architecture, everything of it that the
harness needs, in one module found by a configuration file's published
``model_type``: ``families/<model_type>.py`` (``spec.family``), as a
metric's name finds ``metrics/<name>.py``. The harness holds nothing of
an architecture outside its family; what it reads of a family's
``Shape`` are the fields every family has (``lib/shape.py``).

A family module gives what ``Family`` lists. It defines its shape as a
subclass of ``Shape`` in its own module (another family may re-export
it), so that ``of(s)`` finds the family of any shape it made.
"""

from __future__ import annotations

import sys
from types import ModuleType
from typing import Protocol

from perfbench.lib.shape import Shape

# Dotted leaf path -> (global shape, normal scale or 0 for ones, piece
# axes): 0 for an unstacked leaf, 1 for [L, ...], 2 for [L, E, ...].
LeafTable = dict[str, tuple[tuple[int, ...], float, int]]


class Family(Protocol):
    # The plain reference: ``train(s, seed, batches, device, *,
    # precision="fp32") -> {"loss": [...], "grad": {leaf: ...}, "change":
    # {leaf: ...}}``, and ``precision="fp8"`` for the control. It imports
    # neither JAX nor the port.
    reference: ModuleType

    def shape(self, config: dict) -> Shape:
        """The configuration file's numbers."""

    def port_config(self, s: Shape):
        """The port's model config; imports the port inside the call."""

    def leaf_table(self, s: Shape) -> LeafTable:
        """Every leaf of the port's parameter tree (paths may nest to any
        depth) with its initial scale and how it splits into pieces."""

    def model_flops(self, s: Shape, batch: int, seq: int) -> float:
        """One train step's model FLOPs, each product counted once."""

    def attention_least_s(self, s: Shape, batch: int, seq: int,
                          chip: dict) -> float:
        """The least time one step's attention kernels need on ``chip``
        (``counts.PEAKS``), for the work they compute."""

    def rms_norm_least_s(self, s: Shape, batch: int, seq: int,
                         chip: dict) -> float:
        """The least time one step's RMSNorm forwards need on ``chip``."""


MEMBERS = ("reference", "shape", "port_config", "leaf_table", "model_flops",
           "attention_least_s", "rms_norm_least_s")


def missing(module: ModuleType) -> list[str]:
    """The members of ``Family`` that ``module`` lacks."""
    return [m for m in MEMBERS if not hasattr(module, m)]


def of(s: Shape) -> Family:
    """The family that made ``s``: the module that defines its class."""
    module = sys.modules.get(type(s).__module__)
    if module is None or missing(module):
        raise TypeError(f"{type(s).__qualname__} is not defined in a family "
                        f"module")
    return module
