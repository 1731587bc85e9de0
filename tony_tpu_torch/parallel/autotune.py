"""The serving engine's KV storage modes: the port's copy of the names it
uses from the JAX package's ``parallel/autotune.py`` (the ``tony.tune.*``
knobs). Only the KV-cache quantization axis is here for now."""

from __future__ import annotations

import os

from tony_tpu_torch import constants

# KV-cache quantization modes the serving engine accepts
# (tony.tune.kv-quant / TONY_TUNE_KV_QUANT).
KV_QUANT_MODES = ("none", "int8")


def default_kv_quant() -> str:
    """The serving engine's KV storage mode when the caller passes none
    (``tony.tune.kv-quant``). Unknown values degrade to ``none``: a typo in
    the conf must not crash a serving fleet at engine construction."""
    mode = (os.environ.get(constants.TONY_TUNE_KV_QUANT, "")
            or "none").strip().lower()
    return mode if mode in KV_QUANT_MODES else "none"
