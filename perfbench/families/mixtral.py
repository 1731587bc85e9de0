"""Mixtral's configurations (``model_type`` "mixtral"): the Mistral family
under Mixtral's name. Its expert layer is read from the same file's
``num_local_experts``; see ``mistral.py``."""

from perfbench.families.mistral import *  # noqa: F401,F403
from perfbench.families.mistral import __all__  # noqa: F401
