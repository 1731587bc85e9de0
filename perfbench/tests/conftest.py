"""The benchmark's own tests (``python -m pytest perfbench/tests -q`` from
the repo root). Tests marked ``chip`` need a CUDA card; the ``cuda_card``
fixture skips them where there is none, deciding at run time."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the card")
    return torch.device("cuda", 0)
