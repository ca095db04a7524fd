"""Tests of the benchmark harness. They run on the CPU at small sizes;
tests marked ``cuda`` need the card and skip without one (run them there
with ``python -m pytest -m cuda h100bench/tests``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
