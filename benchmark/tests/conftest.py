"""Tests of the benchmark, on the CPU at small sizes, run from the root of
the checkout: ``python -m pytest benchmark/tests -q``. Tests that need the
card carry the ``card`` marker and skip, from a fixture, where there is
none."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
