"""The benchmark's tests: run on the CPU with ``python -m pytest
portbench/tests -q``; those marked ``card`` need the NVIDIA card and skip
without one (run them on the card's machine with ``-m card``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The card, decided when a test runs: skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card; this machine has none")
    return torch.device("cuda", 0)
