"""Tests of the benchmark harness: CPU tests, and tests marked ``card`` that need a CUDA card.

A ``card`` test asks for the ``card`` fixture, which skips it where torch
sees no CUDA device; whether there is one is decided there, when the test
runs, never while a module is imported. On the chip:

    python3 -m pytest perfbench/tests -m card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: a test that runs only where torch sees a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")
