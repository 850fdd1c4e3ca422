"""Fixtures of the benchmark's own tests (``python -m pytest perfbench/tests``).

These tests import neither JAX nor the JAX package.  ``card`` decides
inside a fixture whether a CUDA device is there; tests marked ``cuda`` take
it and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control runs on the card")
    return torch.device("cuda")
