"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
repository's root. Tests marked ``cuda`` run the cells on the card and skip
without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the cell on the card")
    return torch.device("cuda")
