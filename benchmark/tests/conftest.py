"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository's root. Tests marked ``cuda`` need an NVIDIA card and skip
without one; run them on the card with
``python -m pytest benchmark/tests -m cuda``."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, BENCH, os.path.dirname(BENCH)) if p not in sys.path]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
