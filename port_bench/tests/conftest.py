"""The benchmark's tests. Run them from the root of the checkout:

    python -m pytest port_bench/tests -q

Tests marked ``card`` need a CUDA card and skip without one: the
``card`` fixture decides, never an import.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs need one")
    return torch.device("cuda")
