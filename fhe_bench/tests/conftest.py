"""Tests of the benchmark.  Run from the repository root:

    python -m pytest fhe_bench/tests -q

Tests marked ``card`` need a CUDA card and skip without one; the fixture
``card`` decides, never an import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size only there")
    return "cuda"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The MICRO runs are loops of small torch ops: one thread per worker."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
