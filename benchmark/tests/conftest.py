"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the repo root (CPU; the `cuda` ones skip there), and on a card
`python -m pytest benchmark/tests -q -m cuda -s`. Nothing here imports
JAX; whether a card is present is decided inside fixtures."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")
