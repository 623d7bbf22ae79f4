"""The benchmark's own tests: CPU rehearsals at a tiny width, and tests
marked ``gpu`` that need a CUDA device and skip without one (run them on
a card with ``python -m pytest benchmark/tests -m gpu``)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
