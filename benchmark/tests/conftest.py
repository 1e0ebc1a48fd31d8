"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository's root. The tests marked ``gpu`` need a CUDA card; whether there
is one is decided inside the ``card`` fixture, never at import."""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
