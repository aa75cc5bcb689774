"""Fixtures of the PyTorch port's tests (``tests/port/test_torch_*.py``).

The parent ``tests/conftest.py`` already puts JAX on the CPU with float64
enabled.  Tests that need a CUDA card carry the ``cuda`` marker and take the
``cuda_device`` fixture, which skips them where there is no card; whether
there is one is decided here, when the test runs, never at import.
"""

import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU: python3 chip_smoke.py)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def scan_dir():
    """The in-repo example scans (ex_data/scan{1,2,3})."""
    return os.path.join(REPO, "ex_data")
