"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests -q``).

Tests that need a CUDA card carry the ``cuda`` marker and take the
``cuda_device`` fixture, which skips them where there is none; whether there
is one is decided when the test runs, never at import.
"""

import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU: python -m pytest benchmark/tests -q)")
    return "cuda"


@pytest.fixture(scope="session")
def root():
    return ROOT
