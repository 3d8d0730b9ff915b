"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository.  Tests that need a CUDA card are marked ``gpu`` and
skip without one, decided inside the ``card`` fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs the program's CUDA kernels")
    return torch.device("cuda")
