"""Tests of the benchmark harness (from the repository's root: ``python -m
pytest ovbench/tests -q``).  Those marked ``cuda`` (the marker pytest.ini
registers) need the card and skip without one; they decide in a fixture,
never at import."""

import pytest


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
