"""The benchmark's CPU tests: no card, no ``nvcc``, no ``triton``.  A test
that needs the card carries the ``cuda`` marker and skips in its fixture
where there is none."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped where "
        "torch.cuda.is_available() is False)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")
