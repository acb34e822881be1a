"""pytest settings of the benchmark's own tests (python -m pytest portbench/tests):
the `card` marker, and the checkout's root on sys.path so that `portbench`
imports. Whether a card is present is decided inside the `card` fixture,
never while a module is imported."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (an H100); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the benchmark on the card")
    return torch.device("cuda", torch.cuda.current_device())
