"""Tests of the benchmark harness. The card's tests carry the `cuda` marker and decide in a
fixture whether a card is there."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line('markers', 'cuda: needs a CUDA device; skips without one')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda:0')
