"""The benchmark's tests: on the CPU, and (marked `cuda`) on the card.

    python -m pytest perfbench/tests -q            # CPU
    python -m pytest perfbench/tests -q -m cuda    # on the H100

Whether a card is there is decided inside the `cuda_device` fixture, never
while a module is imported.
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips where torch.cuda.is_available() is False)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
