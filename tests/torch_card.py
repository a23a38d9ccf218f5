"""The card fixture of the PyTorch port's tests.

A test that takes ``cuda_device`` (and carries the ``gpu`` marker) runs on
a CUDA card and skips without one: the hand-written kernels have no CPU
mode.  Whether a card is present is decided here, when the test runs,
never while a test module is imported.
"""

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)
