"""The card fixture of the PyTorch port's tests, and the one-thread
fixture of its heavy CPU modules.

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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's PyTorch CPU ops on one thread: the test workers
    share the machine's cores, and idle intra-op threads of six
    processes spin against each other.  Autouse in the modules that
    import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
