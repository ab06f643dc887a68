"""The port's CPU tests run PyTorch on one intra-op thread.

Their tensors are small and their host loops issue many operations one
after another.  Beside the other test workers (and their gloo ranks and
reference subprocesses) on a loaded machine, each operation spread over
every core waits for its slowest thread at the end of its parallel
region, which the scheduler may not run for a time slice: one hot-cell
case of tests/test_torch_replay_emulated.py took 105 s so beside 8
busy processes, and 2 s on one thread.  Each test_torch_*.py file takes
the fixture by importing it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's tests on one intra-op thread (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
