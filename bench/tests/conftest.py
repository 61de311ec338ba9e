"""The benchmark's CPU tests run their tiny cells on one thread: beside the
other test workers, a process that spreads tiny operations over every core
waits on its own threads for most of its time."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)
