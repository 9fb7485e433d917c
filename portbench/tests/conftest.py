"""The benchmark's CPU tests run tiny models: one intra-op thread each,
so that several test workers on one host do not contend for its cores.
The previous setting comes back after every test."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
