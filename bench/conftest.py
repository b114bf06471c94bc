"""The benchmark's CPU tests run one intra-op thread per test process: the
repo's test run starts several processes side by side, and the tiny cells'
windows must still hold tens of finished requests."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
