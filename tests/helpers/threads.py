"""A module fixture for CPU tests of small torch ops: one intra-op thread
while the module runs. The suite's workers share the machine's CPUs, and a
pool of torch threads a worker then waits on its slowest thread at every op
(a tiny net's train step took 20x its lone time in the full run)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
