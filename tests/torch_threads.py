"""One torch intra-op thread for each port test module.

The parity tests run at sf0.01, where a batch is too small for torch's
intra-op threads to pay off, and the suite runs in several worker
processes on the same cores: each worker's OpenMP threads, spinning
after every parallel region, took the cores from the other workers: on
eight cores, six workers ran the port's tests in about five times the
wall they take with one thread each.  A module imports the fixture to
use it:

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
