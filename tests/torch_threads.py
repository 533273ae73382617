"""One torch intra-op thread for the port's CPU tests.

The suite runs in parallel workers, one per core or near it; a thread per
core in every worker oversubscribes the CPU and makes the small models
several times slower.  A test module takes the fixture with

    from torch_threads import one_thread  # noqa: F401  (autouse fixture)

It is module-scoped and restores the thread count afterwards, so the
reference's tests, imported into the same worker, keep the default.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
