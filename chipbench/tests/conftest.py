"""The ``chip`` marker: a test that needs a CUDA card; it decides inside
the test whether one is there and skips with its reason here.  Run the
marked tests on the card with

    python -m pytest -m chip chipbench/tests
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread per test module: the suite runs in
    parallel workers, and a thread per core in each oversubscribes the
    CPU.  The previous count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
