"""The benchmark's tests: on the CPU at small sizes, and (marked ``card``)
on a CUDA card, where the cells' checks run at the cells' own sizes."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _workers > 1:   # one share of the cores per worker
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
