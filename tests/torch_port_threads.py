"""A fixture for the port's test modules (`tests/test_torch_*.py`): under
pytest-xdist, torch's intra-op threads are cut to the cores per worker for
the module's tests, so that the workers do not each spread over every core.
Alone (no workers) torch keeps its default."""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers <= 1:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
