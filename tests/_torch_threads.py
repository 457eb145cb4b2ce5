"""One fixture for the PyTorch port's test modules: torch's intra-op threads
held to ``TORCH_THREADS`` while the module runs.

The tests run in several worker processes at once (xdist), and torch starts
one OpenMP thread per core in each. Six workers on eight cores then spin
about 48 threads against each other: the port's test files took 232 s and
29 CPU-minutes with six workers, against 77 s and 6 CPU-minutes at two
threads a worker (same tests, same results). The count is restored when the
module ends, so other test modules in the same worker are not affected.
"""

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(TORCH_THREADS, before))
    yield
    torch.set_num_threads(before)
