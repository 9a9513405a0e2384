"""One intra-op thread for each of the port's test modules.

The tier-1 run's six workers share eight cores, and a full thread pool in
each of them starves them all: PyTorch's CPU kernels wait for their slowest
thread, and XLA's pool in the JAX workers wants the same cores. Every
`tests/test_torch_*.py` module imports `few_threads`, an autouse fixture
that sets one thread for the module and restores the count after it.
"""

import pytest
import torch

THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield THREADS
    torch.set_num_threads(n)
