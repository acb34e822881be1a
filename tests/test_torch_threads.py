"""One torch thread per core share under pytest-xdist.

Each xdist worker collects every test module before it runs a test, so
importing this module sets the torch intra-op thread count of every worker
to its share of the cores: max(1, os.cpu_count() // n) for n workers. At
torch's default (one thread per core in each worker) n workers oversubscribe
the cores n times over, which multiplied the port's CPU tests' times many
times over. Outside xdist the count stays as it is.
"""

import os

try:
    import torch
except ImportError:  # the JAX package's tests run without torch
    torch = None

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if torch is not None and _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(_WORKERS)))


def test_torch_threads_per_xdist_worker():
    if torch is None:
        return
    if _WORKERS:
        assert torch.get_num_threads() == max(1, (os.cpu_count() or 1) // int(_WORKERS))
    else:
        assert torch.get_num_threads() >= 1
