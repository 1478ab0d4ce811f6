"""torch's intra-op threads for the port's test modules.

Under pytest-xdist every worker runs its own torch, and torch's default
is one OpenMP thread per core: six workers on eight cores then run 48
spinning threads beside XLA's own pools.  On an 8-core box the whole
tier-1 run (6 workers, ``--dist loadfile``) took 417 s with this cap;
without it, the same tree ran into its 1,470 s time limit at 97% of
the tests.  A module imports the autouse fixture
``torch_worker_threads`` to hold torch to ``THREADS`` while its tests
run, under xdist only::

    from torch_port_threads import torch_worker_threads  # noqa: F401
"""

from __future__ import annotations

import os

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_worker_threads():
    before = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)
