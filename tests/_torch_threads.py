"""The torch thread cap of the port's test processes.

Under pytest-xdist every worker's torch would take one intra-op thread a
core, and the workers' busy-waiting thread pools then starve one another:
a test of a fraction of a second alone can take minutes beside five
others. Under xdist (``PYTEST_XDIST_WORKER_COUNT`` set) each process takes
its share of the cores, ``cpu_count // workers``, at least one; outside
xdist nothing changes. ``tests/_torch_port_common.py`` applies it when a
test module imports it at collection, and the port's child processes
(ranks and workers, which inherit the variable) at their start, so a
parent and its ranks reduce alike. Imports no JAX.
"""

from __future__ import annotations

import os


def cap_torch_threads() -> None:
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
