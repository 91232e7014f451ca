"""Caps torch's intra-op threads in a test process to its share of the
cores it may run on.

Every `tests/test_torch_*.py` module imports this.  Under pytest-xdist
each of N worker processes would otherwise start as many intra-op threads
as there are cores, N times over: with six workers on eight cores the
torch-heavy modules spent most of their time in threads waiting on each
other.  A process outside xdist (N = 1) keeps every core.
"""

import os

import torch


def share() -> int:
    """This process's share of the cores: the cores it may run on over
    the xdist workers (PYTEST_XDIST_WORKER_COUNT), at least 1."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:
        cores = os.cpu_count() or 1
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // max(1, workers))


torch.set_num_threads(share())
