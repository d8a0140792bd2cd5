"""One share of the cores for the port's CPU tests.

The CPU build of torch runs each parallel region on an OpenMP team as wide
as the machine.  Under ``pytest -n N`` every worker does so at once, and the
teams' spinning threads then wait on each other: a smoke-size train CLI run
of 1.4 s alone took minutes beside five other workers.  A test module that
imports ``torch_threads`` runs with ``cores // workers`` threads (all the
cores when one process runs the tests) and restores the count after.
"""
import os

import pytest
import torch


def threads_per_worker() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // max(workers, 1))


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(threads_per_worker())
    yield
    torch.set_num_threads(before)
