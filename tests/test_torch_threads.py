"""The port's tests share the host's cores between pytest-xdist workers.

PyTorch's intra-op pool defaults to every core, in every worker: six
workers of eight threads each on an eight-core host make its OpenMP
threads spin against each other, and a test that takes 9 s alone took
454 s in a six-worker run. Under xdist each worker therefore takes its
share of the cores, ``cpu_count // workers`` (at least one), when this
module is imported: every worker imports every test module while it
collects, before any test runs, so the share holds for all of them.
Outside xdist nothing changes.

The share changes no result a test holds: the port's equivalence tests
compare with tolerances, and its bitwise tests compare two runs of one
process, which see the same thread count.
"""

import os

import torch


def worker_share() -> int | None:
    """Intra-op threads for this xdist worker, or None outside xdist."""
    n = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not n:
        return None
    return max(1, (os.cpu_count() or 1) // int(n))


_SHARE = worker_share()
if _SHARE is not None:
    torch.set_num_threads(_SHARE)


def test_xdist_workers_share_the_cores():
    if _SHARE is None:
        assert "PYTEST_XDIST_WORKER" not in os.environ
    else:
        assert torch.get_num_threads() == _SHARE
