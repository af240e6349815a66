"""The port tests' share of the CPU under pytest-xdist.

Tier-1 runs the tests in six xdist workers on one machine, and PyTorch's
CPU kernels start one OpenMP thread per core in every worker: six
workers on eight cores then run 48 spinning threads, and a test whose ops
are small waits on descheduled threads at every parallel region (a 0.2 s
test took 375 s in such a run). Each port test module calls
`share_cores()` when it is imported, which gives every xdist worker its
share of the cores (at least one thread); run without xdist, PyTorch
keeps its default.
"""

import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
