"""torch's intra-op threads divided among pytest-xdist's workers.

torch starts one intra-op thread per core in every process. Under
pytest-xdist every worker does so, the machine runs workers x cores
threads, and torch's OpenMP threads spin against each other: six
concurrent tiny train CLI runs on 8 cores took 65 s with the default
threads and 8.9 s with one thread each. The port's test modules import
this module; every xdist worker collects every test module, so each
worker gets its share of the cores. Outside xdist nothing changes.
"""

import os

import torch


def divide_cores() -> None:
    """Give this xdist worker its share of the cores for torch's ops."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))


divide_cores()
