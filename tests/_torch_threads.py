"""Torch's intra-op thread count in a test process, shared by the port's
tests (tests/test_torch_*.py import this module, most through
tests/_torch_parity.py).

Torch starts as many intra-op threads as the machine has cores in every
process. Under pytest-xdist's N workers that is N times the cores, and the
threads spin against each other: on an 8-core host, a (64, 144, 768) GEMM
loop that takes 6.4 s alone took 53 s in each of six processes at once, and
30 s with one thread each. So each worker takes its share of the cores, at
least one; a process that is not an xdist worker keeps them all. Imports
only torch, so that the card's test files (run there without JAX) can
import it too.
"""

from __future__ import annotations

import os

import torch


def worker_threads() -> int:
    """The cores of this machine over the number of xdist workers (the
    ``PYTEST_XDIST_WORKER_COUNT`` that xdist sets in each worker), at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    return max(1, (os.cpu_count() or 1) // max(workers, 1))


torch.set_num_threads(worker_threads())
