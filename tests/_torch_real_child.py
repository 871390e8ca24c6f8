"""Targets of the processes that the real-robot tests spawn, kept apart from
the test modules so that a spawned child imports the port's shared-memory
binding and numpy only (not JAX)."""

import numpy as np


def write_records(ring, queue, n):
    """Put n records into ``ring`` and one into ``queue`` (both reopened by
    name in this child), then unmap them."""
    for i in range(n):
        ring.put({"pose": np.arange(6, dtype=np.float32) + i, "ts": float(i)})
    queue.put({"pose": np.arange(6, dtype=np.float32) + n, "ts": float(n)})
    ring.close()
    queue.close()
