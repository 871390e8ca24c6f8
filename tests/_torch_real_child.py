"""Targets of the processes that the port's tests spawn (the real-robot
tests' ring writers, the async vector env tests' env factories), kept apart
from the test modules so that a spawned child imports the port's
shared-memory binding or env modules and numpy only (not JAX); each pickles
by reference."""

import os
import time

import numpy as np


def write_records(ring, queue, n):
    """Put n records into ``ring`` and one into ``queue`` (both reopened by
    name in this child), then unmap them."""
    for i in range(n):
        ring.put({"pose": np.arange(6, dtype=np.float32) + i, "ts": float(i)})
    queue.put({"pose": np.arange(6, dtype=np.float32) + n, "ts": float(n)})
    ring.close()
    queue.close()


def raising_factory():
    raise ValueError("this factory raises")


class CountingEnv:
    """A tiny env whose step sleeps ``sleep_s`` once ``step`` reaches
    ``sleep_at`` (a child that hangs) or exits the process at ``exit_at``
    (a child that dies); it takes ``init_s`` seconds to build (a child slow
    to start)."""

    def __init__(self, sleep_at=None, sleep_s=0.0, exit_at=None, init_s=0.0):
        time.sleep(init_s)
        self.t, self.sleep_at, self.sleep_s, self.exit_at = 0, sleep_at, sleep_s, exit_at

    def reset(self):
        self.t = 0
        return np.zeros(2, np.float32)

    def step(self, action):
        self.t += 1
        if self.t == self.exit_at:
            os._exit(3)
        if self.t == self.sleep_at:
            time.sleep(self.sleep_s)
        return np.full(2, self.t, np.float32), float(self.t), False, {}

    def render(self):
        return np.zeros((2, 2, 3), np.uint8)

    def close(self):
        pass
