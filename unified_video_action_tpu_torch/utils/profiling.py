"""Timing and tracing (the port's counterpart of ``utils/profiling.py``).

* :class:`Timer` times named blocks and keeps every reading, with the JAX
  package's statistics (count, mean, p50, p95, total). On a CUDA device each
  block is a pair of ``torch.cuda.Event`` records on the device's current
  stream, read once both have completed: the span of the stream's work
  between them, host gaps included where the stream waits on the host. On
  the CPU it is the host clock around the block. The caller names the
  device; no device is guessed and none is fallen back to.
* :func:`trace` records a region with ``torch.profiler`` (CPU and, where the
  device is CUDA, CUDA activity) and writes a Chrome trace.
* :func:`benchmark_fn` warms a function up, then times its calls.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Union

import numpy as np
import torch


class Timer:
    """Named block timings on ``device`` (``"cuda"``, ``"cuda:1"`` or
    ``"cpu"``): ``with timer.time("stage"): ...``, then :meth:`stats`."""

    def __init__(self, device: Union[str, torch.device]):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Timer on {self.device}: torch.cuda.is_available() is False "
                               "(pass device='cpu' to time on the host clock)")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"Timer times on a CUDA device or the CPU, not {self.device}")
        self.records: Dict[str, List[float]] = {}
        self._pending: List[tuple] = []

    @contextlib.contextmanager
    def time(self, name: str):
        if self.device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            stream = torch.cuda.current_stream(self.device)
            start.record(stream)
            yield
            end.record(stream)
            self._pending.append((name, start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def _collect(self) -> None:
        for name, start, end in self._pending:
            end.synchronize()
            self.records.setdefault(name, []).append(start.elapsed_time(end) / 1e3)
        self._pending = []

    def seconds(self, name: str) -> List[float]:
        """Every reading of ``name``, in seconds, in order."""
        self._collect()
        return list(self.records.get(name, []))

    def stats(self) -> Dict[str, Dict[str, float]]:
        self._collect()
        out = {}
        for name, xs in self.records.items():
            arr = np.asarray(xs)
            out[name] = {"count": len(arr), "mean_s": float(arr.mean()),
                         "p50_s": float(np.percentile(arr, 50)),
                         "p95_s": float(np.percentile(arr, 95)), "total_s": float(arr.sum())}
        return out

    def report(self) -> str:
        return "\n".join(
            f"{name:40s} n={s['count']:<5d} mean={s['mean_s'] * 1e3:8.2f}ms "
            f"p50={s['p50_s'] * 1e3:8.2f}ms p95={s['p95_s'] * 1e3:8.2f}ms"
            for name, s in sorted(self.stats().items()))


@contextlib.contextmanager
def trace(path: str, device: Union[str, torch.device]):
    """Profile the block with ``torch.profiler`` on ``device`` (CUDA
    activity too where it is a CUDA device) and write its Chrome trace to
    ``path``; yields the profiler."""
    device = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)


def benchmark_fn(fn: Callable, *args, device: Union[str, torch.device], warmup: int = 2,
                 iters: int = 10) -> Dict[str, float]:
    """``fn(*args)`` called ``warmup`` times, then ``iters`` times, each
    timed by a :class:`Timer` on ``device`` (which waits for the device's
    work). Returns mean, p50 and min seconds and ``iters``."""
    for _ in range(warmup):
        fn(*args)
    timer = Timer(device)
    for _ in range(iters):
        with timer.time("call"):
            fn(*args)
    arr = np.asarray(timer.seconds("call"))
    return {"mean_s": float(arr.mean()), "p50_s": float(np.percentile(arr, 50)),
            "min_s": float(arr.min()), "iters": iters}
