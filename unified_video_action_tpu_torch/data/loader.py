"""Host-side batching with background prefetch (the port's own copy of
``data/loader.py``, numpy only): batches of a dataset's items collated into
numpy arrays (string fields, such as the UMI items' ``dataset_name``, become
string arrays that stay on the host), shuffled per epoch by a generator
seeded with (seed, epoch), the last partial batch dropped by default, and
``set_epoch`` called on the dataset before each epoch.

The reference relies on torch DataLoader worker *processes* (14 for the UMI
multi-dataset path, reference config/task/umi_lazy.yaml:126-132) because its
per-item work — zarr chunk decode, pose math, augmentation — is CPU-heavy
Python. This loader supports both worker models:

- ``worker_mode="thread"``: a thread pool, at most ``num_workers +
  prefetch`` batches ahead of the consumer. Right when per-item work
  releases the GIL (hdf5 reads, large numpy slices) or the dataset is
  in-memory.
- ``worker_mode="process"``: worker processes with an index queue and
  ordered result reassembly (the torch model). Right for the UMI scale path
  where zarr decode + relative-pose math serialize on the GIL. The workers
  are spawned, not forked as JAX's are (a fork of a process with the CUDA
  runtime and threads is unsafe): each starts from a fresh import and
  receives the dataset pickled.

Device-side work (resize, normalize, VAE) stays in the train step, so
workers only produce numpy batches.
"""

from __future__ import annotations

import collections
import itertools
import multiprocessing as mp
import queue
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator

import numpy as np


def collate(items):
    if isinstance(items[0], dict):
        return {k: collate([it[k] for it in items]) for k in items[0]}
    return np.stack(items, axis=0)


def _process_worker(dataset, index_q, result_q):
    """Worker loop: batch indices in, (batch_id, collated batch) out.

    Exits via ``os._exit`` once the queue is flushed, and resets SIGTERM
    and SIGINT to their defaults first, so that ``Process.terminate()``
    always ends it (JAX's forked workers inherited the trainer's
    preemption handler and could not be terminated).
    """
    import os as _os
    import signal as _signal

    for _sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            _signal.signal(_sig, _signal.SIG_DFL)
        except (ValueError, OSError):
            pass

    rc = 0
    try:
        while True:
            job = index_q.get()
            if job is None:
                break
            batch_id, idxs = job
            try:
                batch = collate([dataset[int(i)] for i in idxs])
                result_q.put((batch_id, batch, None))
            except BaseException:
                result_q.put((batch_id, None, traceback.format_exc()))
                rc = 1
                break
    finally:
        result_q.close()
        result_q.join_thread()  # flush queue buffers before hard exit
        _os._exit(rc)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        worker_mode: str = "thread",
    ):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', got {worker_mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.worker_mode = worker_mode
        self._epoch = 0
        self._seed = seed
        # Cooperative shutdown: when set (e.g. by a SIGTERM preemption
        # handler), iterators stop waiting on worker results and exit at
        # the next poll window instead of blocking indefinitely — a stalled
        # data path must never outlive the preemption grace period.
        self.stop_event = threading.Event()

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self._seed, self._epoch))
            rng.shuffle(order)
        if hasattr(self.dataset, "set_epoch"):
            # refresh per-item augmentation rng (worker-count-independent)
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        return [
            order[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(len(self))
        ]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.worker_mode == "process":
            return self._iter_process()
        return self._iter_thread()

    # -- thread mode ---------------------------------------------------------

    def _iter_thread(self):
        batches = self._batches()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_batch(idxs):
            return collate([self.dataset[int(i)] for i in idxs])

        def producer():
            # at most num_workers + prefetch batches in flight: the threads
            # stop once the queue and the pool are full, and leave the GIL
            # to the consumer (JAX's loader submits the whole epoch at once,
            # and its threads compete with the train step's host work until
            # the epoch's last batch is built)
            def put(item) -> bool:  # False once the consumer has stopped
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            try:
                todo = iter(batches)
                pending = collections.deque(
                    pool.submit(load_batch, b)
                    for b in itertools.islice(todo, self.num_workers + self.prefetch))
                while pending and put(pending.popleft().result()):
                    nxt = next(todo, None)
                    if nxt is not None:
                        pending.append(pool.submit(load_batch, nxt))
            except BaseException as e:  # an item raised: the consumer raises it
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=5.0)
                except queue.Empty:
                    if self.stop_event.is_set():
                        return
                    continue
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)

    # -- process mode --------------------------------------------------------

    def _iter_process(self):
        batches = self._batches()
        ctx = mp.get_context("spawn")
        index_q = ctx.Queue()
        result_q = ctx.Queue()
        workers = [
            ctx.Process(
                target=_process_worker,
                args=(self.dataset, index_q, result_q),
                daemon=True,
            )
            for _ in range(min(self.num_workers, max(len(batches), 1)))
        ]
        for w in workers:
            w.start()

        # keep at most num_workers + prefetch jobs in flight, emit in order
        next_submit = 0
        next_emit = 0
        in_flight = 0
        pending: Dict[int, Any] = {}
        max_in_flight = len(workers) + self.prefetch
        try:
            while next_emit < len(batches):
                while next_submit < len(batches) and in_flight < max_in_flight:
                    index_q.put((next_submit, batches[next_submit]))
                    next_submit += 1
                    in_flight += 1
                if next_emit in pending:
                    yield pending.pop(next_emit)
                    next_emit += 1
                    continue
                # Bounded wait: a worker killed without posting a result
                # (segfault / OOM-kill in a child) must fail loudly,
                # not hang the training process forever. A dead worker alone
                # is not proof of a lost batch (it may have died idle while
                # the survivors are just slow) — require a sustained stall
                # (no results across several poll windows) on top of a death
                # before giving up.
                stalled_polls = 0
                while True:
                    try:
                        batch_id, batch, err = result_q.get(timeout=5.0)
                        break
                    except queue.Empty:
                        if self.stop_event.is_set():
                            return  # preempted: finally shuts workers down
                        dead = [w.name for w in workers if not w.is_alive()]
                        if not dead:
                            continue
                        stalled_polls += 1
                        if stalled_polls >= 6 and result_q.empty():
                            raise RuntimeError(
                                "data worker(s) died and the pool made no "
                                f"progress for 30s: {dead}"
                            )
                in_flight -= 1
                if err is not None:
                    raise RuntimeError(f"data worker failed:\n{err}")
                pending[batch_id] = batch
        finally:
            for _ in workers:
                index_q.put(None)
            for w in workers:
                w.join(timeout=2)
                if w.is_alive():
                    w.terminate()
