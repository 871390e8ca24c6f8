"""The port's shared-memory IPC (``ipc/shm.py``) on the CPU, with no card:

- the ring and the queue: put / get_last_k, wrap-around, FIFO order, a full
  queue refused, as JAX's tests hold JAX's;
- the same segments read across the two bindings, both ways (the port's
  library is built from ``native/shm_ipc.cpp`` into ``build/shm_ipc/``,
  JAX's is the committed ``native/libshm_ipc.so``): records equal byte for
  byte;
- a ring and a queue pickled into a spawned process, which reopens them by
  name and writes records the parent reads; ``close`` twice is harmless and
  ``unlink`` removes the name from ``/dev/shm``;
- the library's build keyed by the source, and a build that fails raising
  with the compiler's output (no fallback).

Exact equality throughout; each spawned child is joined within 30 s.
"""

import os
import pickle

import numpy as np
import pytest

from tests._torch_real_child import write_records
from unified_video_action_tpu.ipc import shm as jshm
from unified_video_action_tpu_torch.ipc import shm
from unified_video_action_tpu_torch.real.controller import SPAWN, _unique_name

EXAMPLES = {"pose": np.zeros(6, np.float32), "ts": np.zeros((), np.float64)}


def _rec(i):
    return {"pose": np.arange(6, dtype=np.float32) + i, "ts": float(i)}


def _gone(name: str) -> bool:
    return not os.path.exists(os.path.join("/dev/shm", name))


def test_ring_put_get_and_wraparound():
    name = _unique_name("test_ring")
    rb = shm.SharedMemoryRingBuffer(name, EXAMPLES, buffer_size=8)
    try:
        assert rb.count == 0 and rb.get_last_k(3)["ts"].shape == (0,)
        for i in range(5):
            rb.put(_rec(i))
        out = rb.get_last_k(3)
        np.testing.assert_array_equal(out["ts"], [2.0, 3.0, 4.0])
        np.testing.assert_array_equal(out["pose"][-1], np.arange(6) + 4.0)
        assert float(rb.get()["ts"][0]) == 4.0
        for i in range(5, 100):
            rb.put(_rec(i))
        assert rb.count == 100
        np.testing.assert_array_equal(rb.get_last_k(4)["ts"], [96.0, 97.0, 98.0, 99.0])
        with pytest.raises(RuntimeError):
            rb.get_last_k(9)  # more than the ring holds
        assert rb.nbytes == 8 * rb.slot_bytes
    finally:
        rb.close(unlink=True)
        rb.close(unlink=True)
    assert _gone(name)


def test_queue_fifo_and_full():
    name = _unique_name("test_q")
    q = shm.SharedMemoryQueue(name, EXAMPLES, buffer_size=4)
    try:
        assert q.get() is None
        assert all(q.put(_rec(i)) for i in range(4))
        assert not q.put(_rec(9))  # full
        assert q.qsize() == 4
        vals = []
        while (item := q.get()) is not None:
            vals.append(item["ts"].item())
        assert vals == [0.0, 1.0, 2.0, 3.0]
    finally:
        q.close(unlink=True)
    assert _gone(name)


def test_segments_read_across_the_two_bindings():
    name = _unique_name("test_x")
    ours = shm.SharedMemoryRingBuffer(name, EXAMPLES, buffer_size=16)
    theirs = jshm.SharedMemoryRingBuffer.open(name, EXAMPLES)
    try:
        for i in range(5):
            ours.put(_rec(i))
        got, want = theirs.get_last_k(5), ours.get_last_k(5)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes()
        theirs.put(_rec(7))
        assert ours.count == 6 and float(ours.get()["ts"][0]) == 7.0
    finally:
        theirs.close()
        ours.close(unlink=True)
    qname = _unique_name("test_xq")
    jq = jshm.SharedMemoryQueue(qname, EXAMPLES, buffer_size=4)
    q = shm.SharedMemoryQueue.open(qname, EXAMPLES)
    try:
        jq.put(_rec(3))
        item = q.get()
        assert item["ts"].item() == 3.0 and item["pose"].tobytes() == _rec(3)["pose"].tobytes()
        assert q.get() is None
    finally:
        q.close()
        jq.close(unlink=True)


def test_segments_pickle_into_a_spawned_process():
    ring = shm.SharedMemoryRingBuffer(_unique_name("test_sp"), EXAMPLES, buffer_size=64)
    queue = shm.SharedMemoryQueue(_unique_name("test_spq"), EXAMPLES, buffer_size=4)
    try:
        again = pickle.loads(pickle.dumps(ring))  # reopened by name, the layout kept
        assert (again.name, again.dtype, again.n_slots) == (ring.name, ring.dtype, ring.n_slots)
        again.close()
        p = SPAWN.Process(target=write_records, args=(ring, queue, 50), daemon=True)
        p.start()
        p.join(timeout=30)
        assert p.exitcode == 0
        assert ring.count == 50
        np.testing.assert_array_equal(ring.get_last_k(2)["ts"], [48.0, 49.0])
        assert queue.get()["ts"].item() == 50.0
    finally:
        ring.close(unlink=True)
        queue.close(unlink=True)


def test_build_is_keyed_by_the_source_and_a_failure_raises(tmp_path, monkeypatch):
    assert shm.library_path().parent == shm.BUILD_DIR
    assert shm.library_path().exists()  # built by the tests above, outside native/
    monkeypatch.setattr(shm, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "shm_ipc.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(shm, "SRC_PATH", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        shm.build()
    assert not any((tmp_path / "build").glob("*.so"))
    good = tmp_path / "good.cpp"
    good.write_text((shm.REPO / "native" / "shm_ipc.cpp").read_text())
    monkeypatch.setattr(shm, "SRC_PATH", good)
    assert shm.build() > 0.0 and shm.library_path().exists()
    assert shm.build() == 0.0  # built already
