"""Shared-memory IPC over the native library (the port's own copy of
``ipc/shm.py``, numpy and ctypes only).

``SharedMemoryRingBuffer`` and ``SharedMemoryQueue`` (the reference's
umi/shared_memory/*): structured numpy records move between the real-time
device processes through a lock-free SPMC ring (camera frames, robot state)
and an SPSC command queue (waypoint commands). The data plane is the C++
library of ``native/shm_ipc.cpp``.

The library is built from that source with ``g++`` at first use, into
``build/shm_ipc/`` at the repository root (listed in ``.gitignore``), under
a name keyed by a hash of the source and the flags, as ``ops/_build.py``
builds the CUDA sources: nothing is written into ``native/``, and a failed
build raises with the compiler's output.

A ring or a queue pickles as its name and record layout, and unpickles by
opening the segment by name: the controller and camera processes are
spawned (``real/controller.py``), so each child maps the segments its
parent created. The creator unlinks them (``close(unlink=True)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SRC_PATH = REPO / "native" / "shm_ipc.cpp"
BUILD_DIR = REPO / "build" / "shm_ipc"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-lrt",)

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of the current ``native/shm_ipc.cpp`` lives."""
    h = hashlib.sha256()
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SRC_PATH.read_bytes())
    return BUILD_DIR / f"libshm_ipc-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile ``native/shm_ipc.cpp`` unless it is built already. Returns
    the seconds the build took (0.0 where the library was there). Raises
    with the compiler's output on a failure."""
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC_PATH), "-o", str(tmp), *LINK_FLAGS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC_PATH} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return seconds


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(library_path()))
    lib.uva_ring_create.restype = ctypes.c_void_p
    lib.uva_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.uva_ring_open.restype = ctypes.c_void_p
    lib.uva_ring_open.argtypes = [ctypes.c_char_p]
    lib.uva_ring_put.restype = ctypes.c_int
    lib.uva_ring_put.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.uva_ring_count.restype = ctypes.c_uint64
    lib.uva_ring_count.argtypes = [ctypes.c_void_p]
    lib.uva_ring_get_last_k.restype = ctypes.c_int64
    lib.uva_ring_get_last_k.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.uva_ring_close.argtypes = [ctypes.c_void_p]
    lib.uva_shm_unlink.argtypes = [ctypes.c_char_p]
    lib.uva_queue_create.restype = ctypes.c_void_p
    lib.uva_queue_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.uva_queue_open.restype = ctypes.c_void_p
    lib.uva_queue_open.argtypes = [ctypes.c_char_p]
    lib.uva_queue_push.restype = ctypes.c_int
    lib.uva_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.uva_queue_pop.restype = ctypes.c_int
    lib.uva_queue_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.uva_queue_size.restype = ctypes.c_uint64
    lib.uva_queue_size.argtypes = [ctypes.c_void_p]
    lib.uva_queue_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _record_dtype(examples: Dict[str, np.ndarray]) -> np.dtype:
    return np.dtype([(k, np.asarray(examples[k]).dtype, np.asarray(examples[k]).shape)
                     for k in sorted(examples)])


def _record(dtype: np.dtype, data: Dict[str, np.ndarray]) -> bytes:
    rec = np.zeros(1, dtype=dtype)
    for k, v in data.items():
        rec[0][k] = v
    return rec.tobytes()


class _Segment:
    """A mapped segment that pickles as its name and layout."""

    @property
    def nbytes(self) -> int:
        """The segment's slots in shared memory (the header excluded)."""
        return self.slot_bytes * self._size

    def __getstate__(self):
        return {"name": self.name, "dtype": self.dtype, "size": self._size}

    def __setstate__(self, state):
        self.__init__(state["name"].decode(), None, buffer_size=state["size"], create=False,
                      dtype=state["dtype"])


class SharedMemoryRingBuffer(_Segment):
    """Single-writer / multi-reader ring of structured records."""

    def __init__(self, name: str, examples: Optional[Dict[str, np.ndarray]],
                 get_max_k: int = 32, buffer_size: Optional[int] = None,
                 create: bool = True, dtype: Optional[np.dtype] = None):
        self.name = name.encode()
        self.dtype = dtype if dtype is not None else _record_dtype(examples)
        self.slot_bytes = self.dtype.itemsize
        self.n_slots = buffer_size or max(get_max_k * 4, 64)
        self._size = self.n_slots
        lib = get_lib()
        if create:
            self.handle = lib.uva_ring_create(self.name, self.slot_bytes, self.n_slots)
        else:
            self.handle = lib.uva_ring_open(self.name)
        if not self.handle:
            raise RuntimeError(f"failed to map ring {name}")

    @classmethod
    def open(cls, name: str, examples: Dict[str, np.ndarray]) -> "SharedMemoryRingBuffer":
        return cls(name, examples, create=False)

    @property
    def count(self) -> int:
        return int(get_lib().uva_ring_count(self.handle))

    def put(self, data: Dict[str, np.ndarray]) -> None:
        buf = _record(self.dtype, data)
        if get_lib().uva_ring_put(self.handle, buf, len(buf)) != 0:
            raise RuntimeError("record larger than slot")

    def get(self) -> Dict[str, np.ndarray]:
        return self.get_last_k(1)

    def get_last_k(self, k: int, retries: int = 8) -> Dict[str, np.ndarray]:
        lib = get_lib()
        out = np.zeros(k, dtype=self.dtype)
        for _ in range(retries):
            n = lib.uva_ring_get_last_k(self.handle, out.ctypes.data_as(ctypes.c_void_p), k)
            if n >= 0:
                got = out[:n]
                return {name: np.ascontiguousarray(got[name]) for name in self.dtype.names}
        raise RuntimeError("ring buffer read kept getting lapped by the writer")

    def close(self, unlink: bool = False) -> None:
        """Unmap (once; a second call does nothing) and, with ``unlink``,
        remove the segment's name."""
        if self.handle is None:
            return
        lib = get_lib()
        lib.uva_ring_close(self.handle)
        self.handle = None
        if unlink:
            lib.uva_shm_unlink(self.name)


class SharedMemoryQueue(_Segment):
    """Single-producer / single-consumer queue of structured records."""

    def __init__(self, name: str, examples: Optional[Dict[str, np.ndarray]],
                 buffer_size: int = 256, create: bool = True,
                 dtype: Optional[np.dtype] = None):
        self.name = name.encode()
        self.dtype = dtype if dtype is not None else _record_dtype(examples)
        self.slot_bytes = self.dtype.itemsize
        self._size = buffer_size
        lib = get_lib()
        if create:
            self.handle = lib.uva_queue_create(self.name, self.slot_bytes, buffer_size)
        else:
            self.handle = lib.uva_queue_open(self.name)
        if not self.handle:
            raise RuntimeError(f"failed to map queue {name}")

    @classmethod
    def open(cls, name: str, examples: Dict[str, np.ndarray]) -> "SharedMemoryQueue":
        return cls(name, examples, create=False)

    def qsize(self) -> int:
        return int(get_lib().uva_queue_size(self.handle))

    def put(self, data: Dict[str, np.ndarray]) -> bool:
        buf = _record(self.dtype, data)
        return get_lib().uva_queue_push(self.handle, buf, len(buf)) == 0

    def get(self) -> Optional[Dict[str, np.ndarray]]:
        out = np.zeros(1, dtype=self.dtype)
        if get_lib().uva_queue_pop(self.handle, out.ctypes.data_as(ctypes.c_void_p)) != 0:
            return None
        return {name: np.ascontiguousarray(out[0][name]) for name in self.dtype.names}

    def close(self, unlink: bool = False) -> None:
        """Unmap (once; a second call does nothing) and, with ``unlink``,
        remove the segment's name."""
        if self.handle is None:
            return
        lib = get_lib()
        lib.uva_queue_close(self.handle)
        self.handle = None
        if unlink:
            lib.uva_shm_unlink(self.name)
