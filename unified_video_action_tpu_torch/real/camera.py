"""Camera capture process publishing timestamped frames over the C++ ring
(the port's own copy of ``real/camera.py``).

The reference's UvcCamera/MultiUvcCamera processes
(umi/real_world/uvc_camera.py:22-330, multi_uvc_camera.py:12-184): a child
process grabs frames from its backend at a fixed rate and publishes
{color, timestamp} into the lock-free SPMC ring buffer; readers pull the last
k frames without blocking the writer. An optional per-frame transform (e.g.
fisheye rectification, mirror masking) runs in the capture process. The
process is spawned (``real/controller.py`` says why), so the backend and the
transform must pickle.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from unified_video_action_tpu_torch.ipc.shm import SharedMemoryRingBuffer
from unified_video_action_tpu_torch.real.controller import SpawnedDevice, _unique_name


class CameraProcess(SpawnedDevice):
    def __init__(
        self,
        backend,
        resolution: Tuple[int, int] = (64, 64),
        fps: float = 60.0,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        get_max_k: int = 64,
    ):
        super().__init__()
        self.backend = backend
        self.fps = float(fps)
        self.transform = transform
        h, w = resolution
        self.ring = SharedMemoryRingBuffer(
            _unique_name("cam"),
            {"color": np.zeros((h, w, 3), np.uint8), "timestamp": np.zeros((), np.float64)},
            get_max_k=get_max_k,
        )
        self.get_max_k = get_max_k

    def stop_wait(self, timeout: float = 5.0) -> None:
        """Stop the capture loop, join the child and unlink the ring."""
        self._join(timeout)
        self.ring.close(unlink=True)

    def get(self, k: int = 1) -> Dict[str, np.ndarray]:
        return self.ring.get_last_k(k)

    def run(self):  # pragma: no cover - runs in the spawned child
        self.backend.connect()
        dt = 1.0 / self.fps
        t0 = time.monotonic()
        i = 0
        while not self._stop_event.is_set():
            frame, ts = self.backend.grab()
            if self.transform is not None:
                frame = self.transform(frame)
            self.ring.put({"color": np.ascontiguousarray(frame, dtype=np.uint8),
                           "timestamp": np.float64(ts)})
            if i == 0:
                self.ready_event.set()
            i += 1
            sleep = (t0 + i * dt) - time.monotonic()
            if sleep > 0:
                time.sleep(sleep)
        self.backend.close()
