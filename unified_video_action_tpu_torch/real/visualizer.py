"""Multi-camera grid visualizer process (the port's own copy of
``real/visualizer.py``).

The reference's ``MultiCameraVisualizer``
(umi/real_world/multi_camera_visualizer.py:8-85): a child process pulls the
latest frame from each camera ring at ``vis_fps``, tiles them row-major into
a single grid image, and shows it. Differences by design, as JAX's:

- sources are N camera rings (each camera is its own process), read without
  blocking the writers; the process keeps the rings only, since it is
  spawned (``real/controller.py``) and a ring pickles by name;
- the sink is pluggable: a cv2 window when a display and cv2 exist (cv2 is
  imported in the child only), else the composited grid is published into
  its own shared-memory ring so a recorder or remote viewer can consume it.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from unified_video_action_tpu_torch.ipc.shm import SharedMemoryRingBuffer
from unified_video_action_tpu_torch.real.controller import SpawnedDevice, _unique_name

__all__ = ["MultiCameraVisualizer", "tile_grid"]


def tile_grid(frames: Sequence[np.ndarray], row: int, col: int,
              fill_value: int = 0, rgb_to_bgr: bool = False) -> np.ndarray:
    """Tile N HxWx3 frames row-major into a (row*H, col*W, 3) uint8 grid.

    Missing cells (idx >= N) stay at ``fill_value``; mirrors the reference's
    layout loop (multi_camera_visualizer.py:66-81).
    """
    if not frames:
        raise ValueError("no frames to tile")
    H, W, C = frames[0].shape
    if C != 3:
        raise ValueError(f"expected 3-channel frames, got {C}")
    grid = np.full((H * row, W * col, 3), fill_value, dtype=np.uint8)
    sl = slice(None, None, -1) if rgb_to_bgr else slice(None)
    for idx, f in enumerate(frames[: row * col]):
        if f.shape != (H, W, C):
            raise ValueError(f"frame {idx} shape {f.shape} != first frame {(H, W, C)}")
        r, c = divmod(idx, col)
        grid[H * r:H * (r + 1), W * c:W * (c + 1)] = f[:, :, sl]
    return grid


class MultiCameraVisualizer(SpawnedDevice):
    """Compose N camera rings into one live grid view.

    ``cameras``: objects with a ``ring`` (``CameraProcess``, started by the
    caller); only their rings are kept. ``row``, ``col``: the grid, which may
    hold more cells than cameras (blank cells). ``sink``: "window" tries a
    cv2 window (ring-only when cv2 or a display is absent); "file" also
    publishes the grid atomically to ``out_path`` as .npy; "ring" publishes
    to the shared-memory ring only, which every sink writes.
    """

    def __init__(self, cameras: Sequence, row: int, col: int,
                 window_name: str = "Multi Cam Vis", vis_fps: float = 30.0,
                 fill_value: int = 0, rgb_to_bgr: bool = True,
                 sink: str = "window", out_path: Optional[str] = None,
                 get_max_k: int = 8):
        super().__init__()
        if not cameras:
            raise ValueError("need at least one camera")
        self.sources = [cam.ring for cam in cameras]
        self.row = int(row)
        self.col = int(col)
        if self.row * self.col < 1:
            raise ValueError("grid must have at least one cell")
        self.window_name = window_name
        self.vis_fps = float(vis_fps)
        self.fill_value = fill_value
        self.rgb_to_bgr = rgb_to_bgr
        if sink not in ("window", "file", "ring"):
            raise ValueError(f"unknown sink {sink!r}")
        if sink == "file" and not out_path:
            raise ValueError("file sink needs out_path")
        self.sink = sink
        self.out_path = out_path
        h, w, _ = self.sources[0].dtype["color"].shape
        self._cell_hw = (h, w)
        self.ring = SharedMemoryRingBuffer(
            _unique_name("vis"),
            {"grid": np.zeros((h * self.row, w * self.col, 3), np.uint8),
             "timestamp": np.zeros((), np.float64)},
            get_max_k=get_max_k,
        )

    # -- parent-side API -----------------------------------------------------
    def stop_wait(self, timeout: float = 5.0) -> None:
        """Stop the loop, join the child and unlink the grid's ring."""
        self._join(timeout)
        self.ring.close(unlink=True)

    def get(self, k: int = 1) -> Dict[str, np.ndarray]:
        return self.ring.get_last_k(k)

    def __enter__(self):
        try:
            self.start_wait()
        except BaseException:
            self.stop_wait()
            raise
        return self

    def __exit__(self, *exc):
        self.stop_wait()

    # -- child-side loop -----------------------------------------------------
    def _window(self):
        """cv2 with the window open, or None on a host without cv2 or a display."""
        if self.sink != "window":
            return None
        try:
            import cv2

            cv2.setNumThreads(1)
            cv2.namedWindow(self.window_name, cv2.WINDOW_AUTOSIZE)
            return cv2
        except Exception:
            return None

    def run(self):  # pragma: no cover - runs in the spawned child
        imshow = self._window()
        dt = 1.0 / self.vis_fps
        t0 = time.monotonic()
        i = 0
        while not self._stop_event.is_set():
            frames = []
            newest = 0.0
            for ring in self.sources:
                if ring.count:
                    s = ring.get_last_k(1)
                    frames.append(s["color"][-1])
                    newest = max(newest, float(s["timestamp"][-1]))
                else:  # a camera that has not produced yet renders blank
                    frames.append(np.full((*self._cell_hw, 3), self.fill_value, np.uint8))
            grid = tile_grid(frames, self.row, self.col, fill_value=self.fill_value,
                             rgb_to_bgr=self.rgb_to_bgr)
            self.ring.put({"grid": grid, "timestamp": np.float64(newest or time.time())})
            if self.sink == "file":
                tmp = self.out_path + ".tmp.npy"
                np.save(tmp, grid)
                os.replace(tmp, self.out_path)
            if imshow is not None:
                try:
                    imshow.imshow(self.window_name, grid)
                    imshow.pollKey()
                except Exception:
                    imshow = None
            if i == 0:
                self.ready_event.set()
            i += 1
            sleep = (t0 + i * dt) - time.monotonic()
            if sleep > 0:
                time.sleep(sleep)
