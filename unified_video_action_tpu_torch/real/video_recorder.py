"""Camera-stream video recorder process (the port's own copy of
``real/video_recorder.py``).

The reference's ``umi/real_world/video_recorder.py`` (a process draining
camera frames into an h264 file, start/stop per episode): a spawned child
(``real/controller.py`` says why) follows a camera's shared-memory ring,
which it reopens by name, and appends every new frame to the active video
file through cv2.VideoWriter, imported in the child only. Episode lifecycle
maps to start_recording(path) / stop_recording(), matching UmiRealEnv's
start_episode/end_episode timing.
"""

from __future__ import annotations

import os
import queue
import time

from unified_video_action_tpu_torch.real.controller import SPAWN, SpawnedDevice


class VideoRecorderProcess(SpawnedDevice):
    def __init__(self, ring, fps: float = 30.0, poll_hz: float = 120.0):
        super().__init__()
        self.ring = ring
        self.fps = float(fps)
        self.poll_dt = 1.0 / float(poll_hz)
        self._cmd = SPAWN.Queue()
        self._n_written = SPAWN.Value("l", 0)

    # -- parent-side API ----------------------------------------------------

    def start_recording(self, path: str) -> None:
        self._cmd.put(("start", path))

    def stop_recording(self) -> None:
        self._cmd.put(("stop", None))

    def stop_wait(self, timeout: float = 5.0) -> None:
        self._cmd.put(("stop", None))
        self._join(timeout)

    @property
    def n_written(self) -> int:
        return int(self._n_written.value)

    # -- child-side loop ----------------------------------------------------

    def run(self):  # pragma: no cover - runs in the spawned child
        import cv2

        writer = None
        path = None
        last_ts = float("-inf")
        self.ready_event.set()
        while not self._stop_event.is_set():
            try:
                cmd, arg = self._cmd.get_nowait()
                if writer is not None:
                    writer.release()
                    writer = None
                if cmd == "start":
                    os.makedirs(os.path.dirname(arg) or ".", exist_ok=True)
                    path, last_ts = arg, float("-inf")
                else:
                    path = None
            except queue.Empty:
                pass

            if path is not None and self.ring.count > 0:
                data = self.ring.get_last_k(1)
                ts = float(data["timestamp"][0])
                # decimate to the container rate: write a frame only when a
                # full 1/fps period has elapsed in SOURCE timestamps, so the
                # mp4 plays back in real time regardless of the camera's own
                # rate (reference steps_per_render semantics)
                if ts - last_ts >= 1.0 / self.fps - 1e-6:
                    frame = data["color"][0]
                    if writer is None:
                        h, w = frame.shape[:2]
                        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                                 self.fps, (w, h))
                    writer.write(frame[..., ::-1])  # rgb -> bgr
                    with self._n_written.get_lock():
                        self._n_written.value += 1
                    last_ts = ts
            time.sleep(self.poll_dt)
        if writer is not None:
            writer.release()
