"""Per-step video recording wrapper (the port's copy of the JAX package's
``envs/video_recording.py``, numpy only).

Equivalent of the reference's ``VideoRecordingWrapper`` + ``VideoRecorder``
(gym_util/video_recording_wrapper.py:6-66, video_recorder.py:52-163): record
``render()`` frames every ``steps_per_render`` env steps into a video file.

A deliberate difference: the port always writes an animated GIF through its
own writer (``utils/media.GifWriter``, lossless for frames of at most 256
colors, as PushT's are), and a path with another extension (``.mp4``) gets
``.gif`` instead. JAX writes an mp4 through OpenCV where OpenCV is
installed and swaps ``.mp4`` for ``.gif`` (written by imageio) where it is
not; the card's machine has neither.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from unified_video_action_tpu_torch.utils.media import GifWriter


class VideoRecorder:
    """Streams frames into a GIF: ``start(path)``, ``write_frame`` per frame,
    ``stop()`` returns the path written (None without a frame)."""

    def __init__(self, fps: int = 10):
        self.fps = fps
        self.writer: Optional[GifWriter] = None
        self.path: Optional[str] = None

    def start(self, path: str) -> None:
        self.stop()
        self.path = os.path.splitext(path)[0] + ".gif"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        self.writer = GifWriter(self.path, self.fps)

    def write_frame(self, frame: np.ndarray) -> None:
        if self.writer is None:
            return
        self.writer.append(np.asarray(frame))

    def stop(self) -> Optional[str]:
        writer, path = self.writer, self.path
        self.writer, self.path = None, None
        if writer is None:
            return None
        return path if writer.close() else None

    @property
    def is_ready(self) -> bool:
        return self.path is not None


class VideoRecordingWrapper:
    def __init__(
        self,
        env,
        video_recorder: Optional[VideoRecorder] = None,
        file_path: Optional[str] = None,
        steps_per_render: int = 1,
    ):
        self.env = env
        self.video_recorder = video_recorder or VideoRecorder()
        self.file_path = file_path
        self.steps_per_render = steps_per_render
        self._step_count = 0

    def reset(self, *args, **kwargs):
        out = self.env.reset(*args, **kwargs)
        self._step_count = 1
        self.video_recorder.stop()
        if self.file_path is not None:
            self.video_recorder.start(self.file_path)
            frame = self.env.render()
            if frame is not None:
                self.video_recorder.write_frame(np.asarray(frame))
        return out

    def step(self, action):
        result = self.env.step(action)
        self._step_count += 1
        if (
            self.file_path is not None
            and self._step_count % self.steps_per_render == 0
        ):
            frame = self.env.render()
            if frame is not None:
                self.video_recorder.write_frame(np.asarray(frame))
        return result

    def render(self, *args, **kwargs):
        return self.env.render(*args, **kwargs)

    def stop_recording(self) -> Optional[str]:
        return self.video_recorder.stop()

    def __getattr__(self, name):
        return getattr(self.env, name)
