"""Simulated hardware backends for the real-robot runtime (the port's own
copy of ``real/sim.py``; ``Cv2CameraBackend`` imports OpenCV only when it
connects).

The controller/camera processes are hardware-agnostic: they drive a backend
object with a tiny adapter interface. These simulated backends make the whole
stack testable in software — a first-order-lag 6-DoF arm, a speed-limited
gripper, and a deterministic camera — playing the roles of the reference's
ur_rtde / WSG TCP / UVC devices (rtde_interpolation_controller.py,
wsg_controller.py, uvc_camera.py). Real backends implement the same methods
against their SDKs.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np


class SimArmBackend:
    """6-DoF arm with first-order lag toward the servo target (time constant
    ``tau`` seconds) — enough dynamics to make latency alignment observable."""

    def __init__(self, init_pose=None, tau: float = 0.05):
        self.pose = np.asarray(
            init_pose if init_pose is not None else np.zeros(6), dtype=np.float64
        )
        self.target = self.pose.copy()
        self.tau = tau
        self._last_t: Optional[float] = None

    def connect(self) -> None:
        self._last_t = time.monotonic()

    def servo_pose(self, pose: np.ndarray) -> None:
        self.target = np.asarray(pose, dtype=np.float64).copy()
        t = time.monotonic()
        dt = 0.0 if self._last_t is None else t - self._last_t
        self._last_t = t
        alpha = 1.0 - np.exp(-dt / self.tau) if self.tau > 0 else 1.0
        self.pose = self.pose + alpha * (self.target - self.pose)

    def get_pose(self) -> np.ndarray:
        return self.pose.copy()

    def close(self) -> None:
        pass


class SimGripperBackend:
    """Speed-limited gripper width (m)."""

    def __init__(self, init_width: float = 0.08, max_speed: float = 0.2):
        self.width = float(init_width)
        self.target = float(init_width)
        self.max_speed = max_speed
        self._last_t: Optional[float] = None

    def connect(self) -> None:
        self._last_t = time.monotonic()

    def servo_width(self, width: float) -> None:
        self.target = float(width)
        t = time.monotonic()
        dt = 0.0 if self._last_t is None else t - self._last_t
        self._last_t = t
        step = self.max_speed * dt
        self.width += np.clip(self.target - self.width, -step, step)

    def get_width(self) -> float:
        return self.width

    def close(self) -> None:
        pass


class SimCameraBackend:
    """Deterministic frames at a fixed resolution; each grab is stamped with
    the wall-clock capture time."""

    def __init__(self, resolution: Tuple[int, int] = (64, 64), seed: int = 0):
        self.resolution = resolution
        self.seed = seed
        self._frame_idx = 0

    def connect(self) -> None:
        pass

    def grab(self) -> Tuple[np.ndarray, float]:
        h, w = self.resolution
        yy, xx = np.mgrid[0:h, 0:w]
        base = (yy * 3 + xx * 5 + self.seed * 17 + self._frame_idx * 7) % 256
        frame = np.stack([base, (base + 80) % 256, (base + 160) % 256],
                         axis=-1).astype(np.uint8)
        self._frame_idx += 1
        return frame, time.time()

    def close(self) -> None:
        pass


class Cv2CameraBackend:
    """Real camera through OpenCV VideoCapture (UVC devices); optional
    explicit fourcc/size like the reference's uvc_camera.py."""

    def __init__(self, device=0, resolution: Optional[Tuple[int, int]] = None):
        self.device = device
        self.resolution = resolution
        self.cap = None

    def connect(self) -> None:
        import cv2

        self.cap = cv2.VideoCapture(self.device)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open camera {self.device!r}")
        if self.resolution is not None:
            h, w = self.resolution
            self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, w)
            self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, h)

    def grab(self) -> Tuple[np.ndarray, float]:
        ok, frame = self.cap.read()
        t = time.time()
        if not ok:
            raise RuntimeError("camera read failed")
        return frame[..., ::-1].copy(), t  # BGR -> RGB

    def close(self) -> None:
        if self.cap is not None:
            self.cap.release()
