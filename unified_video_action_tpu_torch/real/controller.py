"""Timed-waypoint device controller processes over the native C++ IPC (the
port's own copy of ``real/controller.py``).

The reference's per-device ``mp.Process`` controllers
(rtde_interpolation_controller.py:23-376, wsg_controller.py:19-241): a child
process runs a fixed-frequency control loop that (a) drains a shared-memory
command queue (SERVO / SCHEDULE_WAYPOINT / STOP), (b) maintains a
time-parameterized trajectory, (c) servos the hardware backend at the
interpolated setpoint, and (d) publishes timestamped state into the lock-free
C++ SPMC ring buffer (``native/shm_ipc.cpp``) for any number of readers.

Command ``target_time`` is wall-clock (time.time()); the loop converts to the
monotonic clock internally so control never runs backward (reference
rtde_interpolation_controller.py:344-352).

Processes and CUDA: the controllers (and the camera, visualizer and
recorder processes) are *spawned*, not forked as JAX's are. The serving
process holds a CUDA context and the threads of torch and OpenBLAS, and a
fork of such a process is unsafe whatever the child does. A spawned child
starts from a fresh interpreter, imports this module and unpickles the
process object: its backend (the sim, RTDE and WSG backends are plain
objects) and its ring and queue, which reopen their segments by name
(``ipc/shm.py``). The children never import torch through this package.
The parent creates the segments and unlinks them in ``stop_wait``.

Beside JAX's ``ActualTCPPose``, the arm publishes ``TargetTCPPose``, the
setpoint it servoed that cycle (the trajectory's value; the reference's
controller publishes ur_rtde's ``getTargetTCPPose`` under that name).
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import threading
import time
from typing import Dict

import numpy as np

from unified_video_action_tpu_torch.ipc.shm import SharedMemoryQueue, SharedMemoryRingBuffer
from unified_video_action_tpu_torch.real.trajectory import PoseTrajectory, ScalarTrajectory

CMD_STOP = 0
CMD_SERVO = 1
CMD_SCHEDULE_WAYPOINT = 2

SPAWN = mp.get_context("spawn")

_uid_counter = itertools.count(1)
_uid_lock = threading.Lock()


def _unique_name(tag: str) -> str:
    """``uva_<tag>_<pid>_<n>``, JAX's format: unique within the process (the
    counter) and across processes (the pid)."""
    with _uid_lock:
        n = next(_uid_counter)
    return f"uva_{tag}_{os.getpid()}_{n}"


class SpawnedDevice(SPAWN.Process):
    """A spawned device process: the start/stop protocol and the ready and
    stop events. ``start_wait`` = ``start`` then ``wait_ready``, so that a
    caller can start several devices before waiting on any."""

    def __init__(self):
        super().__init__(daemon=True)
        self.ready_event = SPAWN.Event()
        self._stop_event = SPAWN.Event()

    def wait_ready(self, timeout: float = 30.0) -> None:
        if not self.ready_event.wait(timeout):
            raise RuntimeError(f"{type(self).__name__} failed to become ready "
                               f"(exit code {self.exitcode})")

    def start_wait(self, timeout: float = 30.0) -> None:
        self.start()
        self.wait_ready(timeout)

    def _join(self, timeout: float) -> None:
        self._stop_event.set()
        if self.pid is not None:
            self.join(timeout)
            if self.is_alive():
                self.terminate()
                self.join(timeout)

    @property
    def is_ready(self) -> bool:
        return self.ready_event.is_set()


class _BaseController(SpawnedDevice):
    """Shared process scaffolding: IPC setup, start/stop protocol, pacing."""

    #: width of the command target vector (6 pose / 1 width)
    target_dim = 6

    def __init__(self, backend, frequency: float = 125.0,
                 get_max_k: int = 128, tag: str = "ctrl"):
        super().__init__()
        self.backend = backend
        self.frequency = float(frequency)
        self.shm_name = _unique_name(tag)
        cmd_examples = {
            "cmd": np.zeros((), np.int32),
            "target": np.zeros(self.target_dim, np.float64),
            "target_time": np.zeros((), np.float64),
            "duration": np.zeros((), np.float64),
        }
        self.input_queue = SharedMemoryQueue(self.shm_name + "_q", cmd_examples, buffer_size=256)
        self.ring = SharedMemoryRingBuffer(self.shm_name + "_r", self._state_examples(),
                                           get_max_k=get_max_k)
        self.get_max_k = get_max_k

    # -- subclass surface ---------------------------------------------------

    def _state_examples(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _init_trajectory(self, t0: float):
        raise NotImplementedError

    def _servo(self, setpoint: np.ndarray) -> None:
        raise NotImplementedError

    def _read_state(self, setpoint: np.ndarray) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _apply_command(self, traj, msg, t_now: float, mono_minus_wall: float):
        raise NotImplementedError

    # -- parent-side API ------------------------------------------------------

    def stop_wait(self, timeout: float = 5.0) -> None:
        """Stop the loop, join the child and unlink the queue and the ring."""
        if self.pid is not None:
            self.input_queue.put({"cmd": np.int32(CMD_STOP), "target": np.zeros(self.target_dim),
                                  "target_time": 0.0, "duration": 0.0})
        self._join(timeout)
        self.input_queue.close(unlink=True)
        self.ring.close(unlink=True)

    def get_state(self, k: int = 1) -> Dict[str, np.ndarray]:
        return self.ring.get_last_k(k)

    def get_all_state(self) -> Dict[str, np.ndarray]:
        k = min(self.ring.count, self.get_max_k)
        return self.ring.get_last_k(max(k, 1))

    # -- child-side loop ------------------------------------------------------

    def run(self):  # pragma: no cover - runs in the spawned child
        self.backend.connect()
        dt = 1.0 / self.frequency
        t0 = time.monotonic()
        traj = self._init_trajectory(t0)
        mono_minus_wall = time.monotonic() - time.time()
        iter_idx = 0
        running = True
        while running and not self._stop_event.is_set():
            t_now = time.monotonic()
            setpoint = np.asarray(traj(t_now))
            self._servo(setpoint)
            state = self._read_state(setpoint)
            state["timestamp"] = np.float64(time.time())
            self.ring.put(state)

            if iter_idx == 0:
                self.ready_event.set()
            iter_idx += 1

            while True:
                msg = self.input_queue.get()
                if msg is None:
                    break
                if int(msg["cmd"]) == CMD_STOP:
                    running = False
                    break
                traj = self._apply_command(traj, msg, t_now, mono_minus_wall)

            sleep = t0 + iter_idx * dt - time.monotonic()
            if sleep > 0:
                time.sleep(sleep)
        self.backend.close()


class PoseInterpolationController(_BaseController):
    """6-DoF arm controller: servoes the interpolated pose trajectory and
    publishes {ActualTCPPose, TargetTCPPose, timestamp} (reference
    RTDEInterpolationController)."""

    target_dim = 6

    def __init__(self, backend, frequency: float = 125.0,
                 max_pos_speed: float = 0.25, max_rot_speed: float = 0.6, **kw):
        super().__init__(backend, frequency=frequency, tag="arm", **kw)
        self.max_pos_speed = max_pos_speed
        self.max_rot_speed = max_rot_speed

    def _state_examples(self):
        return {
            "ActualTCPPose": np.zeros(6, np.float64),
            "TargetTCPPose": np.zeros(6, np.float64),
            "timestamp": np.zeros((), np.float64),
        }

    def _init_trajectory(self, t0):
        pose = np.asarray(self.backend.get_pose(), np.float64)
        self._last_waypoint_time = t0
        return PoseTrajectory([t0], pose[None])

    def _servo(self, setpoint):
        self.backend.servo_pose(setpoint)

    def _read_state(self, setpoint):
        return {"ActualTCPPose": np.asarray(self.backend.get_pose(), np.float64),
                "TargetTCPPose": np.asarray(setpoint, np.float64)}

    def _apply_command(self, traj, msg, t_now, mono_minus_wall):
        cmd = int(msg["cmd"])
        pose = np.asarray(msg["target"], np.float64).reshape(6)
        if cmd == CMD_SERVO:
            duration = float(msg["duration"])
            traj = traj.drive_to_waypoint(pose, t_now + duration, t_now,
                                          max_pos_speed=self.max_pos_speed,
                                          max_rot_speed=self.max_rot_speed)
            self._last_waypoint_time = t_now + duration
        elif cmd == CMD_SCHEDULE_WAYPOINT:
            target_mono = float(msg["target_time"]) + mono_minus_wall
            traj = traj.schedule_waypoint(pose, target_mono, curr_time=t_now,
                                          max_pos_speed=self.max_pos_speed,
                                          max_rot_speed=self.max_rot_speed,
                                          last_waypoint_time=self._last_waypoint_time)
            self._last_waypoint_time = max(self._last_waypoint_time, target_mono)
        return traj

    # convenience send APIs (reference :180-205)
    def servo_pose(self, pose, duration: float = 0.1) -> None:
        self.input_queue.put({"cmd": np.int32(CMD_SERVO),
                              "target": np.asarray(pose, np.float64).reshape(6),
                              "target_time": 0.0, "duration": float(duration)})

    def schedule_waypoint(self, pose, target_time: float) -> None:
        self.input_queue.put({"cmd": np.int32(CMD_SCHEDULE_WAYPOINT),
                              "target": np.asarray(pose, np.float64).reshape(6),
                              "target_time": float(target_time), "duration": 0.0})


class WidthController(_BaseController):
    """Gripper width controller (reference WSGController semantics: scheduled
    width waypoints; state = {gripper_position, timestamp}). Its waypoints
    keep the ones scheduled before them, as the arm's do and as the
    reference's do (wsg_controller.py, ``last_waypoint_time``): JAX's
    replace every later waypoint, so of a chunk's waypoints sent together
    only the last stays."""

    target_dim = 1

    def __init__(self, backend, frequency: float = 30.0, max_speed: float = 0.2, **kw):
        super().__init__(backend, frequency=frequency, tag="grip", **kw)
        self.max_speed = max_speed

    def _state_examples(self):
        return {
            "gripper_position": np.zeros((), np.float64),
            "timestamp": np.zeros((), np.float64),
        }

    def _init_trajectory(self, t0):
        self._last_waypoint_time = t0
        return ScalarTrajectory([t0], np.array([[float(self.backend.get_width())]]))

    def _servo(self, setpoint):
        self.backend.servo_width(float(np.atleast_1d(setpoint)[0]))

    def _read_state(self, setpoint):
        return {"gripper_position": np.float64(self.backend.get_width())}

    def _apply_command(self, traj, msg, t_now, mono_minus_wall):
        cmd = int(msg["cmd"])
        width = float(np.asarray(msg["target"]).reshape(1)[0])
        if cmd in (CMD_SERVO, CMD_SCHEDULE_WAYPOINT):
            if cmd == CMD_SERVO:
                target_mono = t_now + float(msg["duration"])
            else:
                target_mono = float(msg["target_time"]) + mono_minus_wall
            traj = traj.schedule_waypoint(width, target_mono, curr_time=t_now,
                                          max_speed=self.max_speed,
                                          last_waypoint_time=self._last_waypoint_time)
            self._last_waypoint_time = max(self._last_waypoint_time, target_mono)
        return traj

    def schedule_waypoint(self, pos, target_time: float) -> None:
        self.input_queue.put({"cmd": np.int32(CMD_SCHEDULE_WAYPOINT),
                              "target": np.asarray([float(np.ravel(pos)[0])], np.float64),
                              "target_time": float(target_time), "duration": 0.0})
