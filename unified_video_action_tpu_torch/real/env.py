"""UmiRealEnv: latency-aligned observation assembly + timed action execution
(the port's own copy of ``real/env.py``).

The reference's ``UmiEnv`` orchestration (umi/real_world/umi_env.py:26-603):

* ``get_obs()``: 'current' time is the align-camera's last frame timestamp;
  camera horizons pick nearest-timestamp frames, low-dim horizons (robot pose,
  gripper width) interpolate their controller state streams at the aligned
  times (umi_env.py:359-464).
* ``exec_actions(actions, timestamps)``: drops already-stale actions and
  schedules pose + gripper waypoints at the remaining wall-clock target times,
  optionally compensating per-device action latency (umi_env.py:465-497).
* episode accumulators record timestamped obs/action streams for replay-buffer
  logging (start/stop/drop, umi_env.py:502-601).

Hardware enters only through the controller/camera backends, so the whole
stack runs (and is tested) against the simulated devices in ``real/sim.py``.
``start`` starts every device process before it waits on any (each is
spawned, ``real/controller.py``); ``stop`` joins them and unlinks their
shared memory.

The episode record differs from JAX's where JAX's is wrong for more than one
control cycle: JAX appends every put whole, so the state windows of
successive ``get_obs`` calls, which overlap, are recorded again and again
and their timestamps run backwards, and an action chunk that a later chunk
replaced in the controllers' trajectories stays recorded beside its
replacement. Here, as the reference's timestamp accumulators do, an
observation stream keeps only the samples newer than its last one, and an
action put first drops the recorded actions at or after its first
timestamp. A single put records what JAX's does.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from unified_video_action_tpu_torch.real.camera import CameraProcess
from unified_video_action_tpu_torch.real.controller import (
    PoseInterpolationController,
    WidthController,
)
from unified_video_action_tpu_torch.real.trajectory import PoseTrajectory, ScalarTrajectory


class _Accumulator:
    """Timestamped stream store (the reference's TimestampObsAccumulator and
    TimestampActionAccumulator roles): ``supersede=False`` keeps only samples
    newer than a stream's last, ``supersede=True`` lets a put replace the
    recorded rows from its first timestamp on."""

    def __init__(self, supersede: bool = False):
        self.supersede = supersede
        self.data: Dict[str, List[np.ndarray]] = {}
        self.timestamps: Dict[str, List[float]] = {}

    def put(self, data: Dict[str, np.ndarray], timestamps: np.ndarray) -> None:
        ts = np.atleast_1d(np.asarray(timestamps, np.float64))
        for k, v in data.items():
            v = np.asarray(v)
            if v.shape[0] != len(ts):
                v = np.broadcast_to(v, (len(ts), *v.shape))
            values = self.data.setdefault(k, [])
            stamps = self.timestamps.setdefault(k, [])
            if not len(ts):
                continue
            if self.supersede:
                n = bisect.bisect_left(stamps, ts[0])
                del values[n:], stamps[n:]
                new = np.ones(len(ts), bool)
            else:
                new = ts > (stamps[-1] if stamps else -np.inf)
            values.extend(list(v[new]))
            stamps.extend(ts[new].tolist())

    def arrays(self) -> Dict[str, np.ndarray]:
        out = {}
        for k in self.data:
            out[k] = np.asarray(self.data[k])
            out[k + "_timestamp"] = np.asarray(self.timestamps[k])
        return out


def start_devices(devices: Sequence, timeout: float) -> None:
    """Start every device process, then wait until each is ready."""
    for d in devices:
        d.start()
    for d in devices:
        d.wait_ready(timeout)


def camera_obs_k(cam: CameraProcess, horizon: int, down_sample_steps: int, dt: float) -> int:
    """Frames to pull to cover the aligned horizon at the camera's own rate
    (a 60 fps wrist camera needs twice the frames of a 30 fps scene camera
    for the same time window)."""
    k = int(np.ceil(horizon * down_sample_steps * max(cam.fps * dt, 1.0))) + 2
    return min(k, cam.get_max_k)


class UmiRealEnv:
    def __init__(
        self,
        robot: PoseInterpolationController,
        gripper: WidthController,
        cameras: Sequence[CameraProcess],
        frequency: float = 10.0,
        camera_obs_horizon: int = 2,
        robot_obs_horizon: int = 2,
        gripper_obs_horizon: int = 2,
        camera_down_sample_steps: int = 1,
        robot_down_sample_steps: int = 1,
        gripper_down_sample_steps: int = 1,
        align_camera_idx: int = 0,
        robot_action_latency: float = 0.0,
        gripper_action_latency: float = 0.0,
    ):
        assert len(cameras) >= 1
        self.robot = robot
        self.gripper = gripper
        self.cameras = list(cameras)
        self.frequency = float(frequency)
        self.camera_obs_horizon = camera_obs_horizon
        self.robot_obs_horizon = robot_obs_horizon
        self.gripper_obs_horizon = gripper_obs_horizon
        self.camera_down_sample_steps = camera_down_sample_steps
        self.robot_down_sample_steps = robot_down_sample_steps
        self.gripper_down_sample_steps = gripper_down_sample_steps
        self.align_camera_idx = align_camera_idx
        self.robot_action_latency = robot_action_latency
        self.gripper_action_latency = gripper_action_latency
        self.obs_accumulator: Optional[_Accumulator] = None
        self.action_accumulator: Optional[_Accumulator] = None

    # -- lifecycle ------------------------------------------------------------

    @property
    def devices(self) -> list:
        return [*self.cameras, self.robot, self.gripper]

    def start(self, timeout: float = 30.0) -> None:
        start_devices(self.devices, timeout)

    def stop(self) -> None:
        self.robot.stop_wait()
        self.gripper.stop_wait()
        for cam in self.cameras:
            cam.stop_wait()

    def __enter__(self):
        try:
            self.start()
        except BaseException:
            self.stop()
            raise
        return self

    def __exit__(self, *exc):
        self.stop()

    @property
    def is_ready(self) -> bool:
        return all(d.is_ready for d in self.devices)

    # -- observation ----------------------------------------------------------

    def get_obs(self) -> Dict[str, np.ndarray]:
        assert self.is_ready
        dt = 1.0 / self.frequency
        cam_data = [cam.get(camera_obs_k(cam, self.camera_obs_horizon,
                                         self.camera_down_sample_steps, dt))
                    for cam in self.cameras]

        robot_state = self.robot.get_all_state()
        gripper_state = self.gripper.get_all_state()

        last_timestamp = float(cam_data[self.align_camera_idx]["timestamp"][-1])

        camera_obs_timestamps = last_timestamp - (
            np.arange(self.camera_obs_horizon)[::-1] * self.camera_down_sample_steps * dt)
        obs: Dict[str, np.ndarray] = {}
        for idx, value in enumerate(cam_data):
            ts = value["timestamp"]
            nn = [int(np.argmin(np.abs(ts - t))) for t in camera_obs_timestamps]
            obs[f"camera{idx}_rgb"] = value["color"][nn]

        robot_obs_timestamps = last_timestamp - (
            np.arange(self.robot_obs_horizon)[::-1] * self.robot_down_sample_steps * dt)
        pose_interp = PoseTrajectory(robot_state["timestamp"], robot_state["ActualTCPPose"])
        robot_pose = np.atleast_2d(pose_interp(robot_obs_timestamps))
        obs["robot0_eef_pos"] = robot_pose[..., :3]
        obs["robot0_eef_rot_axis_angle"] = robot_pose[..., 3:]

        gripper_obs_timestamps = last_timestamp - (
            np.arange(self.gripper_obs_horizon)[::-1] * self.gripper_down_sample_steps * dt)
        g_interp = ScalarTrajectory(gripper_state["timestamp"],
                                    gripper_state["gripper_position"][..., None])
        obs["robot0_gripper_width"] = np.atleast_2d(g_interp(gripper_obs_timestamps))
        obs["timestamp"] = camera_obs_timestamps

        if self.obs_accumulator is not None:
            self.obs_accumulator.put({"robot0_eef_pose": robot_state["ActualTCPPose"]},
                                     timestamps=robot_state["timestamp"])
            self.obs_accumulator.put(
                {"robot0_gripper_width": gripper_state["gripper_position"][..., None]},
                timestamps=gripper_state["timestamp"])
        return obs

    def get_robot_state(self) -> Dict[str, np.ndarray]:
        return self.robot.get_state()

    # -- action ---------------------------------------------------------------

    def exec_actions(self, actions: np.ndarray, timestamps: np.ndarray,
                     compensate_latency: bool = False) -> int:
        """actions: (N, 7) = pose6 + width1 at wall-clock ``timestamps``.
        Returns the number of still-fresh actions actually scheduled."""
        assert self.is_ready
        actions = np.asarray(actions, np.float64)
        timestamps = np.asarray(timestamps, np.float64)
        receive_time = time.time()
        is_new = timestamps > receive_time
        new_actions = actions[is_new]
        new_timestamps = timestamps[is_new]

        r_lat = self.robot_action_latency if compensate_latency else 0.0
        g_lat = self.gripper_action_latency if compensate_latency else 0.0
        for a, t in zip(new_actions, new_timestamps):
            self.robot.schedule_waypoint(pose=a[:6], target_time=t - r_lat)
            self.gripper.schedule_waypoint(pos=a[6:], target_time=t - g_lat)

        if self.action_accumulator is not None:
            self.action_accumulator.put({"action": new_actions}, timestamps=new_timestamps)
        return int(len(new_actions))

    # -- episode logging --------------------------------------------------------

    def start_episode(self) -> None:
        self.obs_accumulator = _Accumulator()
        self.action_accumulator = _Accumulator(supersede=True)

    def end_episode(self) -> Dict[str, np.ndarray]:
        out = {}
        if self.obs_accumulator is not None:
            out.update(self.obs_accumulator.arrays())
        if self.action_accumulator is not None:
            out.update(self.action_accumulator.arrays())
        self.obs_accumulator = None
        self.action_accumulator = None
        return out

    def drop_episode(self) -> None:
        self.obs_accumulator = None
        self.action_accumulator = None
