"""Bimanual (N-arm) real-robot orchestration (the port's own copy of
``real/bimanual.py``).

The reference's ``BimanualUmiEnv`` (umi/real_world/bimanual_umi_env.py:25-695)
generalized to N arms on the backend-abstracted controller stack
(``real/controller.py``, ``real/camera.py``):

* obs cameras are cameras[0..n_arms-1]; the align camera is chosen
  dynamically as the one whose latest frame minimizes total staleness
  against the other obs cameras (bimanual_umi_env.py:397-428);
* per-arm namespacing: ``robot{i}_eef_pos`` / ``robot{i}_eef_rot_axis_angle``
  / ``robot{i}_gripper_width``;
* ``exec_actions``: (T, 7*n_arms) chunks — per-arm pose6+width1 interleaved —
  scheduled at wall-clock timestamps with per-arm latency compensation
  (bimanual_umi_env.py:516-551).

Everything runs against the simulated backends in ``real/sim.py``. The
episode record is ``real/env.py``'s (its docstring says where it differs
from JAX's).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from unified_video_action_tpu_torch.real.camera import CameraProcess
from unified_video_action_tpu_torch.real.controller import (
    PoseInterpolationController,
    WidthController,
)
from unified_video_action_tpu_torch.real.env import _Accumulator, camera_obs_k, start_devices
from unified_video_action_tpu_torch.real.trajectory import PoseTrajectory, ScalarTrajectory

__all__ = ["BimanualUmiEnv", "MultiCameraVisualizer", "select_align_camera"]


def select_align_camera(cam_data: Sequence[Dict[str, np.ndarray]], n_obs_cameras: int) -> int:
    """Pick the obs camera whose newest frame minimizes the summed lag to the
    newest not-newer frame of every other obs camera."""
    best_idx, best_err = 0, np.inf
    for i in range(n_obs_cameras):
        t_i = float(cam_data[i]["timestamp"][-1])
        err = 0.0
        for j in range(n_obs_cameras):
            if j == i:
                continue
            ts_j = cam_data[j]["timestamp"]
            older = ts_j[ts_j < t_i]
            err += t_i - float(older[-1]) if len(older) else np.inf
        if err < best_err:
            best_idx, best_err = i, err
    return best_idx


class BimanualUmiEnv:
    """N-arm orchestration: one pose controller + one gripper per arm, any
    number of cameras (the first ``n_arms`` are per-arm obs cameras)."""

    def __init__(
        self,
        robots: Sequence[PoseInterpolationController],
        grippers: Sequence[WidthController],
        cameras: Sequence[CameraProcess],
        frequency: float = 10.0,
        camera_obs_horizon: int = 2,
        robot_obs_horizon: int = 2,
        gripper_obs_horizon: int = 2,
        camera_down_sample_steps: int = 1,
        robot_down_sample_steps: int = 1,
        gripper_down_sample_steps: int = 1,
        robots_config: Optional[Sequence[Dict]] = None,
        grippers_config: Optional[Sequence[Dict]] = None,
    ):
        assert len(robots) == len(grippers) >= 1
        assert len(cameras) >= len(robots), "one obs camera per arm"
        self.robots = list(robots)
        self.grippers = list(grippers)
        self.cameras = list(cameras)
        self.n_arms = len(robots)
        self.frequency = float(frequency)
        self.camera_obs_horizon = camera_obs_horizon
        self.robot_obs_horizon = robot_obs_horizon
        self.gripper_obs_horizon = gripper_obs_horizon
        self.camera_down_sample_steps = camera_down_sample_steps
        self.robot_down_sample_steps = robot_down_sample_steps
        self.gripper_down_sample_steps = gripper_down_sample_steps
        self.robots_config = list(robots_config or [{"robot_action_latency": 0.0}] * self.n_arms)
        self.grippers_config = list(grippers_config
                                    or [{"gripper_action_latency": 0.0}] * self.n_arms)
        self.obs_accumulator: Optional[_Accumulator] = None
        self.action_accumulator: Optional[_Accumulator] = None

    # -- lifecycle ----------------------------------------------------------
    @property
    def devices(self) -> list:
        return [*self.cameras, *self.robots, *self.grippers]

    def start(self, timeout: float = 30.0) -> None:
        start_devices(self.devices, timeout)

    def stop(self) -> None:
        for d in [*self.robots, *self.grippers, *self.cameras]:
            d.stop_wait()

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

    # -- observation --------------------------------------------------------
    def get_obs(self) -> Dict[str, np.ndarray]:
        assert self.is_ready
        dt = 1.0 / self.frequency
        cam_data = [cam.get(camera_obs_k(cam, self.camera_obs_horizon,
                                         self.camera_down_sample_steps, dt))
                    for cam in self.cameras]
        robots_state = [r.get_all_state() for r in self.robots]
        grippers_state = [g.get_all_state() for g in self.grippers]

        align_idx = select_align_camera(cam_data, self.n_arms)
        last_timestamp = float(cam_data[align_idx]["timestamp"][-1])

        camera_obs_timestamps = last_timestamp - (
            np.arange(self.camera_obs_horizon)[::-1] * self.camera_down_sample_steps * dt)
        obs: Dict[str, np.ndarray] = {}
        for idx, value in enumerate(cam_data):
            ts = value["timestamp"]
            nn = [int(np.argmin(np.abs(ts - t))) for t in camera_obs_timestamps]
            obs[f"camera{idx}_rgb"] = value["color"][nn]
        obs["timestamp"] = camera_obs_timestamps

        robot_obs_timestamps = last_timestamp - (
            np.arange(self.robot_obs_horizon)[::-1] * self.robot_down_sample_steps * dt)
        for i, rs in enumerate(robots_state):
            pose = np.atleast_2d(
                PoseTrajectory(rs["timestamp"], rs["ActualTCPPose"])(robot_obs_timestamps))
            obs[f"robot{i}_eef_pos"] = pose[..., :3]
            obs[f"robot{i}_eef_rot_axis_angle"] = pose[..., 3:]

        gripper_obs_timestamps = last_timestamp - (
            np.arange(self.gripper_obs_horizon)[::-1] * self.gripper_down_sample_steps * dt)
        for i, gs in enumerate(grippers_state):
            obs[f"robot{i}_gripper_width"] = np.atleast_2d(
                ScalarTrajectory(gs["timestamp"], gs["gripper_position"][..., None])(
                    gripper_obs_timestamps))

        if self.obs_accumulator is not None:
            for i, rs in enumerate(robots_state):
                self.obs_accumulator.put({f"robot{i}_eef_pose": rs["ActualTCPPose"]},
                                         timestamps=rs["timestamp"])
            for i, gs in enumerate(grippers_state):
                self.obs_accumulator.put(
                    {f"robot{i}_gripper_width": gs["gripper_position"][..., None]},
                    timestamps=gs["timestamp"])
        return obs

    def get_robot_state(self) -> List[Dict[str, np.ndarray]]:
        return [r.get_state() for r in self.robots]

    def get_gripper_state(self) -> List[Dict[str, np.ndarray]]:
        return [g.get_state() for g in self.grippers]

    # -- action -------------------------------------------------------------
    def exec_actions(self, actions: np.ndarray, timestamps: np.ndarray,
                     compensate_latency: bool = False) -> int:
        """actions: (T, 7*n_arms) — per-arm [pose6, width1] interleaved."""
        assert self.is_ready
        actions = np.asarray(actions, np.float64)
        timestamps = np.asarray(timestamps, np.float64)
        assert actions.shape[1] == 7 * self.n_arms, (
            f"expected {7 * self.n_arms} action dims, got {actions.shape[1]}")
        receive_time = time.time()
        is_new = timestamps > receive_time
        new_actions = actions[is_new]
        new_timestamps = timestamps[is_new]

        for a, t in zip(new_actions, new_timestamps):
            for i, (robot, gripper, rc, gc) in enumerate(
                    zip(self.robots, self.grippers, self.robots_config, self.grippers_config)):
                r_lat = rc.get("robot_action_latency", 0.0) if compensate_latency else 0.0
                g_lat = gc.get("gripper_action_latency", 0.0) if compensate_latency else 0.0
                robot.schedule_waypoint(pose=a[7 * i: 7 * i + 6], target_time=t - r_lat)
                gripper.schedule_waypoint(pos=a[7 * i + 6:7 * i + 7], target_time=t - g_lat)

        if self.action_accumulator is not None:
            self.action_accumulator.put({"action": new_actions}, timestamps=new_timestamps)
        return int(len(new_actions))

    # -- episode logging ----------------------------------------------------
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


# the visualizer lives in real/visualizer.py; re-exported here as JAX's
# bimanual module does
from unified_video_action_tpu_torch.real.visualizer import MultiCameraVisualizer  # noqa: E402,F401
