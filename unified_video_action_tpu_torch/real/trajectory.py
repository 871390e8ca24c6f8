"""Time-parameterized trajectories for timed-waypoint control (the port's
own copy of ``real/trajectory.py``, numpy and scipy only).

Equivalent capability to the reference's ``PoseTrajectoryInterpolator``
(unified_video_action/common/pose_trajectory_interpolator.py) and
``PoseInterpolator``/``get_interp1d`` (umi/common/interpolation_util.py), with
an original formulation: a trajectory is a monotone time grid with poses
(pos3 + rotvec3) interpolated linearly in position and by slerp in rotation;
``schedule_waypoint`` trims the future and inserts the new waypoint no earlier
than the pose/rotation speed limits allow. Evaluation clamps to the ends
(constant extrapolation), matching the reference's hold-last-waypoint
behavior.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from scipy.spatial.transform import Rotation, Slerp


def _rot_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Geodesic angle between two rotvecs."""
    ra, rb = Rotation.from_rotvec(a), Rotation.from_rotvec(b)
    return float(np.linalg.norm((rb * ra.inv()).as_rotvec()))


class ScalarTrajectory:
    """Piecewise-linear scalar(-vector) trajectory with end clamping."""

    def __init__(self, times: Sequence[float], values: np.ndarray):
        t = np.asarray(times, dtype=np.float64)
        v = np.atleast_2d(np.asarray(values, dtype=np.float64))
        if v.shape[0] != t.shape[0]:
            v = v.reshape(t.shape[0], -1)
        assert t.ndim == 1 and len(t) >= 1
        assert np.all(np.diff(t) >= 0), "times must be non-decreasing"
        self.times = t
        self.values = v

    def __call__(self, t) -> np.ndarray:
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        out = np.empty((len(t), self.values.shape[1]))
        for j in range(self.values.shape[1]):
            out[:, j] = np.interp(t, self.times, self.values[:, j])
        return out if out.shape[0] > 1 else out[0]

    def trim(self, end_time: float) -> "ScalarTrajectory":
        """Keep the trajectory up to end_time (inserting an interpolated
        endpoint), dropping later waypoints."""
        keep = self.times < end_time
        t = np.append(self.times[keep], end_time)
        v = np.vstack([self.values[keep], np.atleast_1d(self(end_time))])
        return ScalarTrajectory(t, v)

    def schedule_waypoint(
        self,
        value,
        target_time: float,
        curr_time: Optional[float] = None,
        max_speed: float = np.inf,
        last_waypoint_time: Optional[float] = None,
    ) -> "ScalarTrajectory":
        """Insert a future waypoint. ``last_waypoint_time`` (not in JAX's
        copy, whose width controller passes none): the trajectory up to
        min(last_waypoint_time, target_time) is kept, as
        ``PoseTrajectory.schedule_waypoint`` keeps it, so that a chunk's
        waypoints scheduled one after another all stay; without it
        everything after ``curr_time`` is replaced, as in JAX's."""
        value = np.atleast_1d(np.asarray(value, dtype=np.float64))
        start = self.times[0] if curr_time is None else max(
            curr_time, self.times[0]
        )
        if last_waypoint_time is not None:
            start = max(start, min(last_waypoint_time, float(target_time)))
        target_time = max(float(target_time), start)
        base = self.trim(start)
        # speed limit pushes the arrival later if needed
        dist = float(np.max(np.abs(value - np.atleast_1d(base(start)))))
        min_duration = dist / max_speed if np.isfinite(max_speed) else 0.0
        target_time = max(target_time, start + min_duration)
        t = np.append(base.times[base.times < target_time], target_time)
        v = np.vstack(
            [base.values[base.times < target_time], value]
        )
        return ScalarTrajectory(t, v)


class PoseTrajectory:
    """6-DoF pose trajectory: linear position + slerp rotation."""

    def __init__(self, times: Sequence[float], poses: np.ndarray):
        t = np.asarray(times, dtype=np.float64)
        p = np.asarray(poses, dtype=np.float64).reshape(len(t), 6)
        assert np.all(np.diff(t) >= 0), "times must be non-decreasing"
        self.times = t
        self.poses = p

    def _rotations(self) -> Rotation:
        return Rotation.from_rotvec(self.poses[:, 3:])

    def __call__(self, t) -> np.ndarray:
        ts = np.atleast_1d(np.asarray(t, dtype=np.float64))
        tc = np.clip(ts, self.times[0], self.times[-1])
        pos = np.empty((len(ts), 3))
        for j in range(3):
            pos[:, j] = np.interp(tc, self.times, self.poses[:, j])
        if len(self.times) == 1:
            rot = np.tile(self.poses[0, 3:], (len(ts), 1))
        else:
            # Slerp needs strictly increasing keys; dedupe equal stamps
            uniq = np.concatenate([[True], np.diff(self.times) > 0])
            slerp = Slerp(self.times[uniq],
                          Rotation.from_rotvec(self.poses[uniq, 3:]))
            rot = slerp(tc).as_rotvec()
        out = np.concatenate([pos, rot], axis=-1)
        return out if out.shape[0] > 1 else out[0]

    def trim(self, end_time: float) -> "PoseTrajectory":
        keep = self.times < end_time
        t = np.append(self.times[keep], end_time)
        p = np.vstack([self.poses[keep], self(end_time)])
        return PoseTrajectory(t, p)

    def schedule_waypoint(
        self,
        pose,
        target_time: float,
        curr_time: Optional[float] = None,
        max_pos_speed: float = np.inf,
        max_rot_speed: float = np.inf,
        last_waypoint_time: Optional[float] = None,
    ) -> "PoseTrajectory":
        """Insert a future waypoint (reference semantics: the trajectory up to
        max(curr_time, last_waypoint_time) is preserved, everything later is
        replaced, and the arrival time respects the speed limits)."""
        pose = np.asarray(pose, dtype=np.float64).reshape(6)
        start = self.times[0] if curr_time is None else max(
            curr_time, self.times[0]
        )
        if last_waypoint_time is not None:
            start = max(start, min(last_waypoint_time, float(target_time)))
        target_time = max(float(target_time), start)
        base = self.trim(start)
        start_pose = np.asarray(base(start))
        dur_pos = (
            np.linalg.norm(pose[:3] - start_pose[:3]) / max_pos_speed
            if np.isfinite(max_pos_speed) else 0.0
        )
        dur_rot = (
            _rot_distance(start_pose[3:], pose[3:]) / max_rot_speed
            if np.isfinite(max_rot_speed) else 0.0
        )
        target_time = max(target_time, start + max(dur_pos, dur_rot))
        keep = base.times < target_time
        t = np.append(base.times[keep], target_time)
        p = np.vstack([base.poses[keep], pose])
        return PoseTrajectory(t, p)

    def drive_to_waypoint(
        self,
        pose,
        target_time: float,
        curr_time: float,
        max_pos_speed: float = np.inf,
        max_rot_speed: float = np.inf,
    ) -> "PoseTrajectory":
        """ServoL-style: drop ALL scheduled waypoints and go to pose."""
        pose = np.asarray(pose, dtype=np.float64).reshape(6)
        start = max(curr_time, self.times[0])
        base = self.trim(start)
        start_pose = np.asarray(base(start))
        dur_pos = (
            np.linalg.norm(pose[:3] - start_pose[:3]) / max_pos_speed
            if np.isfinite(max_pos_speed) else 0.0
        )
        dur_rot = (
            _rot_distance(start_pose[3:], pose[3:]) / max_rot_speed
            if np.isfinite(max_rot_speed) else 0.0
        )
        target_time = max(float(target_time), start + max(dur_pos, dur_rot))
        return PoseTrajectory(
            np.array([start, target_time]), np.vstack([start_pose, pose])
        )
