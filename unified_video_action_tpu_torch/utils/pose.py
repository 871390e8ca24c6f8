"""SE(3) pose utilities for the UMI pipeline (the port's own copy of
``utils/pose.py``, numpy only).

Equivalents of ``umi/common/pose_util.py`` (pose <-> 4x4 mat, pose10d) and
``common/pose_repr_util.py`` (relative / absolute pose representation
conversion used by the lazy datasets and real-robot inference)."""

from __future__ import annotations

import numpy as np

from unified_video_action_tpu_torch.utils.rotation import (
    axis_angle_to_matrix,
    matrix_to_axis_angle,
    matrix_to_rotation_6d,
    rotation_6d_to_matrix,
)


def pose_to_mat(pose) -> np.ndarray:
    """[pos(3), axis_angle(3)] -> (…, 4, 4)."""
    pose = np.asarray(pose, dtype=np.float64)
    mat = np.zeros(pose.shape[:-1] + (4, 4))
    mat[..., :3, :3] = axis_angle_to_matrix(pose[..., 3:6])
    mat[..., :3, 3] = pose[..., :3]
    mat[..., 3, 3] = 1.0
    return mat


def mat_to_pose(mat) -> np.ndarray:
    mat = np.asarray(mat, dtype=np.float64)
    pos = mat[..., :3, 3]
    aa = matrix_to_axis_angle(mat[..., :3, :3])
    return np.concatenate([pos, aa], axis=-1)


def mat_to_pose10d(mat) -> np.ndarray:
    """(…, 4, 4) -> [pos(3), rot6d(6)] — 9d; 'pose10d' name kept for parity."""
    mat = np.asarray(mat, dtype=np.float64)
    pos = mat[..., :3, 3]
    d6 = matrix_to_rotation_6d(mat[..., :3, :3])
    return np.concatenate([pos, d6], axis=-1).astype(np.float32)


def pose10d_to_mat(d10) -> np.ndarray:
    d10 = np.asarray(d10, dtype=np.float64)
    pos = d10[..., :3]
    R = rotation_6d_to_matrix(d10[..., 3:9])
    mat = np.zeros(d10.shape[:-1] + (4, 4))
    mat[..., :3, :3] = R
    mat[..., :3, 3] = pos
    mat[..., 3, 3] = 1.0
    return mat


def mat_inverse(mat) -> np.ndarray:
    mat = np.asarray(mat, dtype=np.float64)
    R = mat[..., :3, :3]
    t = mat[..., :3, 3:]
    Rt = np.swapaxes(R, -1, -2)
    out = np.zeros_like(mat)
    out[..., :3, :3] = Rt
    out[..., :3, 3:] = -Rt @ t
    out[..., 3, 3] = 1.0
    return out


def compute_relative_pose(pose_mats, base_mat) -> np.ndarray:
    """T_base^-1 @ T_i for each pose (reference compute_relative_pose)."""
    return mat_inverse(base_mat) @ pose_mats


def convert_pose_mat_rep(
    pose_mat: np.ndarray,
    base_pose_mat: np.ndarray,
    pose_rep: str = "abs",
    backward: bool = False,
) -> np.ndarray:
    """Forward: express poses absolutely or relative to a base frame.
    Backward: map relative predictions back to absolute
    (reference common/pose_repr_util.py:4-122, abs/relative cases)."""
    if not backward:
        if pose_rep == "abs":
            return pose_mat.copy()
        if pose_rep == "relative":
            return mat_inverse(base_pose_mat) @ pose_mat
        if pose_rep == "delta":
            # Reference semantics (pose_repr_util.py:72-88): position deltas
            # are WORLD-frame diffs and the rotation delta is left-multiplied
            # (curr @ inv(prev)); this is NOT an SE(3) previous-frame-relative
            # increment — decoded trajectories depend on matching it exactly.
            base = np.asarray(base_pose_mat, dtype=pose_mat.dtype)
            all_pos = np.concatenate(
                [base[None, :3, 3], pose_mat[..., :3, 3]], axis=0)
            out_pos = np.diff(all_pos, axis=0)
            all_rot = np.concatenate(
                [base[None, :3, :3], pose_mat[..., :3, :3]], axis=0)
            out_rot = all_rot[1:] @ np.swapaxes(all_rot[:-1], -1, -2)
            out = pose_mat.copy()
            out[..., :3, :3] = out_rot
            out[..., :3, 3] = out_pos
            return out
        raise NotImplementedError(pose_rep)
    if pose_rep == "abs":
        return pose_mat.copy()
    if pose_rep == "relative":
        return base_pose_mat @ pose_mat
    if pose_rep == "delta":
        # Reference backward (pose_repr_util.py:108-120): cumsum positions,
        # left-compose rotation deltas onto the base rotation.
        base = np.asarray(base_pose_mat, dtype=pose_mat.dtype)
        out = pose_mat.copy()
        out[..., :3, 3] = np.cumsum(pose_mat[..., :3, 3], axis=0) + base[:3, 3]
        curr = base[:3, :3]
        for t in range(pose_mat.shape[0]):
            curr = pose_mat[t, :3, :3] @ curr
            out[t, :3, :3] = curr
        return out
    raise NotImplementedError(pose_rep)
