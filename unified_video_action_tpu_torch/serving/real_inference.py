"""Real-robot inference utilities for UMI (the port's own copy of
``serving/real_inference.py``, numpy only).

Equivalents of ``umi/real_world/real_inference_util.py:18-236``: build the
policy's observation dict from raw robot state (relative-pose representation
wrt the latest frame and wrt the episode start), and convert the predicted
relative pose10d action chunk back to absolute environment actions."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from unified_video_action_tpu_torch.utils.pose import (
    convert_pose_mat_rep,
    mat_to_pose,
    mat_to_pose10d,
    pose10d_to_mat,
    pose_to_mat,
)


def get_real_umi_obs_dict(
    env_obs: Dict[str, np.ndarray],
    obs_pose_repr: str = "relative",
    episode_start_pose: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Raw robot obs {camera0_rgb (T,H,W,3), robot0_eef_pos (T,3),
    robot0_eef_rot_axis_angle (T,3), robot0_gripper_width (T,1)} -> the
    policy's obs dict with pose10d relative representations."""
    out: Dict[str, np.ndarray] = {}
    if "camera0_rgb" in env_obs:
        img = env_obs["camera0_rgb"].astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        out["camera0_rgb"] = np.moveaxis(img, -1, 1)

    pose = np.concatenate([env_obs["robot0_eef_pos"], env_obs["robot0_eef_rot_axis_angle"]],
                          axis=-1)
    pose_mat = pose_to_mat(pose)
    base = pose_mat[-1]  # latest frame
    rel = convert_pose_mat_rep(pose_mat, base, obs_pose_repr)
    p10 = mat_to_pose10d(rel)
    out["robot0_eef_pos"] = p10[:, :3]
    out["robot0_eef_rot_axis_angle"] = p10[:, 3:]
    out["robot0_gripper_width"] = env_obs["robot0_gripper_width"].astype(np.float32)

    if episode_start_pose is not None:
        start_mat = pose_to_mat(np.asarray(episode_start_pose, np.float64))
        rel_start = convert_pose_mat_rep(pose_mat, start_mat, "relative")
        out["robot0_eef_rot_axis_angle_wrt_start"] = mat_to_pose10d(rel_start)[:, 3:]
    return out


def get_real_umi_action(
    action_pred: np.ndarray,
    current_pose: np.ndarray,
    action_pose_repr: str = "relative",
) -> np.ndarray:
    """Predicted chunk (T, 10) [pos3, rot6d, gripper] in the relative frame ->
    absolute env actions (T, 7) [pos3, axis_angle3, gripper]."""
    base_mat = pose_to_mat(np.asarray(current_pose, np.float64))
    rel_mats = pose10d_to_mat(action_pred[..., :9])
    abs_mats = convert_pose_mat_rep(rel_mats, base_mat, action_pose_repr, backward=True)
    abs_pose = mat_to_pose(abs_mats)
    gripper = action_pred[..., 9:10]
    return np.concatenate([abs_pose, gripper], axis=-1).astype(np.float32)
