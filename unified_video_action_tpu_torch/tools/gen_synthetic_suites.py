#!/usr/bin/env python3
"""Write synthetic robomimic-layout and LIBERO-layout stores (``.npz``, the
layout ``data/robomimic_dataset.RobomimicStore`` reads) from a seed: the
tool-hang store that ``config.TOOLHANG`` names, the ten per-task LIBERO-10
stores under the directory ``config.LIBERO10`` names, one per
``LIBERO10_TASK_NAMES``, the kitchen's per-task stores
``kitchen_<task>_demo.npz`` under ``config.KITCHEN``'s directory and the
Fetch store of ``config.FETCH`` (as ``.npz``). The real robomimic and LIBERO
HDF5 corpora are not in the repository, and the kitchen's and Fetch's are
recorded by their experts in mujoco (``tools/gen_kitchen_demos.py``,
``tools/gen_fetch_demos.py``) where mujoco is installed; these have their
layout, not their content.

    python3 unified_video_action_tpu_torch/tools/gen_synthetic_suites.py --root data
    python3 unified_video_action_tpu_torch/tools/gen_synthetic_suites.py --root data --suites kitchen fetch

Each demo holds ``obs/<camera>`` (T, H, W, 3) uint8 frames (a gradient
scene with a disc that follows the end effector), ``obs/robot0_eef_pos``,
``obs/robot0_eef_quat`` (wxyz) and ``obs/robot0_gripper_qpos``, the
absolute ``actions`` (T, 7): position, axis-angle rotation and gripper along
a smooth trajectory, and ``states`` (T, 8), which the robomimic runner's
train episodes reset to. A kitchen demo holds the bottom-up
``obs/agentview_rgb`` (T, 128, 128, 3) and ``obs/robot0_joint_pos`` (T, 9),
9-d joint-velocity ``actions`` in [-1, 1] and ``states`` (T, 59), mujoco's
qpos and qvel, as ``tools/gen_kitchen_demos.py`` records them; a Fetch demo
``obs/agentview_image`` (T, 96, 96, 3), ``obs/robot0_eef_pos``,
``obs/robot0_gripper_qpos``, 4-d delta ``actions`` in [-1, 1] and ``states``
(T, 46): qpos, qvel and the goal, as ``tools/gen_fetch_demos.py`` records
them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Sequence

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from unified_video_action_tpu_torch.data.robomimic_dataset import write_npz_store  # noqa: E402
from unified_video_action_tpu_torch.envs.kitchen_tasks import (  # noqa: E402
    KITCHEN_TASK_PROMPTS,
    _slug,
)
from unified_video_action_tpu_torch.runners.libero_runner import LIBERO10_TASK_NAMES  # noqa: E402
from unified_video_action_tpu_torch.utils.rotation import axis_angle_to_quaternion  # noqa: E402

TOOLHANG_CAMERAS = ("sideview_image", "robot0_eye_in_hand_image")
TOOLHANG_PATH = "robomimic/tool_hang/ph/image_abs.npz"
LIBERO_DIR = "libero/libero_10"
KITCHEN_DIR = "kitchen_demos"
FETCH_PATH = "fetch_demos.npz"
SUITES = ("toolhang", "libero10", "kitchen", "fetch")


def _frames(pos: np.ndarray, size: int, phase: float) -> np.ndarray:
    """(T, size, size, 3) uint8: a colour gradient and a disc at the end
    effector's x, y."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.stack([xx, yy, 0.5 + 0.5 * np.sin(6.0 * (xx + yy) + phase)], axis=-1)
    cx = 0.5 + 0.4 * np.tanh(pos[:, 0])[:, None, None]
    cy = 0.5 + 0.4 * np.tanh(pos[:, 1])[:, None, None]
    disc = ((xx[None] - cx) ** 2 + (yy[None] - cy) ** 2) < 0.01
    img = np.where(disc[..., None], np.float32(1.0), base[None] * np.float32(0.8))
    return (img * 255).astype(np.uint8)


def make_demos(n_demos: int, steps: int, image_size: int, cameras: Sequence[str],
               seed: int) -> List[Dict[str, object]]:
    """``n_demos`` demos of ``steps`` steps, as ``write_npz_store`` takes
    them: a smooth absolute pose trajectory a demo, its frames from each of
    ``cameras``."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, steps, dtype=np.float64)[:, None]
    demos = []
    for _ in range(n_demos):
        p0, amp, freq = rng.uniform(-0.3, 0.3, 3), rng.uniform(0.05, 0.2, 3), rng.uniform(0.5, 2, 3)
        pos = p0 + amp * np.sin(2 * np.pi * freq * t)
        r0, ramp = rng.uniform(-1, 1, 3), rng.uniform(0.1, 0.4, 3)
        rot = r0 + ramp * np.cos(2 * np.pi * t + rng.uniform(0, np.pi, 3))
        grip = np.where(t[:, 0] < rng.uniform(0.3, 0.7), -1.0, 1.0)[:, None]
        actions = np.concatenate([pos, rot, grip], axis=-1).astype(np.float32)
        obs = {cam: _frames(pos, image_size, phase=k + rng.uniform(0, 1))
               for k, cam in enumerate(cameras)}
        obs["robot0_eef_pos"] = pos.astype(np.float32)
        obs["robot0_eef_quat"] = axis_angle_to_quaternion(rot).astype(np.float32)
        width = 0.04 * (1.0 - grip) / 2
        obs["robot0_gripper_qpos"] = np.concatenate([width, -width], axis=-1).astype(np.float32)
        states = np.concatenate([pos, rot, grip, width], axis=-1).astype(np.float64)
        demos.append({"obs": obs, "actions": actions, "states": states})
    return demos


def write_toolhang(root: str, n_demos: int = 8, steps: int = 64, image_size: int = 240,
                   seed: int = 0) -> str:
    """The tool-hang store under ``root``; returns its path."""
    path = os.path.join(root, TOOLHANG_PATH)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_npz_store(path, make_demos(n_demos, steps, image_size, TOOLHANG_CAMERAS, seed))
    return path


def write_libero10(root: str, n_demos: int = 3, steps: int = 48, image_size: int = 128,
                   seed: int = 1) -> List[str]:
    """One store a LIBERO-10 task under ``root``; returns their paths."""
    d = os.path.join(root, LIBERO_DIR)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, name in enumerate(LIBERO10_TASK_NAMES):
        paths.append(os.path.join(d, name + ".npz"))
        write_npz_store(paths[-1], make_demos(n_demos, steps, image_size, ("agentview_rgb",),
                                              seed * 1000 + i))
    return paths


def _velocities(rng, steps: int, dim: int) -> np.ndarray:
    """(steps, dim) float32 commands in [-1, 1]: a smooth wave a dimension."""
    t = np.linspace(0.0, 1.0, steps)[:, None]
    amp, freq, phase = rng.uniform(0.2, 0.9, dim), rng.uniform(0.5, 2, dim), rng.uniform(0, 6, dim)
    return (amp * np.sin(2 * np.pi * freq * t + phase)).astype(np.float32)


def kitchen_demos(n_demos: int, steps: int, image_size: int, seed: int) -> List[Dict[str, object]]:
    """``n_demos`` kitchen-layout demos of ``steps`` steps: the joints
    integrate the 9-d velocity commands; the frames are stored bottom-up, as
    the kitchen env renders them."""
    rng = np.random.default_rng(seed)
    demos = []
    for _ in range(n_demos):
        actions = _velocities(rng, steps, 9)
        qpos = rng.uniform(-0.5, 0.5, 30) + np.zeros((steps, 30))
        qpos[:, :9] += 0.05 * np.cumsum(actions, axis=0)
        qvel = np.zeros((steps, 29))
        qvel[:, :9] = actions
        frames = _frames(qpos[:, :2], image_size, phase=rng.uniform(0, 6))[:, ::-1]
        demos.append({"obs": {"agentview_rgb": np.ascontiguousarray(frames),
                              "robot0_joint_pos": qpos[:, :9].astype(np.float32)},
                      "actions": actions, "states": np.concatenate([qpos, qvel], axis=-1)})
    return demos


def write_kitchen(root: str, tasks: Sequence[str] = ("microwave", "slide cabinet", "light switch"),
                  n_demos: int = 3, steps: int = 48, image_size: int = 128,
                  seed: int = 2) -> List[str]:
    """One kitchen-layout store a task under ``root``; returns their paths."""
    d = os.path.join(root, KITCHEN_DIR)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, task in enumerate(tasks):
        if task not in KITCHEN_TASK_PROMPTS:
            raise KeyError(f"unknown kitchen task {task!r}")
        paths.append(os.path.join(d, f"kitchen_{_slug(task)}_demo.npz"))
        write_npz_store(paths[-1], kitchen_demos(n_demos, steps, image_size, seed * 1000 + i))
    return paths


def fetch_demos(n_demos: int, steps: int, image_size: int, seed: int) -> List[Dict[str, object]]:
    """``n_demos`` Fetch-layout demos of ``steps`` steps: the gripper
    integrates the 3-d deltas toward a goal, the fingers follow the
    gripper command."""
    rng = np.random.default_rng(seed)
    demos = []
    for _ in range(n_demos):
        actions = _velocities(rng, steps, 4)
        eef = np.array([1.34, 0.75, 0.53]) + 0.03 * np.cumsum(actions[:, :3], axis=0)
        fingers = np.repeat(0.025 * (1.0 + actions[:, 3:]), 2, axis=-1)
        qpos = rng.uniform(-0.1, 0.1, 22) + np.zeros((steps, 22))
        qpos[:, :3] = eef
        goal = rng.uniform([1.2, 0.6, 0.42], [1.5, 0.9, 0.7])
        states = np.concatenate([qpos, np.zeros((steps, 21)), np.tile(goal, (steps, 1))], axis=-1)
        demos.append({"obs": {"agentview_image": _frames(eef - goal, image_size,
                                                         phase=rng.uniform(0, 6)),
                              "robot0_eef_pos": eef.astype(np.float32),
                              "robot0_gripper_qpos": fingers.astype(np.float32)},
                      "actions": actions, "states": states})
    return demos


def write_fetch(root: str, n_demos: int = 8, steps: int = 48, image_size: int = 96,
                seed: int = 3) -> str:
    """The Fetch-layout store under ``root``; returns its path."""
    path = os.path.join(root, FETCH_PATH)
    os.makedirs(root, exist_ok=True)
    write_npz_store(path, fetch_demos(n_demos, steps, image_size, seed))
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="data")
    p.add_argument("--suites", nargs="+", choices=SUITES, default=("toolhang", "libero10"))
    args = p.parse_args(argv)
    writers = {"toolhang": write_toolhang, "libero10": write_libero10, "kitchen": write_kitchen,
               "fetch": write_fetch}
    for suite in args.suites:
        t0 = time.perf_counter()
        out = writers[suite](args.root)
        print(suite, out, f"{time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
