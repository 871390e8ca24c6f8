"""Real-physics tabletop manipulation behind the robosuite raw env API (the
port's own copy of the JAX package's ``envs/fetch_env.py``:
``FetchImageEnv`` at :28-192).

The reference's robomimic evaluation drives robosuite through
``EnvRobosuite`` (shape_meta obs dicts, ``reset_to({"states": ...})`` demo
resets, the old-gym 4-tuple step; env/robomimic/robomimic_image_wrapper.py:
10-113). This env has the same surface over gymnasium_robotics' mujoco
FetchPickAndPlace scene, its images from ``envs/render3d.py`` with the goal
drawn as a green sphere: ``runners.robomimic_runner``'s
``env_backend="fetch"``, with seeded goal and object resets and mujoco
state round trips through ``get_state`` / ``reset_to``.

Actions follow Fetch: 4-d [-1, 1] (dx, dy, dz, gripper). ``mujoco``,
``gymnasium`` and ``gymnasium_robotics`` are imported where an env is built.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

#: a third-person view of the gripper, the object and the goal over the table
AGENT_CAMERA = {"eye": [1.95, 0.40, 0.95], "target": [1.33, 0.78, 0.42], "fovy": 45.0}
#: the goal marker drawn into every frame
GOAL_MARKER = {"size": 0.035, "rgba": [0.15, 0.75, 0.2]}


class FetchImageEnv:
    """robosuite's EnvRobosuite API over mujoco's Fetch pick-and-place.

    ``reset`` draws its episode seed from the global ``np.random``
    (``np.random.randint(0, 2**31 - 1)``), as EnvRobosuite is seeded: the
    runner's wrapper calls ``np.random.seed(seed)`` before it, so seeded
    resets repeat and unseeded ones vary.
    """

    action_dim = 4

    def __init__(self, shape_meta: Optional[dict] = None, seed: int = 0, camera_heights: int = 84,
                 camera_widths: int = 84, env_id: str = "FetchPickAndPlace-v4", **_):
        import gymnasium as gym
        import gymnasium_robotics
        import mujoco

        from unified_video_action_tpu_torch.envs.render3d import SceneRenderer

        gym.register_envs(gymnasium_robotics)
        self.shape_meta = shape_meta or {"obs": {
            "agentview_image": {"shape": [3, camera_heights, camera_widths]},
            "robot0_eef_pos": {"shape": [3]},
            "robot0_gripper_qpos": {"shape": [2]},
        }}
        # the image size of shape_meta's first image, where it has one
        for spec in self.shape_meta.get("obs", {}).values():
            shape = tuple(spec.get("shape", ()))
            if len(shape) == 3:
                camera_heights, camera_widths = shape[1], shape[2]
                break
        self._env = gym.make(env_id)
        u = self._env.unwrapped
        self.model, self.data = u.model, u.data
        # the object is table-grey: a colour makes the frames carry the task's state
        gid = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_GEOM, "object0")
        if gid >= 0:
            self.model.geom_rgba[gid] = [0.85, 0.15, 0.1, 1.0]
        self._renderer = SceneRenderer(self.model, height=camera_heights, width=camera_widths,
                                       camera=dict(AGENT_CAMERA))
        self._seed = int(seed)
        self._raw_obs: Optional[dict] = None
        self.action_log: list = []

    # -- robosuite's EnvRobosuite surface ---------------------------------

    def reset(self) -> Dict[str, np.ndarray]:
        seed = int(np.random.randint(0, 2**31 - 1))
        obs, _info = self._env.reset(seed=seed)
        self._raw_obs = obs
        self.action_log = []
        return self._obs()

    def reset_to(self, state: dict) -> Dict[str, np.ndarray]:
        """Restore a mujoco state vector [qpos, qvel, goal(3)] (the
        reference's robomimic_image_wrapper.py:61-67)."""
        import mujoco

        if self._raw_obs is None:
            # gymnasium wants a reset before the sim state is overwritten
            # (robomimic's EnvRobosuite allows reset_to first)
            self._env.reset(seed=0)
        vec = np.asarray(state["states"], np.float64).ravel()
        m, d = self.model, self.data
        nq, nv = m.nq, m.nv
        if len(vec) < nq + nv + 3:
            raise ValueError(f"state vector needs nq+nv+3={nq + nv + 3} entries, got {len(vec)}")
        d.qpos[:] = vec[:nq]
        d.qvel[:] = vec[nq: nq + nv]
        self._env.unwrapped.goal = vec[nq + nv: nq + nv + 3].copy()
        mujoco.mj_forward(m, d)
        self._raw_obs = self._env.unwrapped._get_obs()
        self.action_log = []
        return self._obs()

    def get_state(self) -> dict:
        d = self.data
        return {"states": np.concatenate([np.asarray(d.qpos, np.float64),
                                          np.asarray(d.qvel, np.float64),
                                          np.asarray(self._env.unwrapped.goal, np.float64)])}

    def get_observation(self) -> Dict[str, np.ndarray]:
        return self._obs()

    def step(self, action):
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        if a.shape[-1] != self.action_dim:
            raise ValueError(f"fetch env expects {self.action_dim}-dim actions, got {a.shape}")
        self.action_log.append(a.copy())
        obs, _r, term, trunc, info = self._env.step(a)
        self._raw_obs = obs
        success = float(info.get("is_success", 0.0))
        done = bool(term or trunc or success > 0.5)
        return self._obs(), success, done, info

    def is_success(self) -> Dict[str, bool]:
        """robomimic's EnvRobosuite.is_success(): {"task": bool}."""
        obs = self._raw_obs
        if obs is None:
            return {"task": False}
        d = float(np.linalg.norm(np.asarray(obs["achieved_goal"])
                                 - np.asarray(self._env.unwrapped.goal)))
        return {"task": d < 0.05}

    # -- observations ------------------------------------------------------

    def _markers(self):
        return [dict(GOAL_MARKER, pos=np.asarray(self._env.unwrapped.goal, np.float32))]

    def _obs(self) -> Dict[str, np.ndarray]:
        state = np.asarray(self._raw_obs["observation"], np.float32)
        goal = np.asarray(self._env.unwrapped.goal, np.float32)
        img = self._renderer.render(self.data, markers=self._markers())
        full = {
            # bottom-up rows as GL offscreen buffers have them
            "agentview_image": img[::-1].copy(),
            "robot0_eef_pos": state[:3].copy(),
            "robot0_gripper_qpos": state[9:11].copy(),
            "object": np.concatenate([state[3:6], state[11:14]]),
            "goal": goal,
        }
        out = {}
        for k, spec in self.shape_meta.get("obs", {}).items():
            out[k] = full[k] if k in full else np.zeros(tuple(spec.get("shape", ())), np.float32)
        out.setdefault("agentview_image", full["agentview_image"])  # the render stream, always
        return out

    def render(self, camera=None) -> np.ndarray:
        return self._renderer.render(self.data, camera=camera, markers=self._markers())

    def close(self):
        self._env.close()
