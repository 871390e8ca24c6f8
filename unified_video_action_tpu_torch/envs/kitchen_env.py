"""Real-physics manipulation: the Franka kitchen with software rendering
(the port's own copy of the JAX package's ``envs/kitchen_env.py``:
``KitchenImageEnv`` at :58-183 and ``available`` at :186-198).

The reference evaluates language-conditioned manipulation on the LIBERO
suite (env/libero/envs/env_wrapper.py OffScreenRenderEnv) through robosuite
and GPU rendering. This env is the same kind of benchmark on mujoco's
Franka-kitchen scene (gymnasium_robotics' assets, real contact physics, 7
subtasks with success predicates), rendered by ``envs/render3d.py``.

``KitchenImageEnv`` has the raw LIBERO env API that
``runners.libero_runner._LiberoObsAdapter`` wraps: ``seed`` / ``reset`` ->
dict obs with a bottom-up ``agentview_image`` (mujoco's GL convention,
flipped upright by the adapter as real LIBERO frames are), the old-gym
4-tuple ``step``, ``check_success``, and mujoco-state ``set_init_state`` /
``get_sim_state``: the runner's ``env_backend="kitchen"``.

``mujoco``, ``gymnasium`` and ``gymnasium_robotics`` are imported where an
env is built, not with the module. The task names and prompts live in
``envs/kitchen_tasks.py``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np

from unified_video_action_tpu_torch.envs.kitchen_tasks import (  # noqa: F401
    KITCHEN_TASK_PROMPTS,
    _slug,
    task_from_name,
)

#: the agent-view free camera: the arm, stove, microwave and cabinets
AGENT_CAMERA = {"eye": [1.4, -0.9, 2.9], "target": [-0.35, 0.55, 1.9], "fovy": 50.0}


class KitchenImageEnv:
    """The raw LIBERO API over mujoco's Franka-kitchen physics.

    The parameters follow ``StubLiberoEnv`` and LIBERO's
    ``OffScreenRenderEnv`` (camera_heights/camera_widths); ``tasks`` are the
    subtasks that count toward success. Actions: 9-d [-1, 1] joint and
    gripper velocity commands (the Franka kitchen's convention).
    """

    action_dim = 9

    def __init__(self, tasks: Sequence[str] = ("microwave",), camera_heights: int = 128,
                 camera_widths: int = 128, camera: Optional[dict] = None,
                 max_episode_steps: int = 280, **_):
        import gymnasium as gym
        import gymnasium_robotics

        from unified_video_action_tpu_torch.envs.render3d import SceneRenderer

        gym.register_envs(gymnasium_robotics)
        self.tasks = list(tasks)
        for t in self.tasks:
            if t not in KITCHEN_TASK_PROMPTS:
                raise KeyError(f"unknown kitchen task {t!r}")
        self._env = gym.make("FrankaKitchen-v1", tasks_to_complete=list(self.tasks),
                             max_episode_steps=int(max_episode_steps))
        self._renderer = SceneRenderer(self._env.unwrapped.model, height=camera_heights,
                                       width=camera_widths, camera=dict(camera or AGENT_CAMERA))
        self._seed: Optional[int] = None
        self._last_state_obs: Optional[np.ndarray] = None
        self.action_log: list = []

    # -- the raw LIBERO surface -------------------------------------------

    def seed(self, seed: int):
        self._seed = int(seed)

    @property
    def language_goal(self) -> str:
        return "; ".join(KITCHEN_TASK_PROMPTS[t] for t in self.tasks)

    def reset(self) -> Dict[str, np.ndarray]:
        obs, _info = self._env.reset(seed=self._seed)
        self.action_log = []
        self._last_state_obs = np.asarray(obs["observation"], np.float32)
        return self._obs()

    def step(self, action):
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        if a.shape[-1] != self.action_dim:
            raise ValueError(f"kitchen env expects {self.action_dim}-dim actions, got {a.shape}")
        self.action_log.append(a.copy())
        obs, _r, term, trunc, info = self._env.step(a)
        self._last_state_obs = np.asarray(obs["observation"], np.float32)
        done = bool(term or trunc or self.check_success())
        reward = len(self._completed()) / max(len(self.tasks), 1)
        return self._obs(), float(reward), done, info

    def check_success(self) -> bool:
        return set(self._completed()) >= set(self.tasks)

    def _completed(self) -> Iterable[str]:
        return self._env.unwrapped.episode_task_completions

    # -- mujoco state (the reference's set_init_state, env_wrapper.py:139-147:
    # restore a sim state, then make the obs anew) --------------------------

    def _sim(self):
        u = self._env.unwrapped
        return (u.model, u.data) if hasattr(u, "data") else (u.robot_env.model, u.robot_env.data)

    def get_sim_state(self) -> np.ndarray:
        _, d = self._sim()
        return np.concatenate([np.asarray(d.qpos, np.float64), np.asarray(d.qvel, np.float64)])

    def set_init_state(self, init_state) -> Dict[str, np.ndarray]:
        import mujoco

        m, d = self._sim()
        vec = np.asarray(init_state, np.float64).ravel()
        d.qpos[:] = vec[: m.nq]
        d.qvel[:] = vec[m.nq: m.nq + m.nv]
        mujoco.mj_forward(m, d)
        return self._obs()

    # -- observations ------------------------------------------------------

    def _obs(self) -> Dict[str, np.ndarray]:
        img = self._renderer.render(self._sim()[1])
        state = self._last_state_obs
        if state is None:
            state = np.zeros(59, np.float32)
        return {
            # bottom-up rows (mujoco's offscreen GL convention): the obs
            # adapter flips them with [::-1], as for real LIBERO frames
            "agentview_image": img[::-1].copy(),
            "robot0_joint_pos": state[:9].copy(),
            "kitchen_state": state.copy(),
        }

    def render(self, camera=None) -> np.ndarray:
        return self._renderer.render(self._sim()[1], camera=camera)

    def close(self):
        self._env.close()


#: what the real-physics envs (this one and ``envs/fetch_env.py``) import
PHYSICS_PACKAGES = ("mujoco", "gymnasium", "gymnasium_robotics")


def missing_physics_packages() -> list:
    """The packages of PHYSICS_PACKAGES that do not import here."""
    missing = []
    for name in PHYSICS_PACKAGES:
        try:
            __import__(name)
        except Exception:
            missing.append(name)
    return missing


def available() -> bool:
    """Whether mujoco and gymnasium_robotics (with its kitchen assets) import
    here."""
    return not missing_physics_packages()
