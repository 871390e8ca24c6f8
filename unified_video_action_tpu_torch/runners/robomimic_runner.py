"""The robomimic (robosuite) rollout harness (the port's counterpart of the
JAX package's ``runners/robomimic_runner.py``: ``RobomimicImageWrapper`` at
:37-79 and ``RobomimicImageRunner`` at :82-236, its ``fetch`` backend at
:112-170).

Equivalent of the reference's ``RobomimicImageRunner``
(env_runner/robomimic_image_runner.py:46-385): n_train envs reset to the
first state of the store's demos (train/) and n_test seeded envs (test/),
shape_meta-driven obs dicts, the abs-action rot6d -> axis-angle undo before
stepping, ``MultiStepWrapper`` chunking, each episode's max reward, mean
scores per prefix.

Backends: ``stub`` (``envs/stub.StubRobosuiteEnv``) runs anywhere;
``robosuite`` needs robosuite and robomimic; ``fetch``
(``envs/fetch_env.FetchImageEnv``: mujoco's Fetch pick-and-place at the
shape_meta's image size, 4-d delta actions stepped as they come, no rot6d
undo) needs mujoco, gymnasium and gymnasium_robotics. Where those are
missing the runner raises an ImportError naming them; no backend switches
to the stub by itself. The train episodes reset to the first state of the
store's demos through ``reset_to``; on ``fetch`` with no store, to the
states of the env's resets at seeds ``train_start_idx + i``. The stub takes
the actions the env would (``env_action_dim``: Fetch's 4-d where the
shape_meta says so; JAX's stub takes 7-d only, so JAX cannot run Fetch's
config on it).
"""

from __future__ import annotations

import collections
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from unified_video_action_tpu_torch.envs.wrappers import MultiStepWrapper, SyncVectorEnv
from unified_video_action_tpu_torch.runners.base import (
    BaseImageRunner,
    env_action_dim,
    require_mujoco,
    undo_transform_action,
)
from unified_video_action_tpu_torch.utils.rotation import RotationTransformer


def _require_robosuite():
    try:
        import robomimic.utils.env_utils  # noqa: F401
        import robosuite  # noqa: F401
    except ImportError as e:
        raise ImportError("RobomimicImageRunner's 'robosuite' backend needs the robosuite and "
                          "robomimic packages, which are not installed; env_backend='stub' runs "
                          "the runner without them (its scores measure nothing)") from e


class RobomimicImageWrapper:
    """gym-ify a robosuite EnvRobosuite: shape_meta-driven obs extraction +
    init-state reset (reference env/robomimic/robomimic_image_wrapper.py)."""

    def __init__(self, env, shape_meta: dict, init_state=None, seed=None,
                 render_obs_key: str = "agentview_image"):
        self.env = env
        self.obs_keys = list(shape_meta["obs"].keys())
        self.init_state = init_state
        self._seed = seed
        self.render_obs_key = render_obs_key
        self.render_cache = None

    def _extract_obs(self, raw) -> Dict[str, np.ndarray]:
        obs = {}
        for k in self.obs_keys:
            v = np.asarray(raw[k])
            if v.ndim == 3:  # HWC image -> CHW float
                self.render_cache = v
                v = np.moveaxis(v.astype(np.float32) / 255.0, -1, 0)
            obs[k] = v
        return obs

    def reset(self):
        if self.init_state is not None:
            raw = self.env.reset_to({"states": self.init_state})
        else:
            if self._seed is not None:
                np.random.seed(self._seed)
            raw = self.env.reset()
        return self._extract_obs(raw), {}

    def step(self, action):
        raw, reward, done, info = self.env.step(action)
        return self._extract_obs(raw), float(reward), bool(done), False, info

    def render(self, *a, **k):
        return self.render_cache

    def seed(self, seed=None):
        self._seed = seed

    def close(self):
        self.env.close()


class RobomimicImageRunner(BaseImageRunner):
    def __init__(
        self,
        output_dir: Optional[str] = None,
        dataset_path: Optional[str] = None,
        shape_meta: Optional[dict] = None,
        n_train: int = 6,
        train_start_idx: int = 0,
        n_test: int = 50,
        test_start_seed: int = 100000,
        max_steps: int = 700,
        n_obs_steps: int = 16,
        n_action_steps: int = 8,
        abs_action: bool = True,
        env_backend: str = "robosuite",
        **kwargs,
    ):
        super().__init__(output_dir)
        if env_backend not in ("robosuite", "stub", "fetch"):
            raise ValueError(f"unknown env_backend {env_backend!r}")
        if env_backend == "fetch":
            require_mujoco("RobomimicImageRunner's 'fetch' backend")
            abs_action = False  # 4-d deltas, not a pose and rot6d
        if env_backend == "robosuite":
            _require_robosuite()
        self.env_backend = env_backend
        self.dataset_path = dataset_path
        self.shape_meta = shape_meta or {}
        self.n_train = n_train
        self.train_start_idx = train_start_idx
        self.n_test = n_test
        self.test_start_seed = test_start_seed
        self.max_steps = max_steps
        self.n_obs_steps = n_obs_steps
        self.n_action_steps = n_action_steps
        self.abs_action = abs_action
        self.rot_tf = RotationTransformer("axis_angle", "rotation_6d")
        # of the last run: the raw envs (a stub keeps its action_log) and the
        # (B, n_action_steps, A) actions stepped at each control step
        self.raw_envs: list = []
        self.env_actions: list = []

    @property
    def env_action_dim(self) -> int:
        """The width of the actions the env steps (``runners.base.
        env_action_dim`` of the shape_meta)."""
        return env_action_dim(self.shape_meta, self.abs_action)

    def undo_transform_action(self, action: np.ndarray) -> np.ndarray:
        """(..., 10) pos3 + rot6d + grip -> (..., 7) pos3 + axis_angle +
        grip (reference :368-385); two arms 20 -> 14."""
        if not self.abs_action:
            return action
        return undo_transform_action(action, self.rot_tf)

    def _raw_env_factory(self):
        """make_raw(seed) -> a robosuite-API env of the runner's backend."""
        if self.env_backend == "stub":
            from unified_video_action_tpu_torch.envs.stub import StubRobosuiteEnv

            return lambda seed=0: StubRobosuiteEnv(self.shape_meta, seed=seed,
                                                   action_dim=self.env_action_dim)
        if self.env_backend == "fetch":
            from unified_video_action_tpu_torch.envs.fetch_env import FetchImageEnv

            return lambda seed=0: FetchImageEnv(self.shape_meta, seed=seed)
        import robomimic.utils.env_utils as EnvUtils
        import robomimic.utils.file_utils as FileUtils

        env_meta = FileUtils.get_env_metadata_from_dataset(self.dataset_path)
        if self.abs_action:
            env_meta["env_kwargs"]["controller_configs"]["control_delta"] = False
        # robosuite is seeded by the wrapper's np.random.seed on reset
        return lambda seed=0: EnvUtils.create_env_from_metadata(
            env_meta=env_meta, render=False, render_offscreen=True, use_image_obs=True)

    def _train_init_states(self):
        """The first state of each train episode's demo in the store (HDF5 or
        ``.npz``); where no store is staged, zeros for the stub backend and the
        states of seeded resets for fetch."""
        if self.dataset_path and os.path.exists(self.dataset_path):
            from unified_video_action_tpu_torch.data.robomimic_dataset import RobomimicStore

            with RobomimicStore(self.dataset_path) as store:
                return [np.asarray(store[f"data/demo_{self.train_start_idx + i}/states"][0])
                        for i in range(self.n_train)]
        if self.env_backend == "stub":
            return [np.zeros(1, np.float32) for _ in range(self.n_train)]
        if self.env_backend == "fetch":
            from unified_video_action_tpu_torch.envs.fetch_env import FetchImageEnv

            env = FetchImageEnv(self.shape_meta)
            states = []
            for i in range(self.n_train):
                np.random.seed(self.train_start_idx + i)
                env.reset()
                states.append(env.get_state()["states"])
            env.close()
            return states
        raise FileNotFoundError(self.dataset_path)

    def _make_envs(self):
        make_raw = self._raw_env_factory()
        fns = []
        for i, init_state in enumerate(self._train_init_states()):
            def make(i=i, init_state=init_state):
                w = RobomimicImageWrapper(make_raw(i), self.shape_meta, init_state)
                return MultiStepWrapper(w, self.n_obs_steps, self.n_action_steps, self.max_steps)

            fns.append(("train/", self.train_start_idx + i, make))
        for i in range(self.n_test):
            seed = self.test_start_seed + i

            def make(seed=seed):
                w = RobomimicImageWrapper(make_raw(seed), self.shape_meta, seed=seed)
                return MultiStepWrapper(w, self.n_obs_steps, self.n_action_steps, self.max_steps)

            fns.append(("test/", seed, make))
        return fns

    def run(self, policy, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Roll out every train and test episode in one vector env, one
        batched ``policy.predict_action`` call per control step, its draws
        from ``generator`` (seed 0 on the policy's device if None)."""
        if generator is None:
            generator = torch.Generator(device=getattr(policy, "device", "cpu")).manual_seed(0)
        fns = self._make_envs()
        venv = SyncVectorEnv([f for _, _, f in fns])
        self.raw_envs = [e.env.env for e in venv.envs]
        self.env_actions = []
        try:
            obs = venv.reset()
            done = np.zeros(len(fns), dtype=bool)
            max_reward = np.zeros(len(fns))
            steps = 0
            while not done.all() and steps < self.max_steps:
                result = policy.predict_action(obs, generator=generator)
                env_action = self.undo_transform_action(np.asarray(result["action"]))
                self.env_actions.append(env_action)
                obs, rewards, dones, infos = venv.step(env_action)
                max_reward = np.maximum(max_reward, rewards)
                done |= dones
                steps += self.n_action_steps
        finally:
            venv.close()

        log: Dict[str, Any] = {}
        groups = collections.defaultdict(list)
        for (prefix, seed, _), r in zip(fns, max_reward):
            groups[prefix].append(r)
            log[f"{prefix}sim_max_reward_{seed}"] = float(r)
        for prefix, rs in groups.items():
            log[f"{prefix}mean_score"] = float(np.mean(rs))
        return log
