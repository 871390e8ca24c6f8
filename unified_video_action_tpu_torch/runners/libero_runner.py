"""The LIBERO rollout harness (the port's counterpart of the JAX package's
``runners/libero_runner.py``: ``LiberoImageRunner`` at :39-166 with
its ``kitchen`` backend at :71-99, ``_LiberoObsAdapter`` at :169-203,
``LIBERO10_TASK_NAMES`` and ``make_libero_runners`` at :206-242).

Equivalent of the reference's ``LiberoImageRunner``
(env_runner/libero_image_runner.py:69-431): one runner per task store, each
with the language goal of its file name passed to ``predict_action``, n_test
seeded envs, success ending an episode, a guard against non-finite actions,
the rot6d -> axis-angle undo. Each runner's ``test/mean_score`` averages into
``test_mean_score`` in ``runners.base.env_rollout``.

Backends: ``stub`` (``envs/stub.StubLiberoEnv``) runs anywhere; ``libero``
needs the LIBERO benchmark package; ``kitchen`` (``envs/kitchen_env.
KitchenImageEnv`` at 128 px: mujoco physics) needs mujoco, gymnasium and
gymnasium_robotics. Where those are missing the runner raises an
ImportError naming them; no backend switches to the stub by itself. On the
kitchen backend a runner's task comes from its file name
(``kitchen_<task>_demo.*``), its goal is that task's prompt and its actions
are the kitchen's 9-d joint velocities, stepped as they come (no rot6d
undo); with no stores, ``make_libero_runners`` makes one runner a kitchen
task. The stub takes actions as wide as the env would step
(``runners.base.env_action_dim`` of the task's ``shape_meta``, which
``load_env_runner`` passes): 7-d after the undo, the kitchen's 9-d as the
policy makes them, 7-d where no shape_meta is given (JAX's stub takes 7-d
only, so JAX cannot run the kitchen's config on it).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from unified_video_action_tpu_torch.data.libero_dataset import (
    language_from_filename,
    store_stem,
    task_stores,
)
from unified_video_action_tpu_torch.envs.kitchen_tasks import (
    KITCHEN_TASK_PROMPTS,
    _slug,
    task_from_name,
)
from unified_video_action_tpu_torch.envs.wrappers import MultiStepWrapper, SyncVectorEnv
from unified_video_action_tpu_torch.runners.base import (
    BaseImageRunner,
    env_action_dim,
    require_mujoco,
    undo_transform_action,
)
from unified_video_action_tpu_torch.utils.rotation import RotationTransformer


def _require_backend(env_backend: str) -> None:
    """Raise where ``env_backend`` cannot run here, naming what is missing."""
    if env_backend not in ("libero", "stub", "kitchen"):
        raise ValueError(f"unknown env_backend {env_backend!r}")
    if env_backend == "kitchen":
        require_mujoco("LiberoImageRunner's 'kitchen' backend")
    if env_backend == "libero":
        _require_libero()


def _require_libero():
    try:
        import libero.libero.envs  # noqa: F401
    except ImportError as e:
        raise ImportError("LiberoImageRunner's 'libero' backend needs the LIBERO benchmark "
                          "package (libero), which is not installed; env_backend='stub' runs the "
                          "runner without it (its scores measure nothing)") from e


class LiberoImageRunner(BaseImageRunner):
    def __init__(
        self,
        dataset_path: str,
        output_dir: Optional[str] = None,
        n_test: int = 10,
        test_start_seed: int = 100000,
        max_steps: int = 500,
        n_obs_steps: int = 16,
        n_action_steps: int = 8,
        bddl_file: Optional[str] = None,
        abs_action: bool = True,
        env_backend: str = "libero",
        shape_meta: Optional[dict] = None,
        **kwargs,
    ):
        super().__init__(output_dir)
        _require_backend(env_backend)
        self.env_backend = env_backend
        self.abs_action = abs_action
        if abs_action:
            self.rot_tf = RotationTransformer("axis_angle", "rotation_6d")
        self.dataset_path = dataset_path
        self.language_goal = language_from_filename(dataset_path)
        self.log_prefix = store_stem(dataset_path) + "/"
        self.n_test = n_test
        self.test_start_seed = test_start_seed
        self.max_steps = max_steps
        self.n_obs_steps = n_obs_steps
        self.n_action_steps = n_action_steps
        self.bddl_file = bddl_file
        self.kitchen_task = None
        if env_backend == "kitchen":
            self.kitchen_task = kwargs.get("kitchen_task") or task_from_name(dataset_path)
            if self.kitchen_task is None:
                raise ValueError(f"cannot resolve a kitchen task from {dataset_path!r}")
            self.language_goal = KITCHEN_TASK_PROMPTS[self.kitchen_task]
            self.abs_action = False  # 9-d joint velocities, not a pose and rot6d
        # the stub's action width, from the task's shape_meta
        self.stub_action_dim = env_action_dim(shape_meta, self.abs_action)
        # of the last run: the raw envs (a stub keeps its action_log) and the
        # (B, n_action_steps, A) actions stepped at each control step
        self.raw_envs: list = []
        self.env_actions: list = []

    def _make_raw_env(self):
        if self.env_backend == "kitchen":
            from unified_video_action_tpu_torch.envs.kitchen_env import KitchenImageEnv

            return KitchenImageEnv(tasks=[self.kitchen_task], camera_heights=128,
                                   camera_widths=128)
        if self.env_backend == "stub":
            from unified_video_action_tpu_torch.envs.stub import StubLiberoEnv

            return StubLiberoEnv(camera_heights=128, camera_widths=128,
                                 action_dim=self.stub_action_dim)
        from libero.libero.envs import OffScreenRenderEnv

        return OffScreenRenderEnv(bddl_file_name=self.bddl_file, camera_heights=128,
                                  camera_widths=128)

    def _make_env_fns(self):
        fns = []
        for i in range(self.n_test):
            seed = self.test_start_seed + i

            def make(seed=seed):
                env = self._make_raw_env()
                env.seed(seed)
                return MultiStepWrapper(_LiberoObsAdapter(env), self.n_obs_steps,
                                        self.n_action_steps, self.max_steps)

            fns.append(("test/", seed, make))
        return fns

    def run(self, policy, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Roll out the test seeds in one vector env, one batched
        ``policy.predict_action`` call with the task's language goal per
        control step, its draws from ``generator`` (seed 0 on the policy's
        device if None)."""
        if generator is None:
            generator = torch.Generator(device=getattr(policy, "device", "cpu")).manual_seed(0)
        fns = self._make_env_fns()
        venv = SyncVectorEnv([f for _, _, f in fns])
        self.raw_envs = [e.env.env for e in venv.envs]
        self.env_actions = []
        try:
            obs = venv.reset()
            done = np.zeros(len(fns), dtype=bool)
            success = np.zeros(len(fns))
            steps = 0
            while not done.all() and steps < self.max_steps:
                result = policy.predict_action(obs, generator=generator,
                                               language_goal=self.language_goal)
                action = np.asarray(result["action"])
                if not np.isfinite(action).all():  # NaN guard (:347-349)
                    raise RuntimeError("non-finite action from policy")
                env_action = action
                if self.abs_action:  # rot6d -> axis-angle (:352-355)
                    env_action = undo_transform_action(action, self.rot_tf)
                self.env_actions.append(env_action)
                obs, rewards, dones, infos = venv.step(env_action)
                success = np.maximum(success, rewards)
                done |= dones
                steps += self.n_action_steps
        finally:
            venv.close()

        log: Dict[str, Any] = {}
        for (prefix, seed, _), r in zip(fns, success):
            log[f"{prefix}sim_max_reward_{seed}"] = float(r)
        log["test/mean_score"] = float(np.mean(success))
        return log


class _LiberoObsAdapter:
    """LIBERO env dict obs -> the policy's expected keys."""

    def __init__(self, env):
        self.env = env

    def reset(self):
        obs = self.env.reset()
        return self._convert(obs), {}

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        success = float(self.env.check_success()) if hasattr(
            self.env, "check_success") else float(reward)
        return self._convert(obs), success, bool(done or success > 0.5), False, info

    @staticmethod
    def _convert(obs):
        img = obs["agentview_image"][::-1]  # flip like training data
        return {"agentview_rgb": np.moveaxis(img.astype(np.float32) / 255.0, -1, 0)}

    def seed(self, seed=None):
        if hasattr(self.env, "seed"):
            self.env.seed(seed)

    def render(self, *a, **k):
        return None

    def close(self):
        self.env.close()


#: libero-10 task names (reference env/libero benchmark suite), which name
#: the stub backend's runners when no task stores are staged
LIBERO10_TASK_NAMES = (
    "LIVING_ROOM_SCENE2_put_both_the_alphabet_soup_and_the_tomato_sauce_in_the_basket_demo",
    "LIVING_ROOM_SCENE2_put_both_the_cream_cheese_box_and_the_butter_in_the_basket_demo",
    "KITCHEN_SCENE3_turn_on_the_stove_and_put_the_moka_pot_on_it_demo",
    "KITCHEN_SCENE4_put_the_black_bowl_in_the_bottom_drawer_of_the_cabinet_and_close_it_demo",
    "LIVING_ROOM_SCENE5_put_the_white_mug_on_the_left_plate_and_put_the_yellow_and_white_mug_on_the_right_plate_demo",
    "STUDY_SCENE1_pick_up_the_book_and_place_it_in_the_back_compartment_of_the_caddy_demo",
    "LIVING_ROOM_SCENE6_put_the_white_mug_on_the_plate_and_put_the_chocolate_pudding_to_the_right_of_the_plate_demo",
    "LIVING_ROOM_SCENE1_put_both_the_alphabet_soup_and_the_cream_cheese_box_in_the_basket_demo",
    "KITCHEN_SCENE8_put_both_moka_pots_on_the_stove_demo",
    "KITCHEN_SCENE6_put_the_yellow_and_white_mug_in_the_microwave_and_close_it_demo",
)


def make_libero_runners(dataset_dir: Optional[str] = None, output_dir: Optional[str] = None,
                        env_backend: str = "libero", **kwargs) -> List[LiberoImageRunner]:
    """One runner per task store under ``dataset_dir`` (``*.hdf5`` and
    ``*.npz``, sorted by name); with no stores staged, the stub backend takes
    the libero-10 task names and the kitchen backend its 7 tasks."""
    _require_backend(env_backend)
    files = task_stores(dataset_dir) if dataset_dir else []
    if not files and env_backend == "stub":
        files = [name + ".hdf5" for name in LIBERO10_TASK_NAMES]
    if not files and env_backend == "kitchen":
        files = [f"kitchen_{_slug(t)}_demo.hdf5" for t in KITCHEN_TASK_PROMPTS]
    return [LiberoImageRunner(path, output_dir=output_dir, env_backend=env_backend, **kwargs)
            for path in files]
