"""Deterministic stub environments standing in for the LIBERO and robosuite
simulators (the port's own copy of the JAX package's ``envs/stub.py``,
numpy only: ``_StubSim``, ``StubLiberoEnv``, ``StubRobosuiteEnv``).

Neither simulator is installed where the port runs. The stubs mimic the RAW
env APIs that the runners' adapters wrap (old-gym 4-tuple step, HWC uint8
image obs, ``check_success``, ``reset_to`` init states), so the whole runner
stack (obs adaptation, ``MultiStepWrapper`` chunking, the rot6d ->
axis-angle undo, the NaN guard, the averaging of scores per task) runs
without the real sims. They are the runners' ``env_backend="stub"``.

Everything derives from the seed: success fires at a seed-derived step (or
never), whatever the actions, so a stub score measures nothing about the
policy; every action received is kept in ``action_log``, so a test can hold
the exact action stream the runner delivered. Images, success steps, rewards
and ``action_log`` are bit-equal to the JAX package's stubs for the same
seed and action stream.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class _StubSim:
    """Seeded core: deterministic images + a success schedule."""

    def __init__(self, seed: int, image_hw: Tuple[int, int],
                 action_dim: Optional[int], success_period: int = 40):
        self.seed_val = int(seed)
        self.image_hw = image_hw
        self.action_dim = action_dim
        # seeds where seed % 3 == 0 succeed at a seed-dependent step
        self.success_step = (
            10 + (self.seed_val % 7) * 5 if self.seed_val % 3 == 0 else None
        )
        self.t = 0
        self.action_log: list = []

    def reset(self):
        self.t = 0
        self.action_log = []

    def step(self, action):
        a = np.asarray(action, dtype=np.float32)
        if self.action_dim is not None and a.shape[-1] != self.action_dim:
            raise ValueError(
                f"stub env expected {self.action_dim}-dim action, got {a.shape}"
            )
        self.action_log.append(a.copy())
        self.t += 1

    @property
    def success(self) -> bool:
        return self.success_step is not None and self.t >= self.success_step

    def image(self) -> np.ndarray:
        """Deterministic HWC uint8 frame encoding (seed, t)."""
        h, w = self.image_hw
        yy, xx = np.mgrid[0:h, 0:w]
        base = (yy * 7 + xx * 13 + self.seed_val * 31 + self.t * 5) % 256
        return np.stack([base, (base + 85) % 256, (base + 170) % 256],
                        axis=-1).astype(np.uint8)


class StubLiberoEnv:
    """Raw-LIBERO-API stub (OffScreenRenderEnv surface as used by
    runners.libero_runner._LiberoObsAdapter): dict obs with
    ``agentview_image`` HWC uint8, old-gym 4-tuple step, ``check_success``."""

    def __init__(self, camera_heights: int = 128, camera_widths: int = 128,
                 action_dim: Optional[int] = 7, **_):
        self._sim = _StubSim(0, (camera_heights, camera_widths), action_dim)

    def seed(self, seed: int):
        self._sim = _StubSim(seed, self._sim.image_hw, self._sim.action_dim)

    def reset(self):
        self._sim.reset()
        return self._obs()

    def step(self, action):
        self._sim.step(action)
        return self._obs(), float(self._sim.success), self._sim.success, {}

    def check_success(self) -> bool:
        return self._sim.success

    def set_init_state(self, init_state):
        """Real-API parity (reference env/libero/envs/env_wrapper.py:139-147:
        ``set_init_state`` regenerates obs from a mujoco state): the stub
        records the state, derives a deterministic success schedule from it,
        and returns the regenerated obs."""
        self.init_state = np.asarray(init_state)
        self._sim = _StubSim(
            int(abs(float(self.init_state.flat[0])) * 1000) % 100000,
            self._sim.image_hw,
            self._sim.action_dim,
        )
        return self._obs()

    def _obs(self) -> Dict[str, np.ndarray]:
        return {"agentview_image": self._sim.image()}

    @property
    def action_log(self):
        return self._sim.action_log

    def close(self):
        pass


class StubRobosuiteEnv:
    """Raw-robosuite-API stub (EnvRobosuite surface as used by
    runners.robomimic_runner.RobomimicImageWrapper): shape_meta-driven obs
    dict, ``reset_to({"states": ...})`` demo-state resets, 4-tuple step."""

    def __init__(self, shape_meta: dict, seed: int = 0,
                 action_dim: Optional[int] = 7, **_):
        self.shape_meta = shape_meta
        image_hw = (84, 84)
        for k, spec in shape_meta.get("obs", {}).items():
            shape = tuple(spec.get("shape", ()))
            if len(shape) == 3:
                image_hw = (shape[1], shape[2])
                break
        self._sim = _StubSim(seed, image_hw, action_dim)
        self.init_state = None

    def reset(self):
        self._sim.reset()
        return self._obs()

    def reset_to(self, state: dict):
        self.init_state = np.asarray(state["states"])
        self._sim.reset()
        return self._obs()

    def get_state(self) -> dict:
        """Real-API parity (robomimic EnvRobosuite.get_state, used by the
        reference wrapper's seed->state cache,
        robomimic_image_wrapper.py:86-89): returns a dict with a ``states``
        vector that round-trips through ``reset_to``."""
        return {"states": np.array([float(self._sim.seed_val)], np.float64)}

    def get_observation(self) -> Dict[str, np.ndarray]:
        """Real-API parity (EnvRobosuite.get_observation, reference
        robomimic_image_wrapper.py:55-57)."""
        return self._obs()

    def step(self, action):
        self._sim.step(action)
        return self._obs(), float(self._sim.success), self._sim.success, {}

    def _obs(self) -> Dict[str, np.ndarray]:
        obs = {}
        for k, spec in self.shape_meta.get("obs", {}).items():
            shape = tuple(spec.get("shape", ()))
            if len(shape) == 3:  # CHW spec -> raw env emits HWC uint8
                obs[k] = self._sim.image()
            else:
                obs[k] = np.full(shape,
                                 (self._sim.seed_val % 11) * 0.1,
                                 dtype=np.float32)
        return obs

    @property
    def action_log(self):
        return self._sim.action_log

    def close(self):
        pass
