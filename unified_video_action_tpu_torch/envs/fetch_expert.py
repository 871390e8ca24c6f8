"""The scripted pick-and-place expert of the Fetch backend (the port's own
copy of the JAX package's ``envs/fetch_expert.py``).

It stands in for the reference's robomimic demonstration corpora: a phase
machine (hover above the object, descend, grasp, lift and carry to the goal,
hold) that solves FetchPickAndPlace from the state, which
``tools/gen_fetch_demos.py`` runs to record image demonstrations through
``envs/fetch_env.py``. Its noise comes from ``np.random.default_rng(seed)``.
"""

from __future__ import annotations

import numpy as np


class FetchPickPlaceExpert:
    """P-controller phase machine on the 25-dim Fetch state observation."""

    def __init__(self, k: float = 12.0, noise: float = 0.0, seed: int = 0):
        self.k = float(k)
        self.noise = float(noise)
        self.rng = np.random.default_rng(seed)
        self.phase = 0

    def reset(self):
        self.phase = 0

    def act(self, observation: np.ndarray, goal: np.ndarray) -> np.ndarray:
        """observation: the raw 25-dim Fetch vector; goal: (3,) target."""
        o = np.asarray(observation, np.float64)
        grip_pos, obj_pos = o[:3], o[3:6]
        gripper_w = float(o[9] + o[10])  # total finger opening

        above = obj_pos + np.array([0.0, 0.0, 0.08])
        hold = float(np.linalg.norm(obj_pos - grip_pos) < 0.015 and
                     gripper_w < 0.055)

        if self.phase == 0 and np.linalg.norm(above - grip_pos) < 0.02:
            self.phase = 1
        if self.phase == 1 and np.linalg.norm(obj_pos - grip_pos) < 0.012:
            self.phase = 2
        if self.phase == 2 and hold:
            self.phase = 3
        if self.phase == 3 and not hold and gripper_w > 0.07:
            self.phase = 0  # dropped it: start over

        if self.phase == 0:  # hover above the object, gripper open
            delta, grip = above - grip_pos, 1.0
        elif self.phase == 1:  # descend onto it, gripper open
            delta, grip = obj_pos - grip_pos, 1.0
        elif self.phase == 2:  # close
            delta, grip = obj_pos - grip_pos, -1.0
        else:  # transport to the goal, stay closed
            delta, grip = np.asarray(goal) - obj_pos, -1.0

        a = np.empty(4, np.float64)
        a[:3] = self.k * delta
        a[3] = grip
        if self.noise > 0:
            a[:3] += self.rng.normal(0, self.noise, 3)
        return np.clip(a, -1.0, 1.0).astype(np.float32)
