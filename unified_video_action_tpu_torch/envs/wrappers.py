"""Environment vectorization and multi-step wrappers (the port's copy of
the JAX package's ``envs/wrappers.py``: ``MultiStepWrapper``,
``SyncVectorEnv`` and their helpers, numpy only).

Equivalents of the reference's forked gym utilities (SURVEY.md §2.7):
* ``MultiStepWrapper`` (gym_util/multistep_wrapper.py:73-183): stacks the last
  n observations, steps an n-action chunk with early termination, aggregates
  reward with max.
* ``SyncVectorEnv``: the in-process vector env with ``call_each`` (per-env
  function calls) and ``render``; autoreset disabled.

The process-per-env ``AsyncVectorEnv`` (and ``run_dill_function``, which
serves it) is not ported: it ships env factories with ``dill``.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


def stack_repeated(x, n):
    return np.repeat(np.expand_dims(x, axis=0), n, axis=0)


def _stack_last_n(deque_obs, n_steps):
    """Stack the last n observations, replicating the oldest to fill the
    window at episode start (reference stack_last_n_obs semantics)."""
    assert len(deque_obs) > 0
    items = list(deque_obs)[-n_steps:]
    while len(items) < n_steps:
        items.insert(0, items[0])
    if isinstance(items[0], dict):
        return {k: np.stack([o[k] for o in items], axis=0) for k in items[0]}
    return np.stack(items, axis=0)


class MultiStepWrapper:
    """Obs stacking + action chunk stepping (reference semantics: reward
    aggregation 'max', done = any, early exit on termination)."""

    def __init__(
        self,
        env,
        n_obs_steps: int,
        n_action_steps: int,
        max_episode_steps: Optional[int] = None,
        reward_agg_method: str = "max",
    ):
        self.env = env
        self.n_obs_steps = n_obs_steps
        self.n_action_steps = n_action_steps
        self.max_episode_steps = max_episode_steps
        self.reward_agg_method = reward_agg_method
        self.obs: collections.deque = collections.deque(maxlen=n_obs_steps + 1)
        self.reward: List[float] = []
        self.done: List[bool] = []
        self.info: collections.defaultdict = collections.defaultdict(
            lambda: collections.deque(maxlen=n_obs_steps + 1)
        )
        self._elapsed = 0

    def reset(self):
        obs, _ = self.env.reset()
        self.obs = collections.deque([obs], maxlen=self.n_obs_steps + 1)
        self.reward = []
        self.done = []
        self.info = collections.defaultdict(
            lambda: collections.deque(maxlen=self.n_obs_steps + 1)
        )
        self._elapsed = 0
        return _stack_last_n(self.obs, self.n_obs_steps)

    def step(self, action_chunk):
        """action_chunk: (n_action_steps, action_dim)."""
        for act in action_chunk:
            if len(self.done) > 0 and self.done[-1]:
                # termination
                break
            observation, reward, terminated, truncated, info = self.env.step(act)
            self.obs.append(observation)
            self.reward.append(reward)
            self._elapsed += 1
            done = terminated
            if (
                self.max_episode_steps is not None
                and self._elapsed >= self.max_episode_steps
            ):
                done = True
            self.done.append(done)
            self._add_info(info)

        observation = _stack_last_n(self.obs, self.n_obs_steps)
        reward = self._agg_reward()
        done = bool(np.any(self.done))
        info = dict(self.info)
        return observation, reward, done, info

    def _agg_reward(self):
        if not self.reward:
            return 0.0
        if self.reward_agg_method == "max":
            return float(np.max(self.reward))
        if self.reward_agg_method == "sum":
            return float(np.sum(self.reward))
        return float(self.reward[-1])

    def _add_info(self, info):
        for k, v in info.items():
            self.info[k].append(v)

    def render(self, *args, **kwargs):
        return self.env.render(*args, **kwargs)

    def seed(self, seed=None):
        return self.env.seed(seed)

    def get_rewards(self):
        return self.reward

    def get_attr(self, name):
        return getattr(self, name)

    def close(self):
        self.env.close()


class SyncVectorEnv:
    """In-process vector env (the JAX package's twin of its
    ``AsyncVectorEnv``)."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.n_envs = len(self.envs)

    def reset(self):
        return _collate([e.reset() for e in self.envs])

    def step(self, actions):
        results = [e.step(a) for e, a in zip(self.envs, actions)]
        obs, rewards, dones, infos = zip(*results)
        return _collate(list(obs)), np.asarray(rewards), np.asarray(dones), list(infos)

    def render(self, *args, **kwargs):
        return [e.render(*args, **kwargs) for e in self.envs]

    def call(self, name, *args, **kwargs):
        out = []
        for e in self.envs:
            fn = getattr(e, name)
            out.append(fn(*args, **kwargs) if callable(fn) else fn)
        return out

    def call_each(self, name, args_list=None, kwargs_list=None):
        args_list = args_list or [[]] * self.n_envs
        kwargs_list = kwargs_list or [{}] * self.n_envs
        out = []
        for e, a, kw in zip(self.envs, args_list, kwargs_list):
            fn = getattr(e, name)
            out.append(fn(*a, **kw) if callable(fn) else fn)
        return out

    def close(self):
        for e in self.envs:
            e.close()


def _collate(items):
    """Stack a list of (possibly dict) observations into batched arrays."""
    if isinstance(items[0], dict):
        return {k: _collate([it[k] for it in items]) for k in items[0]}
    return np.stack(items, axis=0)
