"""PushT rollout evaluation harness (the port's counterpart of the JAX
package's ``runners/pusht_runner.py``).

Equivalent of the reference's ``PushTImageRunner``
(env_runner/pusht_image_runner.py:23-266): n_train seeded train envs (seeds
train_start_seed..) + n_test eval envs (seeds test_start_seed..), each a
``MultiStepWrapper(PushTImageEnv)`` with a 16-frame obs stack and 8-action
chunks, rolled out to max_steps; score per seed = max coverage reward;
produces ``train/mean_score``, ``test/mean_score`` and per-seed logs.

All envs of a stream step through one batched policy call per control step.
With ``n_streams > 1`` the envs split into several vector envs whose calls
interleave: the policy's ``*_async`` entry points return the action tensor
on the device without waiting for it, so while one stream's call runs on
the card the other streams' envs step on the host. ``vector_env="async"``
steps each stream's envs in spawned processes (``envs/wrappers.AsyncVectorEnv``,
one a seed, built from ``envs/pusht.make_runner_env``), ``"sync"`` in this
one; with the same policy and generator both give the same results.
"""

from __future__ import annotations

import collections
import functools
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from unified_video_action_tpu_torch.envs.pusht import make_runner_env
from unified_video_action_tpu_torch.envs.wrappers import AsyncVectorEnv, SyncVectorEnv

VECTOR_ENVS = {"sync": SyncVectorEnv, "async": AsyncVectorEnv}


class PushTImageRunner:
    env_backend = "real"

    def __init__(
        self,
        output_dir: Optional[str] = None,
        n_train: int = 6,
        n_train_vis: int = 2,
        train_start_seed: int = 0,
        n_test: int = 50,
        n_test_vis: int = 4,
        test_start_seed: int = 100000,
        max_steps: int = 300,
        n_obs_steps: int = 16,
        n_action_steps: int = 8,
        fps: int = 10,
        fix_goal: bool = True,
        legacy_test: bool = True,
        n_envs: Optional[int] = None,
        vector_env: str = "sync",
        latent_cache: bool = False,
        n_streams: int = 1,
        chunk_size: Optional[int] = None,
        **kwargs,
    ):
        if vector_env not in VECTOR_ENVS:
            raise ValueError(f"vector_env must be one of {sorted(VECTOR_ENVS)}, got {vector_env!r}")
        self.vector_env = vector_env
        self.latent_cache = latent_cache
        self.n_streams = n_streams
        self.chunk_size = chunk_size
        self.output_dir = output_dir
        self.n_obs_steps = n_obs_steps
        self.n_action_steps = n_action_steps
        self.max_steps = max_steps
        self.fps = fps

        self.seeds = [train_start_seed + i for i in range(n_train)] + [
            test_start_seed + i for i in range(n_test)
        ]
        self.prefixes = ["train/"] * n_train + ["test/"] * n_test
        self.fix_goal = fix_goal
        self.legacy = legacy_test
        # of the last run: host seconds (wall, building the vector envs with
        # their first reset, env stepping and the number of vector-env steps,
        # the policy's dispatches and the waits for their actions), and each
        # env's last agent position
        self.timing: Dict[str, float] = {}
        self.final_agent_pos = np.zeros((len(self.seeds), 2), dtype=np.float32)

    def _make_env_fns(self):
        """One picklable factory a seed."""
        return [functools.partial(make_runner_env, seed, self.legacy, self.fix_goal,
                                  self.n_obs_steps, self.n_action_steps, self.max_steps)
                for seed in self.seeds]

    def run(
        self,
        policy,
        generator: Optional[torch.Generator] = None,
        chunk_size: Optional[int] = None,
        n_streams: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Roll out all seeds. ``generator`` feeds every policy call's draws,
        in dispatch order (seed 0 on the policy's device if None)."""
        if generator is None:
            generator = torch.Generator(device=getattr(policy, "device", "cpu")).manual_seed(0)
        n_streams = self.n_streams if n_streams is None else n_streams
        env_fns = self._make_env_fns()
        n = len(env_fns)
        chunk_size = chunk_size or self.chunk_size or (
            -(-n // n_streams) if n_streams > 1 else n
        )
        all_rewards = np.zeros(n)
        self.timing = dict.fromkeys(
            ("wall_s", "env_start_s", "env_step_s", "env_steps", "dispatch_s", "dispatches",
             "wait_s"), 0.0)
        t0 = time.perf_counter()

        chunks = [
            (start, env_fns[start : start + chunk_size])
            for start in range(0, n, chunk_size)
        ]
        for g in range(0, len(chunks), max(n_streams, 1)):
            group = chunks[g : g + max(n_streams, 1)]
            self._run_streams(policy, generator, group, all_rewards)
        self.timing["wall_s"] = time.perf_counter() - t0

        log: Dict[str, Any] = {}
        score_groups = collections.defaultdict(list)
        for prefix, seed, r in zip(self.prefixes, self.seeds, all_rewards):
            score_groups[prefix].append(r)
            log[f"{prefix}sim_max_reward_{seed}"] = float(r)
        for prefix, rs in score_groups.items():
            log[f"{prefix}mean_score"] = float(np.mean(rs))
        return log

    def _record(self, s, all_rewards):
        envs = slice(s["start"], s["start"] + len(s["max_reward"]))
        all_rewards[envs] = s["max_reward"]
        self.final_agent_pos[envs] = s["obs"]["agent_pos"][:, -1]

    def _run_streams(self, policy, generator, group, all_rewards):
        """Interleaved rollout of one group of (start, env_fns) chunks."""
        streams = []
        timing = self.timing
        try:
            t = time.perf_counter()
            for start, fns in group:
                streams.append({
                    "start": start,
                    "venv": VECTOR_ENVS[self.vector_env](fns),
                    "done": np.zeros(len(fns), dtype=bool),
                    "max_reward": np.zeros(len(fns)),
                    "steps": 0,
                    "cache": None,
                    "pending": None,
                })
            for s in streams:
                s["obs"] = s["venv"].reset()
            timing["env_start_s"] += time.perf_counter() - t

            def dispatch(s):
                t = time.perf_counter()
                obs_dict = {
                    "image": s["obs"]["image"].astype(np.float32),
                    "agent_pos": s["obs"]["agent_pos"].astype(np.float32),
                }
                if self.latent_cache:
                    # reuse VAE latents for the cond frames that repeat as
                    # the obs window slides by n_action_steps
                    s["pending"], s["cache"] = policy.predict_action_cached_async(
                        obs_dict, cache=s["cache"], n_shift=self.n_action_steps,
                        generator=generator,
                    )
                else:
                    s["pending"] = policy.predict_action_async(obs_dict, generator=generator)
                timing["dispatch_s"] += time.perf_counter() - t
                timing["dispatches"] += 1

            def finished(s):
                return s["done"].all() or s["steps"] >= self.max_steps

            for s in streams:  # fill the pipeline
                dispatch(s)
            while not all(finished(s) for s in streams):
                for s in streams:
                    if s["pending"] is None:
                        continue
                    t = time.perf_counter()
                    nact = torch.as_tensor(s["pending"]).cpu().numpy()
                    timing["wait_s"] += time.perf_counter() - t
                    s["pending"] = None
                    action = nact[:, : self.n_action_steps]
                    t = time.perf_counter()
                    obs, rewards, dones, _ = s["venv"].step(action)
                    timing["env_step_s"] += time.perf_counter() - t
                    timing["env_steps"] += 1
                    s["obs"] = obs
                    s["max_reward"] = np.maximum(s["max_reward"], rewards)
                    s["done"] |= dones
                    s["steps"] += self.n_action_steps
                    if not finished(s):
                        dispatch(s)
                for s in streams:
                    if finished(s) and s["venv"] is not None:
                        self._record(s, all_rewards)
                        s["venv"].close()
                        s["venv"] = None
            for s in streams:
                if s["venv"] is not None:
                    self._record(s, all_rewards)
        finally:
            for s in streams:
                if s["venv"] is not None:
                    s["venv"].close()
