#!/usr/bin/env python3
"""Generate PushT demonstrations with the port's scripted expert: the
counterpart of the JAX package's ``scripts/gen_pusht_demos.py``, the same
episodes (env seeds from ``--seed0``, one ``default_rng(seed0)`` for the
expert's noise, only episodes that reach ``--min-reward`` kept) written as
the port's ``.npz`` replay buffer through ``ReplayBuffer.save``, which
``PushTImageDataset`` loads via ``dataset_path``. ``--max-tries`` bounds
the episodes tried (the JAX script tries until it has kept ``--episodes``).

    python3 unified_video_action_tpu_torch/tools/gen_pusht_demos.py \\
        --out data/pusht_demos.npz --episodes 250 --noise 1.5

Every 25 kept episodes the buffer so far is published under ``--out`` by an
atomic rename, so that training can start on a partial corpus. At the end
``<out stem>_meta.json`` holds the counts and rewards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer  # noqa: E402
from unified_video_action_tpu_torch.envs.pusht import PushTEnv  # noqa: E402
from unified_video_action_tpu_torch.envs.pusht_expert import PushTExpert, rollout_expert  # noqa: E402

PUBLISH_EVERY = 25
KEYS = ("img", "state", "action")


def _publish(episodes: List[Dict[str, np.ndarray]], out: str) -> None:
    """The kept episodes as one replay buffer at ``out``, by an atomic rename."""
    lengths = [len(ep["action"]) for ep in episodes]
    buffer = ReplayBuffer({k: np.concatenate([ep[k] for ep in episodes]) for k in KEYS}
                          if episodes else {}, np.cumsum(lengths, dtype=np.int64))
    tmp = out[: -len(".npz")] + ".tmp.npz"
    buffer.save(tmp)
    os.replace(tmp, out)


def generate(out: str, episodes: int = 250, seed0: int = 20000, max_steps: int = 300,
             min_reward: float = 0.9, noise: float = 1.5, render_size: int = 96,
             max_tries: Optional[int] = None, log: Callable[[str], None] = print) -> dict:
    """Try episodes until ``episodes`` are kept or ``max_tries`` were tried;
    write the buffer to ``out`` (a ``.npz``) and its meta beside it. Returns
    the meta, with every tried episode's max reward under ``tried_rewards``."""
    if not out.endswith(".npz"):
        raise ValueError(f"the port writes .npz replay buffers only, got {out!r}")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    kept_eps: List[Dict[str, np.ndarray]] = []
    rewards, tried_rewards = [], []
    t0 = time.time()
    seed = seed0
    rng = np.random.default_rng(seed0)
    while len(kept_eps) < episodes and (max_tries is None or len(tried_rewards) < max_tries):
        env = PushTEnv(render_action=False, render_size=render_size)
        env.seed(seed)
        env.reset()
        seed += 1
        expert = PushTExpert(noise=noise, rng=rng)
        ep = rollout_expert(env, expert, max_steps=max_steps, render=True)
        tried_rewards.append(ep["max_reward"])
        if ep["max_reward"] < min_reward:
            continue
        kept_eps.append({k: ep[k] for k in KEYS})
        rewards.append(ep["max_reward"])
        kept = len(kept_eps)
        if kept % 5 == 0:
            el = time.time() - t0
            log(f"{kept}/{episodes} kept ({len(tried_rewards)} tried) "
                f"mean_rew {np.mean(rewards):.3f} "
                f"mean_len {np.mean([len(e['action']) for e in kept_eps]):.0f} "
                f"[{el:.0f}s, {el / kept:.1f}s/ep]")
        if kept % PUBLISH_EVERY == 0:
            _publish(kept_eps, out)
    _publish(kept_eps, out)
    lengths = [len(e["action"]) for e in kept_eps]
    meta = {
        "episodes": len(kept_eps),
        "tried": len(tried_rewards),
        "steps": int(sum(lengths)),
        "mean_max_reward": float(np.mean(rewards)) if rewards else None,
        "success_rate_expert": float(np.mean([r >= 1.0 for r in rewards])) if rewards else None,
        "mean_len": float(np.mean(lengths)) if lengths else None,
        "noise": noise,
        "seed0": seed0,
        "max_tries": max_tries,
        "tried_rewards": tried_rewards,
        "seconds": time.time() - t0,
    }
    with open(os.path.splitext(out)[0] + "_meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="the .npz replay buffer to write")
    p.add_argument("--episodes", type=int, default=250)
    p.add_argument("--seed0", type=int, default=20000,
                   help="first env seed (eval uses 0..5 and 100000+; keep clear)")
    p.add_argument("--max-steps", type=int, default=300)
    p.add_argument("--min-reward", type=float, default=0.9)
    p.add_argument("--noise", type=float, default=1.5,
                   help="gaussian action noise (px) for state diversity")
    p.add_argument("--render-size", type=int, default=96)
    p.add_argument("--max-tries", type=int, default=None,
                   help="stop after this many tried episodes, kept or not")
    args = p.parse_args(argv)
    meta = generate(args.out, args.episodes, args.seed0, args.max_steps, args.min_reward,
                    args.noise, args.render_size, args.max_tries,
                    log=lambda m: print(m, flush=True))
    print(json.dumps(meta, indent=2), flush=True)


if __name__ == "__main__":
    main()
