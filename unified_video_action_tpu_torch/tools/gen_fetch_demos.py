#!/usr/bin/env python3
"""Record Fetch pick-and-place image demonstrations with the port's scripted
expert: the counterpart of the JAX package's ``scripts/gen_fetch_demos.py``,
the same episodes and file.

It drives ``envs/fetch_env.FetchImageEnv`` (so the demos' frames are the
evaluation's) with ``envs/fetch_expert.FetchPickPlaceExpert`` and writes a
robomimic-layout HDF5, ``data/demo_i/{obs/<key>, actions, states}``, which
``data.robomimic_dataset`` reads and whose states the runner's train
episodes ``reset_to``. Only successful episodes are kept; ``--max-tries``
bounds the episodes tried (the JAX script tries until it has kept
``--episodes``). ``data.attrs["env_args"]`` names the env; ``<out
stem>_meta.json`` holds the counts. Needs mujoco, gymnasium_robotics and
h5py.

    python3 unified_video_action_tpu_torch/tools/gen_fetch_demos.py --out data/fetch_demos.h5 --episodes 50
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--episodes", type=int, default=50)
    p.add_argument("--seed0", type=int, default=50000,
                   help="first demo seed (test seeds start at 100000)")
    p.add_argument("--max-steps", type=int, default=60)
    p.add_argument("--noise", type=float, default=0.05,
                   help="expert action noise for state diversity")
    p.add_argument("--image-size", type=int, default=96)
    p.add_argument("--max-tries", type=int, default=None,
                   help="give up after this many episodes (default: until --episodes are kept)")
    args = p.parse_args(argv)

    import h5py

    from unified_video_action_tpu_torch.envs.fetch_env import FetchImageEnv
    from unified_video_action_tpu_torch.envs.fetch_expert import FetchPickPlaceExpert

    env = FetchImageEnv(
        camera_heights=args.image_size, camera_widths=args.image_size
    )
    t0 = time.time()
    kept, tried = 0, 0
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with h5py.File(args.out + ".tmp", "w") as f:
        data = f.create_group("data")
        seed = args.seed0
        while kept < args.episodes and (args.max_tries is None or tried < args.max_tries):
            tried += 1
            np.random.seed(seed)
            obs = env.reset()
            expert = FetchPickPlaceExpert(noise=args.noise, seed=seed)
            seed += 1
            ep = {k: [v] for k, v in obs.items()}
            ep["states"] = [env.get_state()["states"]]
            ep["actions"] = []
            success = False
            for t in range(args.max_steps):
                a = expert.act(
                    env._raw_obs["observation"], env._env.unwrapped.goal
                )
                ep["actions"].append(a)
                obs, r, done, info = env.step(a)
                if r > 0.5:
                    success = True
                    break
                # the obs and state after the action (obs[t] -> action[t])
                for k, v in obs.items():
                    ep[k].append(v)
                ep["states"].append(env.get_state()["states"])
            if not success:
                continue
            g = data.create_group(f"demo_{kept}")
            og = g.create_group("obs")
            T = len(ep["actions"])
            for k in obs:
                arr = np.stack(ep[k][:T])
                og.create_dataset(
                    k, data=arr,
                    compression="gzip" if arr.dtype == np.uint8 else None,
                )
            g.create_dataset("actions", data=np.stack(ep["actions"]))
            g.create_dataset("states", data=np.stack(ep["states"][:T]))
            g.attrs["num_samples"] = T
            kept += 1
            if kept % 10 == 0:
                print(f"[gen_fetch] {kept}/{args.episodes} "
                      f"({tried} tried, {time.time() - t0:.0f}s)", flush=True)
        data.attrs["total"] = kept
        data.attrs["env_args"] = json.dumps(
            {"env_name": "FetchPickAndPlace-v4", "type": "fetch"}
        )
    os.replace(args.out + ".tmp", args.out)
    meta = {"episodes": kept, "tried": tried,
            "seconds": round(time.time() - t0, 1)}
    with open(os.path.splitext(args.out)[0] + "_meta.json", "w") as fm:
        json.dump(meta, fm, indent=2)
    print(json.dumps(meta))
    env.close()


if __name__ == "__main__":
    main()
