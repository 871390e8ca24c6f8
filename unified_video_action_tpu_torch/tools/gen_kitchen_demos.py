#!/usr/bin/env python3
"""Record Franka-kitchen image demonstrations with the port's scripted
expert: the counterpart of the JAX package's ``scripts/gen_kitchen_demos.py``,
the same episodes and files.

One robomimic-layout HDF5 a task (``data/demo_i/{obs/agentview_rgb,
obs/robot0_joint_pos, actions, states}``), ``kitchen_<slug>_demo.hdf5``: the
per-task files that the LIBERO-style dataset and runners glob (the reference
trains LIBERO from such files, dataset/libero_replay_image_dataset.py:39-101,
and its runner takes the goal from the file name,
env_runner/libero_image_runner.py:264). Only the episodes in which the env's
own completion predicate fires are kept; a task with none writes no file.
``data.attrs["env_args"]`` names the env and the task. Needs mujoco,
gymnasium_robotics and h5py.

    python3 unified_video_action_tpu_torch/tools/gen_kitchen_demos.py --out-dir data/kitchen_demos \
        --tasks "slide cabinet" "light switch" --episodes 50
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402


def gen_task(task, args):
    import h5py

    from unified_video_action_tpu_torch.envs.kitchen_env import KitchenImageEnv, _slug
    from unified_video_action_tpu_torch.envs.kitchen_expert import KitchenExpert

    env = KitchenImageEnv(
        tasks=(task,),
        camera_heights=args.image_size,
        camera_widths=args.image_size,
        max_episode_steps=args.max_steps,
    )
    out = os.path.join(args.out_dir, f"kitchen_{_slug(task)}_demo.hdf5")
    t0 = time.time()
    kept, tried = 0, 0
    with h5py.File(out + ".tmp", "w") as f:
        data = f.create_group("data")
        seed = args.seed0
        while kept < args.episodes and tried < args.episodes * args.max_tries:
            tried += 1
            env.seed(seed)
            obs = env.reset()
            expert = KitchenExpert(env, task, noise=args.noise, seed=seed)
            seed += 1

            def keep(o):
                # LIBERO's demo convention: the raw bottom-up render under
                # agentview_rgb (the env's agentview_image is bottom-up; the
                # dataset flips it upright, as for real LIBERO files)
                return {
                    "agentview_rgb": o["agentview_image"],
                    "robot0_joint_pos": o["robot0_joint_pos"],
                }

            obs = keep(obs)
            ep_obs = {k: [v] for k, v in obs.items()}
            ep_states = [env.get_sim_state()]
            ep_actions = []
            success = False
            for t in range(args.max_steps):
                a = expert.act()
                ep_actions.append(a)
                obs, r, done, info = env.step(a)
                if env.check_success():
                    success = True
                    break
                if expert.done:
                    break
                for k, v in keep(obs).items():
                    ep_obs[k].append(v)
                ep_states.append(env.get_sim_state())
            if not success:
                continue
            g = data.create_group(f"demo_{kept}")
            og = g.create_group("obs")
            T = len(ep_actions)
            for k in ep_obs:
                arr = np.stack(ep_obs[k][:T])
                og.create_dataset(
                    k, data=arr,
                    compression="gzip" if arr.dtype == np.uint8 else None,
                )
            g.create_dataset("actions", data=np.stack(ep_actions))
            g.create_dataset("states", data=np.stack(ep_states[:T]))
            g.attrs["num_samples"] = T
            kept += 1
            if kept % 5 == 0 or kept == args.episodes:
                print(
                    f"[gen_kitchen:{task}] {kept}/{args.episodes} "
                    f"({tried} tried, {time.time() - t0:.0f}s)",
                    flush=True,
                )
        data.attrs["total"] = kept
        data.attrs["env_args"] = json.dumps(
            {"env_name": "FrankaKitchen-v1", "type": "kitchen",
             "task": task}
        )
    env.close()
    if kept == 0:
        os.remove(out + ".tmp")
        print(f"[gen_kitchen:{task}] NO successes in {tried} tries: "
              f"no file written", flush=True)
        return {"task": task, "episodes": 0, "tried": tried}
    os.replace(out + ".tmp", out)
    rate = kept / max(tried, 1)
    print(f"[gen_kitchen:{task}] wrote {out}: {kept} demos "
          f"(success rate {rate:.2f})", flush=True)
    return {"task": task, "episodes": kept, "tried": tried,
            "success_rate": round(rate, 3),
            "seconds": round(time.time() - t0, 1)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out-dir", required=True)
    p.add_argument("--tasks", nargs="+", required=True)
    p.add_argument("--episodes", type=int, default=50)
    p.add_argument("--seed0", type=int, default=50000)
    p.add_argument("--max-steps", type=int, default=260)
    p.add_argument("--max-tries", type=int, default=6,
                   help="per kept episode, give up after this multiple")
    p.add_argument("--noise", type=float, default=0.02)
    p.add_argument("--image-size", type=int, default=128)
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    metas = [gen_task(t, args) for t in args.tasks]
    with open(os.path.join(args.out_dir, "meta.json"), "w") as fm:
        json.dump(metas, fm, indent=2)


if __name__ == "__main__":
    main()
