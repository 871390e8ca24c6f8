#!/usr/bin/env python3
"""chip_smoke.py's serve limits across seeds of the random weights.

    python3 unified_video_action_tpu_torch/tools/serve_limits.py > summary.json

For each serving configuration whose kernel route chip_smoke.py holds to the
serve limits, and for each of SEEDS: the MAR and denoiser weights drawn from the
seed (``convert.seeded_tree``, as the smoke draws them from its ``SEED``;
the 256 px models' VAE from the seed + 1, the others' the committed one),
frames and noise from the seed, and chip_smoke.py's ``route_readings`` of
the kernel route and of every planted fault of ``control_faults`` at the
batches of the smoke's phase, each with the limits it fails
(``serve_limit_failures``). One JSON line per configuration and seed goes
to stderr; the summary (per route, the range of the decoder output's floor
ratio and of the worst attention call's relative RMS error over the seeds,
and the seeds at which a route passed every limit, or the floor ratio) is
the last line of stdout. Exits non-zero if the
kernel route fails a limit at some seed, or a control the smoke's phase
must reject passes at some seed. Needs the card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load_smoke()
SEEDS = (0, 1, 2, 3, 4)


def configs() -> dict:
    """name -> (how to build the policy, batches, the controls the smoke's
    phase must reject, whether the VAE is seeded, the language goal)."""
    from unified_video_action_tpu_torch import config

    meta = os.path.join(smoke.LATEST, "meta.json")
    return {
        "serve": (("run_config", meta), (1, 128), smoke.REJECTED_CONTROLS, False, None),
        "serve_256px": (("cfg", config.PUSHT_256), (smoke.ROUTE_BATCH_256,),
                        smoke.REJECTED_CONTROLS_256, True, None),
        "small96": (("cfg", config.PUSHT_SMALL96), smoke.SMALL_BATCHES, smoke.REJECTED_CONTROLS,
                    False, None),
        "kitchen128": (("cfg", config.KITCHEN_SMALL128), smoke.SMALL_BATCHES,
                       smoke.REJECTED_CONTROLS_KITCHEN, False, smoke.KITCHEN_GOAL),
        "huge96": (("cfg", config.PUSHT_HUGE96), smoke.SMALL_BATCHES, smoke.REJECTED_CONTROLS,
                   False, None),
        "huge256": (("cfg", config.PUSHT_HUGE256), (smoke.ROUTE_BATCH_256,),
                    smoke.REJECTED_CONTROLS_256, True, None),
    }


def sweep(attention_ops, name: str, spec, seeds, normalizer) -> list:
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    (kind, source), batches, rejected, seeded_vae, goal = spec

    def make_policy(dtype: str):
        if kind == "run_config":
            p = UnifiedVideoActionPolicy.from_run_config(source, device="cuda", compute_dtype=dtype)
        else:
            p = UnifiedVideoActionPolicy.from_cfg(source, device="cuda", compute_dtype=dtype)
        if goal is None:  # as in the smoke, the kitchen model keeps its own normalizer
            p.set_normalizer(normalizer)
        return p

    policy, policy32 = make_policy("bfloat16"), make_policy("float32")
    size = 96 if seeded_vae else policy.mar_cfg.img_size  # the 256 px models upscale 96 px frames
    rows = []
    for seed in seeds:
        vae = (convert.seeded_tree(policy.vae, seed + 1) if seeded_vae
               else convert.load_flat_npz(os.path.join(REPO, policy.vae_path)))
        trees = convert.seeded_tree(policy.mar, seed), vae
        policy.load_params(*trees)
        policy32.load_params(*trees)
        rng = np.random.default_rng(seed + 1000)
        frames = {B: torch.from_numpy(rng.integers(0, 256, (B, 4, 3, size, size), dtype=np.uint8))
                  for B in batches}
        noise = {B: policy.sample_noise(B, torch.Generator(device="cuda").manual_seed(seed * 1000 + B))
                 for B in batches}
        text = {B: policy._encode_language_goal(goal, B) for B in batches} if goal else None
        readings = smoke.route_readings(attention_ops, policy, policy32, frames, noise, text)
        row = {"config": name, "seed": seed, "routes": {}}
        for route, by_batch in readings.items():
            row["routes"][route] = {
                "failed_limits": sorted({f for d in by_batch.values() for f in smoke.serve_limit_failures(d)}),
                "z_floor_ratio": max(d["z_err_kernel"] / d["z_err_plain"] for d in by_batch.values()),
                "calls_rel_rms_err": max(d["calls_rel_rms_err"] for d in by_batch.values()),
                "calls_max_err_over_rms": max(d["calls_max_err_over_rms"] for d in by_batch.values()),
                "action_mean": max(d["action_mean"] for d in by_batch.values()),
                "action_p99": max(d["action_p99"] for d in by_batch.values()),
            }
        row["rejected_must_fail"] = list(rejected)
        print(json.dumps(row), file=sys.stderr, flush=True)
        rows.append(row)
    del policy, policy32
    torch.cuda.empty_cache()
    return rows


def summarize(rows: list) -> dict:
    out = {}
    for row in rows:
        for route, r in row["routes"].items():
            s = out.setdefault(row["config"], {}).setdefault(route, {
                "z_floor_ratio": [np.inf, -np.inf], "calls_rel_rms_err": [np.inf, -np.inf],
                "seeds_passing_every_limit": [], "seeds_passing_z_floor_ratio": []})
            for key in ("z_floor_ratio", "calls_rel_rms_err"):
                s[key] = [min(s[key][0], r[key]), max(s[key][1], r[key])]
            if not r["failed_limits"]:
                s["seeds_passing_every_limit"].append(row["seed"])
            if "z_floor_ratio" not in r["failed_limits"]:
                s["seeds_passing_z_floor_ratio"].append(row["seed"])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_limits: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from unified_video_action_tpu_torch.ops import attention as attention_ops

    # the fp32 reference as the smoke takes it: matmuls and convolutions without TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, normalizer = smoke.flagship_config()
    rows = []
    for name, spec in configs().items():
        rows += sweep(attention_ops, name, spec, SEEDS, normalizer)
    bad = [(r["config"], r["seed"], route) for r in rows for route, d in r["routes"].items()
           if (route == "kernel" and d["failed_limits"])
           or (route in r["rejected_must_fail"] and not d["failed_limits"])]
    print(json.dumps({"card": smoke.card_line(), "seeds": SEEDS, "summary": summarize(rows),
                      "failures": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
