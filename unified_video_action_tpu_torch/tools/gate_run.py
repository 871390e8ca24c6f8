#!/usr/bin/env python3
"""The flagship's two-stage recipe (``scripts/round4b_train.sh``) on the card
with the port, then the 50-seed PushT score of its best top-k EMA.

    python3 unified_video_action_tpu_torch/tools/gate_run.py --out chiprun_out/gate \
        [--stage1-epochs 6] [--stage1-steps N] [--stage2-epochs 36] [--stage2-steps N] \
        [--rollout-every 4] [--patience 3]

1. Stage 1, ``train_torch.py`` on the flagship's config (``latest/meta.json``)
   with the recipe's stage-1 overrides: ``video_model``, no action head,
   ``checkpoint_every=1``, the video FVD every epoch (``sample_every=1``;
   the top-k by ``video_fvd_vae``), on the committed corpus
   (``corpora/pusht_demos_r5b.npz``).
2. Stage 2, ``train_torch.py`` with the recipe's stage-2 overrides:
   ``policy_model_full_dynamics_model`` from stage 1's ``checkpoints/latest``
   through ``pretrained_model_path``, rollouts every ``--rollout-every``
   epochs, ``early_stop_patience``, top-k 2 by ``test_mean_score``, and
   checkpoints at the rollouts' cadence (top-k keeps only what a checkpoint
   epoch saves: at the config's ``checkpoint_every: 8`` a run of fewer
   epochs would keep its first rollout's weights alone).
3. The best top-k checkpoint by its score (``latest`` where none was kept)
   goes to a slim export (``training/checkpoint.py export``), which
   ``eval_sim_torch.py -c`` scores with the recipe's overrides
   (``n_test=50 n_train=0 n_streams=2 latent_cache=true``) at 100 steps and
   at ddim10.

``--stage*-steps`` caps the steps of an epoch (``training.max_train_steps``);
the defaults are the recipe's. Each stage's log, ``logs.jsonl``, the eval
logs and ``summary.json`` (the steps and wall time of each stage, the
export's size, the scores, each paired with the JAX package's log of the
same config, the card) go to ``--out``; the runs' checkpoints go to
``build/gate``, which is deleted at the end.

    python3 unified_video_action_tpu_torch/tools/gate_run.py --pair PORT_LOG JAX_LOG

prints the pairing of two eval logs alone: over the test seeds both hold,
the mean of the per-seed differences of ``sim_max_reward``, its standard
error (the differences' sample sd over the square root of their count) and
their ratio, as PERF.md's section 2 pairs the gate.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
META = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest", "meta.json")
CORPUS = os.path.join(REPO, "corpora", "pusht_demos_r5b.npz")
VAE = os.path.join(REPO, "pretrained_models", "vae", "pusht_vae96.npz")
WORK = os.path.join(REPO, "build", "gate")
JAX_LOGS = {name: os.path.join(REPO, "pretrained_models", "uva_pusht_small", name, "eval_log_latest.json")
            for name in ("eval_final", "eval_ddim10")}
EVAL_OVERRIDES = ["task.env_runner.n_test=50", "task.env_runner.n_train=0",
                  "task.env_runner.n_streams=2", "task.env_runner.latent_cache=true"]


def run(cmd, log_path):
    """Run ``cmd`` from the repo root, its output to ``log_path``; returns
    the seconds it took (raises on a non-zero exit)."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT).returncode
    if rc:
        with open(log_path) as f:
            sys.stderr.write(f.read()[-4000:])
        raise SystemExit(f"{' '.join(cmd[:3])} exited {rc} (log {log_path})")
    return time.perf_counter() - t0


def paired(port_log: dict, jax_log: dict) -> dict:
    """The per-seed pairing of two eval logs' test seeds."""
    keys = sorted(k for k in jax_log if k.startswith("test/sim_max_reward_") and k in port_log)
    port = np.array([port_log[k] for k in keys])
    ref = np.array([jax_log[k] for k in keys])
    d = port - ref
    se = float(d.std(ddof=1) / np.sqrt(len(d)))
    return {"seeds": len(keys), "port": float(port.mean()), "jax": float(ref.mean()),
            "difference": float(d.mean()), "standard_error": se,
            "difference_over_se": float(d.mean()) / se}


def log_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def best_checkpoint(ckpt_dir):
    """The top-k checkpoint with the highest score in its name, else latest."""
    scored = []
    for path in glob.glob(os.path.join(ckpt_dir, "epoch=*")):
        if path.endswith((".tmp", ".old")) or "test_mean_score=" not in path:
            continue
        scored.append((float(path.rsplit("test_mean_score=", 1)[1]), path))
    return max(scored)[1] if scored else os.path.join(ckpt_dir, "latest")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", nargs=2, metavar=("PORT_LOG", "JAX_LOG"))
    ap.add_argument("--out")
    ap.add_argument("--stage1-epochs", type=int, default=6)
    ap.add_argument("--stage1-steps", type=int, default=None)
    ap.add_argument("--stage2-epochs", type=int, default=36)
    ap.add_argument("--stage2-steps", type=int, default=None)
    ap.add_argument("--rollout-every", type=int, default=4)
    ap.add_argument("--patience", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.pair:
        logs = [json.load(open(p)) for p in args.pair]
        print(json.dumps(paired(*logs)))
        return
    os.makedirs(args.out, exist_ok=True)
    shutil.rmtree(WORK, ignore_errors=True)
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip() if args.device == "cuda" else None,
           "args": vars(args)}
    amp = "model.policy.autoregressive_model_params"
    common = [f"task.dataset.dataset_path={CORPUS}", f"model.policy.vae_model_params.autoencoder_path={VAE}",
              f"{amp}.model_size=mar_base", "training.resume=false"]
    cap = lambda steps: [] if steps is None else [f"training.max_train_steps={steps}"]
    stage1 = os.path.join(WORK, "stage1")
    stage2 = os.path.join(WORK, "stage2")
    stages = {
        "stage1": [*common, "model.policy.selected_training_mode=video_model",
                   "model.policy.action_model_params.predict_action=false",
                   f"{amp}.pretrained_model_path=null", f"training.num_epochs={args.stage1_epochs}",
                   "training.rollout_every=1000", "training.sample_every=1",
                   "training.checkpoint_every=1", f"output_dir={stage1}", *cap(args.stage1_steps)],
        "stage2": [*common, "model.policy.selected_training_mode=policy_model_full_dynamics_model",
                   "model.policy.action_model_params.predict_action=true",
                   f"{amp}.pretrained_model_path={stage1}/checkpoints/latest",
                   f"training.num_epochs={args.stage2_epochs}",
                   f"training.rollout_every={args.rollout_every}",
                   f"training.checkpoint_every={args.rollout_every}",
                   f"training.early_stop_patience={args.patience}", "checkpoint.topk.k=2",
                   f"output_dir={stage2}", *cap(args.stage2_steps)],
    }
    try:
        for name, overrides in stages.items():
            seconds = run([sys.executable, "-u", "train_torch.py", "--run-config", META,
                           "--device", args.device, *overrides],
                          os.path.join(args.out, f"{name}.log"))
            lines = log_lines(os.path.join(WORK, name, "logs.jsonl"))
            shutil.copy(os.path.join(WORK, name, "logs.jsonl"),
                        os.path.join(args.out, f"{name}_logs.jsonl"))
            out[name] = {"wall_s": seconds, "epochs": len(lines),
                         "steps": lines[-1]["global_step"] if lines else 0,
                         "last": lines[-1] if lines else None}
            print(json.dumps({name: out[name]}), flush=True)
        best = best_checkpoint(os.path.join(stage2, "checkpoints"))
        export = os.path.join(WORK, "best_export")
        run([sys.executable, "-m", "unified_video_action_tpu_torch.training.checkpoint", "export",
             best, export], os.path.join(args.out, "export.log"))
        with open(os.path.join(export, "meta.json")) as f:
            meta = json.load(f)
        out["export"] = {"from": os.path.basename(best), "epoch": meta["epoch"], "step": meta["step"],
                         "bytes": os.path.getsize(os.path.join(export, "weights.npz")),
                         "dtype": meta["export_dtype"]}
        for name, extra in (("eval_final", []),
                            ("eval_ddim10", [f"{amp}.act_diff_testing_steps=ddim10"])):
            eval_dir = os.path.join(WORK, name)
            seconds = run([sys.executable, "-u", "eval_sim_torch.py", "-c", export, "-o", eval_dir,
                           "--device", args.device, *EVAL_OVERRIDES, *extra],
                          os.path.join(args.out, f"{name}.log"))
            eval_log = glob.glob(os.path.join(eval_dir, "eval_log_*.json"))[0]
            shutil.copy(eval_log, os.path.join(args.out, f"{name}_eval_log.json"))
            with open(eval_log) as f:
                scores = json.load(f)
            with open(JAX_LOGS[name]) as f:
                pair = paired(scores, json.load(f))
            out[name] = {"wall_s": seconds, "test_mean_score": scores["test_mean_score"],
                         "paired_with_jax": pair}
            print(json.dumps({name: out[name]}), flush=True)
    finally:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(out, f, indent=2)
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
