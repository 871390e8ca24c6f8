#!/usr/bin/env python3
"""Train the PyTorch/CUDA port's policy from a run config.

    python3 train_torch.py --run-config pretrained_models/uva_pusht_small/latest/meta.json \
        task.dataset.dataset_path=corpora/pusht_demos_r5b.npz training.max_train_steps=20

``--run-config`` is an exported checkpoint's ``meta.json`` (its ``cfg`` is
the run config) or a JSON file holding the run config itself; ``--config
umi_multi`` takes ``config.UMI_MULTI``, the UMI multi-task model's stage 2
on the three ``.npz`` stores that ``unified_video_action_tpu_torch/tools/
gen_synthetic_umi.py`` writes under ``data/umi/``, through the host loader
(with ``config.UMI_TRAIN_OVERRIDES``: JAX refuses the history actions of
UMI's 32-step window in training). The dotted overrides after either set
keys of that config (``config.apply_overrides``):

    python3 unified_video_action_tpu_torch/tools/gen_synthetic_umi.py --root data/umi
    python3 train_torch.py --config umi_multi training.num_epochs=2 training.max_train_steps=10

The run initializes the MAR from ``training.seed`` (and merges the port
checkpoint at ``pretrained_model_path`` into it, the stage-1 -> stage-2
bootstrap), reads the VAE from ``autoencoder_path``, trains on the card
(``--device cpu`` for the CPU) with the video FVD, validation and rollouts
at the config's cadences, and writes under ``output_dir``: ``logs.jsonl``, ``normalizer.npz``,
``tracker/``, ``checkpoints/latest`` and the top-k checkpoints, and
``export/``, the slim export of the final EMA that ``eval_sim_torch.py -c``
serves (``training/workspace.py``). A run without the action head keeps its
top-k by ``video_fvd_vae`` (:func:`video_monitor`). With
``training.resume=true`` it starts from ``checkpoints/latest``; SIGTERM or
SIGINT saves it and stops.
"""

from __future__ import annotations

import argparse
import copy
import json

from unified_video_action_tpu_torch import config as port_config
from unified_video_action_tpu_torch.config import apply_overrides
from unified_video_action_tpu_torch.training.workspace import Trainer


# --config: a run config kept as data, and the overrides it trains with
CONFIGS = {"umi_multi": (port_config.UMI_MULTI, port_config.UMI_TRAIN_OVERRIDES)}


def load_run_config(path: str) -> dict:
    with open(path) as f:
        cfg = json.load(f)
    return cfg["cfg"] if "cfg" in cfg else cfg


def video_monitor(cfg: dict) -> dict:
    """JAX's ``train.py:42-56``: a run without the action head (stage 1)
    logs no rollout score, so where its top-k monitors ``test_mean_score``
    the top-k keeps the lowest ``video_fvd_vae`` instead (the VAE-latent
    Fréchet distance, which needs no I3D weights). Changes ``cfg`` in place
    and returns it."""
    ap = cfg.get("model", {}).get("policy", {}).get("action_model_params", {}) or {}
    topk = cfg.get("checkpoint", {}).get("topk", {})
    if not ap.get("predict_action", True) and topk.get("monitor_key") == "test_mean_score":
        topk.update(monitor_key="video_fvd_vae", mode="min",
                    format_str="epoch={epoch:04d}-video_fvd_vae={video_fvd_vae:.3f}")
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--run-config",
                     help="a meta.json with the run config under 'cfg', or the run config as JSON")
    src.add_argument("--config", choices=sorted(CONFIGS),
                     help="a run config of unified_video_action_tpu_torch.config")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("overrides", nargs="*", help="dotted overrides, e.g. training.max_train_steps=20")
    args = ap.parse_args(argv)
    if args.config:
        cfg, base = CONFIGS[args.config]
        cfg = copy.deepcopy(cfg)
        print(f"[config] {args.config} with {list(base)}", flush=True)
        apply_overrides(cfg, base)
    else:
        cfg = load_run_config(args.run_config)
    apply_overrides(cfg, args.overrides)
    return Trainer(video_monitor(cfg), args.device).run()


if __name__ == "__main__":
    main()
