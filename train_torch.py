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

``--config pusht_256`` takes ``config.PUSHT_256_RUN``, the JAX package's
own PushT recipe (``uva_pusht.yaml``: mar_base at 256 px, batch 16,
``data_aug``) through the host loader on the committed corpus; with
``task.dataset.device_aug=false`` the loader's workers augment each clip
(crop, resize, blur) instead of the card:

    python3 train_torch.py --config pusht_256 task.dataset.device_aug=false \
        training.num_epochs=1 training.max_train_steps=10

``--config toolhang`` and ``--config libero10`` take ``config.TOOLHANG`` and
``config.LIBERO10`` (robomimic's tool-hang and LIBERO-10, with
``config.SUITE_TRAIN_OVERRIDES``: ``grad_checkpointing``) on the stores
that ``unified_video_action_tpu_torch/tools/gen_synthetic_suites.py`` writes
under ``data/``; their rollouts need robosuite or LIBERO, or the stub
backend, whose scores measure nothing about the policy:

    python3 unified_video_action_tpu_torch/tools/gen_synthetic_suites.py --root data
    python3 train_torch.py --config libero10 task.env_runner.env_backend=stub \
        training.num_epochs=1 training.max_train_steps=10

``--config kitchen`` and ``--config fetch`` take ``config.KITCHEN``
(``uva_kitchen.yaml``: mar_base, 1024 tokens, 9-d actions, with
``SUITE_TRAIN_OVERRIDES``) and ``config.FETCH`` (``uva_fetch.yaml``:
mar_small at 96 px, 4-d actions, its store on the device). Their demos come
from the scripted experts in mujoco (``tools/gen_kitchen_demos.py``,
``tools/gen_fetch_demos.py``) and their rollouts run mujoco's physics
(``env_backend`` ``kitchen`` and ``fetch``); without mujoco,
``gen_synthetic_suites.py --suites kitchen fetch`` writes stores of their
layout and the stub backend rolls out:

    python3 unified_video_action_tpu_torch/tools/gen_kitchen_demos.py --out-dir data/kitchen_demos \
        --tasks microwave "slide cabinet" --episodes 20
    python3 train_torch.py --config kitchen training.num_epochs=1 training.max_train_steps=10

``--config human_pp`` takes ``config.HUMAN_PP`` (``uva_human_pp.yaml``:
mar_base, the 96 px frames upscaled to 256, 1024 tokens, 14-d hand-keypoint
actions, ``keypoints.eval``: each validation writes
``media/keypoints_epoch<n>.gif``) with ``config.HUMAN_PP_TRAIN_OVERRIDES``
(``grad_checkpointing``). ``--config-name NAME`` composes
``unified_video_action_tpu_torch/config/yaml/NAME.yaml`` as it stands, as
``train.py --config-name`` does (the port's ``load_config``, no PyYAML). The
real human-video corpus is not in the repository; a synthetic keypoint
store of its layout (``make_synthetic_pusht(agent_pos_dim=14)``, saved as
``.npz``) stands in:

    python3 -c "from unified_video_action_tpu_torch.data.pusht_dataset import make_synthetic_pusht; \
        make_synthetic_pusht(16, agent_pos_dim=14).save('data/human_pp/human_replay.npz')"
    python3 train_torch.py --config-name uva_human_pp \
        task.dataset.dataset_path=data/human_pp/human_replay.npz \
        model.policy.autoregressive_model_params.pretrained_model_path=null \
        model.policy.vae_model_params.autoencoder_path=null \
        model.policy.action_model_params.predict_action=true training.max_train_steps=10

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
CONFIGS = {"pusht_256": (port_config.PUSHT_256_RUN, ()),
           "umi_multi": (port_config.UMI_MULTI, port_config.UMI_TRAIN_OVERRIDES),
           "toolhang": (port_config.TOOLHANG, port_config.SUITE_TRAIN_OVERRIDES),
           "libero10": (port_config.LIBERO10, port_config.SUITE_TRAIN_OVERRIDES),
           "kitchen": (port_config.KITCHEN, port_config.SUITE_TRAIN_OVERRIDES),
           "fetch": (port_config.FETCH, ()),
           "human_pp": (port_config.HUMAN_PP, port_config.HUMAN_PP_TRAIN_OVERRIDES)}


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
    src.add_argument("--config-name",
                     help="a yaml of unified_video_action_tpu_torch/config/yaml, composed by "
                          "load_config (e.g. uva_human_pp)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("overrides", nargs="*", help="dotted overrides, e.g. training.max_train_steps=20")
    args = ap.parse_args(argv)
    if args.config:
        cfg, base = CONFIGS[args.config]
        cfg = copy.deepcopy(cfg)
        print(f"[config] {args.config} with {list(base)}", flush=True)
        apply_overrides(cfg, base)
    elif args.config_name:
        cfg = port_config.load_config(args.config_name)
    else:
        cfg = load_run_config(args.run_config)
    apply_overrides(cfg, args.overrides)
    return Trainer(video_monitor(cfg), args.device).run()


if __name__ == "__main__":
    main()
