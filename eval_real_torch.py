#!/usr/bin/env python
"""Real-robot policy inference server with the PyTorch/CUDA port (the port's
counterpart of ``eval_real.py``).

    python eval_real_torch.py -c CHECKPOINT --config umi_multi \
        --language-latents latents.pkl --smooth-window 3 [--bind tcp://0.0.0.0:8766]

The reference's real-robot node (eval_real.py:66-214): load a checkpoint,
force 100 sampling steps (the deploy convention, eval_real.py:79-89), select
per-task language latents, and serve ``predict_action`` over a ZMQ REP
socket with moving-average action smoothing
(``serving/zmq_server.PolicyInferenceNode``). The robot-side client (cameras
and controllers, ``real/``) connects over TCP and sends pickled obs dicts,
``{"obs": ..., "task_name": ...}`` or the obs dict alone, and gets the
smoothed (B, 16, A) chunk back, or a traceback string.

The run config is ``--config`` (a config of
``unified_video_action_tpu_torch.config``) or, without it, the checkpoint's
``meta.json`` ``cfg``; dotted overrides apply on top. The weights are read as
``eval_sim_torch.py -c`` reads them: a port checkpoint or slim export, or
an orbax directory. ``normalizer.npz`` beside them is loaded where it
exists. ``--language-latents``: a pickle of
{task_name: latent}, each latent (512,) or (1, 512).

The policy runs on ``--device``, ``cuda`` by default; a missing card is an
error, not a fallback to the CPU (``--device cpu`` asks for the CPU). The
server needs ``zmq``, imported when it starts: the machine with the card has
none, and there the node is driven in-process (``chip_smoke.py``'s
``real_loop`` phase).
"""

import argparse
import copy
import json
import os
import pickle
import sys

REPO = os.path.dirname(os.path.abspath(__file__))

# --config's choices: the port's served run configs, by their name in config
CONFIGS = {"umi_multi": "UMI_MULTI", "toolhang": "TOOLHANG"}
# the deploy convention: 100-step samplers whatever the training config said
DEPLOY_OVERRIDES = (
    "model.policy.autoregressive_model_params.num_sampling_steps=100",
    "model.policy.autoregressive_model_params.act_diff_testing_steps=100",
)


def load_language_latents(path):
    """{task_name: (1, D) float32} of a pickle of {task_name: latent}."""
    import numpy as np

    with open(path, "rb") as f:
        latents = pickle.load(f)
    return {k: np.asarray(v, np.float32).reshape(1, -1) for k, v in latents.items()}


def build_node(args):
    import torch

    from unified_video_action_tpu_torch import config as port_config
    from unified_video_action_tpu_torch.config import apply_overrides
    from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
    from unified_video_action_tpu_torch.serving.zmq_server import PolicyInferenceNode
    from eval_sim_torch import load_weights

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"eval_real_torch: --device {args.device} but torch.cuda.is_available() "
                         "is False (pass --device cpu to serve on the CPU)")
    if args.config:
        cfg = copy.deepcopy(getattr(port_config, CONFIGS[args.config]))
    else:
        with open(os.path.join(args.checkpoint, "meta.json")) as f:
            cfg = json.load(f).get("cfg")
        if cfg is None:
            raise SystemExit("the checkpoint's meta.json has no cfg: pass --config")
    apply_overrides(cfg, [*args.overrides, *DEPLOY_OVERRIDES])

    policy = UnifiedVideoActionPolicy.from_cfg(cfg, device=args.device)
    policy.load_params(*load_weights(args.checkpoint))
    norm_path = os.path.join(args.checkpoint, "normalizer.npz")
    if os.path.exists(norm_path):
        policy.set_normalizer(LinearNormalizer.load(norm_path))
    latents = load_language_latents(args.language_latents) if args.language_latents else None
    return PolicyInferenceNode(policy, language_latents=latents, smooth_window=args.smooth_window)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("--config", choices=sorted(CONFIGS),
                        help="a run config of unified_video_action_tpu_torch.config "
                             "(default: the checkpoint's meta.json cfg)")
    parser.add_argument("--bind", default="tcp://0.0.0.0:8766")
    parser.add_argument("--language-latents", default=None,
                        help="pickle of {task_name: (512,) latent}")
    parser.add_argument("--smooth-window", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    node = build_node(args)
    node.serve(args.bind)


if __name__ == "__main__":
    main()
