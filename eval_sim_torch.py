#!/usr/bin/env python
"""Simulation evaluation with the PyTorch/CUDA port (the port's counterpart
of ``eval_sim.py``).

    python eval_sim_torch.py -c pretrained_models/uva_pusht_small/latest -o OUT \
        task.env_runner.n_test=50 task.env_runner.n_train=0 \
        task.env_runner.n_streams=2 task.env_runner.latent_cache=true \
        model.policy.autoregressive_model_params.act_diff_testing_steps=ddim10 \
        [--device cpu]

The checkpoint is a directory: ``meta.json`` (whose ``cfg`` is the run
config; the dotted overrides apply on top of it), ``normalizer.npz`` and the
weights, read from the first of these that applies:

- ``--weights FILE.npz``: a flat fp32 ``.npz`` whose keys are
  ``mar/<flax path>`` and ``vae/<flax path>`` (``convert.load_flat_npz``);
- a checkpoint directory of the port (``training/checkpoint.py``): its slim
  export (``weights.npz`` in the ``export_dtype`` its ``meta.json`` names,
  as ``train_torch.py`` writes to ``<output_dir>/export``) or a full
  checkpoint (``state.pt``), its EMA weights and VAE, read with torch and
  numpy alone;
- otherwise the orbax directory ``<checkpoint>/state`` (its ``ema_params``
  and ``vae_params``), restored with ``orbax.checkpoint`` alone.

The port's policy is built from the config and the weights go through the
weight bridge. The task's env runner rolls out the policy, and the log is
written to ``<output_dir>/eval_log_<name>.json`` with the JAX package's keys
(per-seed ``sim_max_reward``, mean scores, ``ckpt_source``, ``ckpt_digest``,
``act_steps``, ``serving_quant``, ``obs_codec``, ``env_backend``) and
``port``, ``device``, ``compute_dtype`` and ``eval_wall_s``. The policy runs
on ``--device`` (``cuda`` by default); its draws come from a generator
seeded with 0, as ``eval_sim.py`` passes ``PRNGKey(0)``.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def _numpy_tree(tree):
    import numpy as np

    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def restore_orbax(state_dir: str):
    """``(mar_tree, vae_tree)`` of an orbax state directory (the EMA weights
    and the VAE), as numpy arrays."""
    import orbax.checkpoint as ocp

    restored = ocp.StandardCheckpointer().restore(os.path.abspath(state_dir))
    mar = restored.get("ema_params") or restored["mar_params"]
    return _numpy_tree(mar), _numpy_tree(restored["vae_params"])


def load_weights(checkpoint: str, weights_npz=None):
    """``(mar_tree, vae_tree)`` of the checkpoint, as numpy flax trees."""
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.training import checkpoint as ckpt_lib

    if weights_npz:
        tree = convert.load_flat_npz(weights_npz)
        return tree["mar"], tree["vae"]
    if ckpt_lib.is_port_checkpoint(checkpoint):
        return ckpt_lib.read_weights(checkpoint)
    return restore_orbax(os.path.join(checkpoint, "state"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("-o", "--output_dir", required=True)
    parser.add_argument("--config-name", default="uva_pusht",
                        help="accepted as eval_sim.py's; the port reads the checkpoint's cfg")
    parser.add_argument("--weights", default=None, help="flat .npz with mar/ and vae/ keys")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    sys.path.insert(0, REPO)
    import torch

    from unified_video_action_tpu_torch.config import apply_overrides
    from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
    from unified_video_action_tpu_torch.runners.base import env_rollout, load_env_runner
    from unified_video_action_tpu_torch.utils.ckpt_id import ckpt_digest

    with open(os.path.join(args.checkpoint, "meta.json")) as f:
        cfg = json.load(f).get("cfg")
    if cfg is None:
        raise NotImplementedError(
            "the checkpoint's meta.json has no cfg; composing --config-name is not ported")
    apply_overrides(cfg, args.overrides)
    os.makedirs(args.output_dir, exist_ok=True)

    t0 = time.perf_counter()
    policy = UnifiedVideoActionPolicy.from_cfg(cfg, device=args.device)
    policy.load_params(*load_weights(args.checkpoint, args.weights))
    norm_path = os.path.join(args.checkpoint, "normalizer.npz")
    if os.path.exists(norm_path):
        policy.set_normalizer(LinearNormalizer.load(norm_path))

    runner = load_env_runner(cfg, output_dir=args.output_dir)
    generator = torch.Generator(device=policy.device).manual_seed(0)
    log = env_rollout(policy, runner, generator)

    log["ckpt_source"] = args.checkpoint
    log["ckpt_digest"] = ckpt_digest(args.checkpoint)
    log["act_steps"] = str(policy.mar_cfg.act_diff_testing_steps)
    log["serving_quant"] = policy.serving_quant or "bf16"
    log["obs_codec"] = policy.obs_codec or "raw"
    log["port"] = "torch"
    log["device"] = str(policy.device)
    log["compute_dtype"] = str(policy.dtype).replace("torch.", "")
    log["eval_wall_s"] = time.perf_counter() - t0

    name = os.path.basename(os.path.normpath(args.checkpoint))
    out_path = os.path.join(args.output_dir, f"eval_log_{name}.json")
    with open(out_path, "w") as f:
        json.dump(log, f, indent=2, sort_keys=True)
    print(json.dumps({k: v for k, v in log.items() if "mean_score" in k}, indent=2))
    print("wrote", out_path)


if __name__ == "__main__":
    main()
