"""Run configs as plain data, and dotted overrides.

``apply_overrides(cfg, ["a.b=3", "c.d=ddim10"])`` (the port's minimal
counterpart of the JAX package's ``config/__init__.py:130-145``) sets nested
keys of a plain dict, creating the missing levels. Values are read as YAML
scalars are: ``null``/``~``, ``true``/``false``, integers, floats, JSON
lists and maps, and otherwise the string. Composing a config from the JAX
package's yaml files is not ported: the port reads the ``cfg`` that an
exported checkpoint's ``meta.json`` embeds, or a config kept here as data.

Five run configs are kept here as data, each the ``cfg`` that the JAX
package's ``load_config`` composes (``task.name``, ``task.shape_meta`` and
``model.policy``: what serving reads), with the overrides named below.
``UnifiedVideoActionPolicy.from_cfg(cfg, device=...)`` builds each:

* ``PUSHT_256``: the reference's own PushT model as the JAX package serves
  it in its parity tier: ``uva_pusht.yaml`` composed with ``task/pusht.yaml``
  and ``model/uva.yaml`` (mar_base, 256 px, ``vae_stride`` 16, the KL-16 VAE
  with ``ch_mult`` [1, 1, 2, 2, 4] and ``ch`` 128, a 6x1024 action
  denoiser), with ``bench.py``'s serving overrides (``predict_action``, 100
  sampler steps, bf16, ``vae_encode_chunk`` 64, no checkpoint paths: the
  weights load separately). Its 96 px frames are upscaled to 256 on the
  device, so it attends over 4 x 16 x 16 = 1024 tokens (PushT has no text
  buffer).
* ``PUSHT_SMALL96``: the single-chip PushT recipe, ``uva_pusht_small.yaml``
  (``task/pusht.yaml`` + ``model/uva_small96.yaml``: mar_small, 6+6 blocks
  of d = 768 over 6 heads, so head dimension 128, at the frames' native 96
  px, 4 x 6 x 6 = 144 tokens, the task-trained VAE
  ``pretrained_models/vae/pusht_vae96.npz`` with ``ch`` 64), with the
  action head on (``predict_action=true``, as its serving stage trains it,
  ``scripts/training/train_pusht_small.sh``).
* ``KITCHEN_SMALL128``: the single-chip kitchen recipe,
  ``uva_kitchen_small.yaml`` (``task/kitchen.yaml`` +
  ``model/uva_kitchen128.yaml``: mar_small at 128 px, 4 x 8 x 8 = 256 frame
  tokens plus the 64-token text buffer of ``language_emb_model="clip"``,
  320 in all, 9-d actions, the VAE ``pretrained_models/vae/kitchen_vae128.npz``),
  as composed.
* ``PUSHT_HUGE96``: ``PUSHT_SMALL96`` with ``model_size`` mar_huge (the
  MAR paper's MAR-H, the largest size of ``MODEL_SIZES``: 20+20 blocks of d
  = 1280 over 16 heads, so head dimension 80), at 96 px, 144 tokens, with
  the same VAE: ``load_config("uva_pusht_small")`` with the action head on
  and ``model.policy.autoregressive_model_params.model_size=mar_huge``.
* ``PUSHT_HUGE256``: ``PUSHT_256`` with ``model_size`` mar_huge: 1024
  tokens at head dimension 80, the KL-16 VAE with ``ch`` 128,
  ``vae_encode_chunk`` 64: ``PUSHT_256``'s composition plus the same
  ``model_size`` override.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Iterable

_PUSHT_SHAPE_META = {
    "image_resolution": 96,
    "action": {"shape": [2]},
    "obs": {
        "agent_pos": {"shape": [2], "type": "low_dim"},
        "image": {"shape": [3, 96, 96], "type": "rgb"},
    },
}
_KITCHEN_SHAPE_META = {
    "image_resolution": 128,
    "action": {"shape": [9]},
    "obs": {
        "agentview_rgb": {"shape": [3, 128, 128], "type": "rgb"},
        "language": {"shape": [15], "type": "low_dim"},
    },
}


def _run_config(task: str, shape_meta: dict, model_size: str, img_size: int, ch: int,
                autoencoder_path, **policy: Any) -> dict:
    """The run config of ``model/uva*.yaml``'s policy, which the three share
    but for the named fields; ``policy`` adds or replaces top-level keys."""
    return {
        "task": {"name": task, "shape_meta": copy.deepcopy(shape_meta)},
        "model": {"policy": {
            "_target_": "unified_video_action_tpu.policy.policy.UnifiedVideoActionPolicy",
            "selected_training_mode": None,
            "n_action_steps": 8,
            "use_proprioception": None,
            "use_history_action": None,
            "action_mask_ratio": 0.5,
            "different_history_freq": None,
            "predict_wrist_img": None,
            "predict_proprioception": None,
            "shape_meta": copy.deepcopy(shape_meta),
            "vae_model_params": {
                "autoencoder_path": autoencoder_path,
                "ddconfig": {"vae_embed_dim": 16, "ch_mult": [1, 1, 2, 2, 4], "ch": ch},
            },
            "autoregressive_model_params": {
                "pretrained_model_path": None,
                "model_size": model_size,
                "img_size": img_size,
                "vae_stride": 16,
                "patch_size": 1,
                "vae_embed_dim": 16,
                "mask_ratio_min": 0.7,
                "label_drop_prob": 0.1,
                "attn_dropout": 0.1,
                "proj_dropout": 0.1,
                "diffloss_d": 6,
                "diffloss_w": 1024,
                "diffloss_act_d": 6,
                "diffloss_act_w": 1024,
                "num_sampling_steps": "100",
                "grad_checkpointing": False,
                "num_iter": 1,
                "cfg": 1,
                "cfg_schedule": "linear",
                "temperature": 0.95,
                "predict_video": True,
                "act_diff_training_steps": 1000,
                "act_diff_testing_steps": "100",
            },
            "action_model_params": {"predict_action": True, "act_model_type": "conv_fc"},
            "shift_action": True,
            "compute_dtype": "bfloat16",
            "attn_impl": "xla",
            "optimizer": {"learning_rate": 0.0001, "weight_decay": 0.02, "betas": [0.9, 0.95]},
            **policy,
        }},
    }


PUSHT_256 = _run_config("pusht", _PUSHT_SHAPE_META, "mar_base", 256, 128, None, vae_encode_chunk=64)
PUSHT_SMALL96 = _run_config("pusht", _PUSHT_SHAPE_META, "mar_small", 96, 64,
                            "pretrained_models/vae/pusht_vae96.npz")
PUSHT_HUGE96 = _run_config("pusht", _PUSHT_SHAPE_META, "mar_huge", 96, 64,
                           "pretrained_models/vae/pusht_vae96.npz")
PUSHT_HUGE256 = _run_config("pusht", _PUSHT_SHAPE_META, "mar_huge", 256, 128, None, vae_encode_chunk=64)
KITCHEN_SMALL128 = _run_config("kitchen", _KITCHEN_SHAPE_META, "mar_small", 128, 64,
                               "pretrained_models/vae/kitchen_vae128.npz",
                               selected_training_mode="policy_model_full_dynamics_model",
                               language_emb_model="clip")


def parse_value(s: str) -> Any:
    low = s.strip().lower()
    if low in ("", "null", "~"):
        return None
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.strip()[:1] in ("[", "{"):
        return json.loads(s)
    return s


def apply_overrides(cfg: dict, overrides: Iterable[str]) -> None:
    for ov in overrides:
        key, _, val = ov.partition("=")
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = {}
            node = node[p]
        node[parts[-1]] = parse_value(val)
