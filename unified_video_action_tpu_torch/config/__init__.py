"""Run configs as plain data, and dotted overrides.

``apply_overrides(cfg, ["a.b=3", "c.d=ddim10"])`` (the port's minimal
counterpart of the JAX package's ``config/__init__.py:130-145``) sets nested
keys of a plain dict, creating the missing levels. Values are read as YAML
scalars are: ``null``/``~``, ``true``/``false``, integers, floats, JSON
lists and maps, and otherwise the string. Composing a config from the JAX
package's yaml files is not ported: the port reads the ``cfg`` that an
exported checkpoint's ``meta.json`` embeds, or a config kept here as data.

``PUSHT_256`` is the reference's own PushT model as the JAX package serves
it in its parity tier: ``uva_pusht.yaml`` composed with ``task/pusht.yaml``
and ``model/uva.yaml`` (mar_base, 256 px, ``vae_stride`` 16, the KL-16 VAE
with ``ch_mult`` [1, 1, 2, 2, 4] and ``ch`` 128, a 6x1024 action denoiser),
with ``bench.py``'s serving overrides (``predict_action``, 100 sampler
steps, bf16, ``vae_encode_chunk`` 64, no checkpoint paths: the weights load
separately). Its 96 px frames are upscaled to 256 on the device, so it
attends over 4 x 16 x 16 = 1024 tokens (PushT has no text buffer).
``UnifiedVideoActionPolicy.from_cfg(PUSHT_256, device=...)`` builds it.
"""

from __future__ import annotations

import json
from typing import Any, Iterable


PUSHT_256 = {
    "task": {
        "name": "pusht",
        "shape_meta": {
            "image_resolution": 96,
            "action": {"shape": [2]},
            "obs": {
                "agent_pos": {"shape": [2], "type": "low_dim"},
                "image": {"shape": [3, 96, 96], "type": "rgb"},
            },
        },
    },
    "model": {
        "policy": {
            "_target_": "unified_video_action_tpu.policy.policy.UnifiedVideoActionPolicy",
            "selected_training_mode": None,
            "n_action_steps": 8,
            "use_proprioception": None,
            "use_history_action": None,
            "action_mask_ratio": 0.5,
            "different_history_freq": None,
            "predict_wrist_img": None,
            "predict_proprioception": None,
            "shape_meta": {
                "image_resolution": 96,
                "action": {"shape": [2]},
                "obs": {
                    "agent_pos": {"shape": [2], "type": "low_dim"},
                    "image": {"shape": [3, 96, 96], "type": "rgb"},
                },
            },
            "vae_model_params": {
                "autoencoder_path": None,
                "ddconfig": {"vae_embed_dim": 16, "ch_mult": [1, 1, 2, 2, 4], "ch": 128},
            },
            "autoregressive_model_params": {
                "pretrained_model_path": None,
                "model_size": "mar_base",
                "img_size": 256,
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
            "vae_encode_chunk": 64,
            "optimizer": {"learning_rate": 0.0001, "weight_decay": 0.02, "betas": [0.9, 0.95]},
        },
    },
}


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
