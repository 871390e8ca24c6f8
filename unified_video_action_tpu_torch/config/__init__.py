"""Run configs as plain data, and dotted overrides.

``apply_overrides(cfg, ["a.b=3", "c.d=ddim10"])`` (the port's minimal
counterpart of the JAX package's ``config/__init__.py:130-145``) sets nested
keys of a plain dict, creating the missing levels. Values are read as YAML
scalars are: ``null``/``~``, ``true``/``false``, integers, floats, JSON
lists and maps, and otherwise the string. Composing a config from the JAX
package's yaml files is not ported: the port reads the ``cfg`` that an
exported checkpoint's ``meta.json`` embeds, or a config kept here as data.

Nine run configs are kept here as data, each the ``cfg`` that the JAX
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
* ``UMI_MULTI``: the UMI multi-task model, a whole run config (the
  training, checkpoint, EMA, logging and loader sections too):
  ``uva_umi_multi.yaml`` over ``task/umi_multi.yaml`` and
  ``model/uva.yaml`` (mar_base at 256 px, 1024 frame tokens, 224 px frames
  upscaled on the device, 10-d relative-pose actions, B = 32) with the
  stage-2 overrides of ``scripts/training/train_uva_umi.sh:13-17``
  (``predict_action``, ``shift_action: false``, ``different_history_freq``)
  and the streams of the reference's UMI model (the umi case of
  ``tests/test_mar_import_parity.py:58-59``): ``use_proprioception`` (16-d
  state), ``use_history_action`` and ``language_emb_model: clip`` (the
  64-token text buffer: 1088 tokens attended). Its datasets are the three
  zarr stores ``data/umi/<name>.zarr`` that JAX's ``task/umi_multi.yaml``
  names (``tools/gen_synthetic_umi.py`` writes them), read lazily.
  ``predict_proprioception`` stays off: JAX's UMI branch of
  ``_build_proprio_train`` builds no target for it. JAX refuses history
  actions in training on UMI's 32-step window (15 history rows do not
  divide 1024 tokens), and so does the port: training takes
  ``UMI_TRAIN_OVERRIDES``.
* ``PUSHT_256_RUN``: ``PUSHT_256`` as a whole run config, the training,
  checkpoint, EMA, logging and loader sections of ``uva_pusht.yaml`` and
  ``task/pusht.yaml``'s dataset and runner as JAX composes them: no
  ``device_resident``, so the host loader, batch 16, ``data_aug`` (on the
  device; ``task.dataset.device_aug=false`` moves it into the loader, as
  JAX's ``device_aug`` does), ``val_ratio`` 0.02. The dataset is the
  committed ``corpora/pusht_demos_r5b.npz`` (JAX's config names the
  reference's replay buffer, which is not in the repository).
* ``TOOLHANG``: ``uva_toolhang.yaml`` (``task/toolhang.yaml`` +
  ``model/uva.yaml``: 240 px frames from two cameras, the side view the
  main one, the wrist camera a conditioning stream, 10-d actions) with
  ``use_proprioception`` (the 9-d eef pose and gripper state) and
  ``predict_proprioception`` (a 9-d proprioception head), as the toolhang
  case of ``tests/test_mar_import_parity.py:61-63``, and the action head on:
  a whole run config, its dataset the robomimic store
  ``data/robomimic/tool_hang/ph/image_abs.npz`` (JAX's config names the
  ``.hdf5``; ``tools/gen_synthetic_suites.py`` writes a synthetic store of
  the layout) and its runner ``RobomimicImageRunner`` (the ``robosuite``
  backend; ``task.env_runner.env_backend=stub`` runs it without robosuite).
* ``LIBERO10``: ``uva_libero10.yaml`` (``task/libero10.yaml`` +
  ``model/uva.yaml``: mar_base, 128 px agentview frames upscaled to 256 on
  the device, 4 x 16 x 16 = 1024 tokens, 10-d rot6d actions; the composed
  config has no ``language_emb_model``, so no text buffer: the runner's
  language goal is not read, as in JAX) with the action head on, a whole
  run config: the per-task stores under ``data/libero/libero_10`` (``.npz``
  or ``.hdf5``) with ``data_aug``, and ``make_libero_runners`` (the
  ``libero`` backend; ``task.env_runner.env_backend=stub`` runs it without
  LIBERO).

Training either suite takes ``SUITE_TRAIN_OVERRIDES``
(``grad_checkpointing``: B = 32 at N = 1024).

The 256 px configs have no checkpoint paths (the KL-16 VAE's
``kl16.ckpt`` and the MAR's release are not in the repository): their
weights load separately.
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


_UMI_SHAPE_META = {
    "image_resolution": 224,
    "action": {"shape": [10]},
    "obs": {
        "camera0_rgb": {"shape": [3, 224, 224], "type": "rgb"},
        "robot0_eef_pos": {"shape": [3], "type": "low_dim"},
        "robot0_eef_rot_axis_angle": {"shape": [6], "type": "low_dim"},
        "robot0_gripper_width": {"shape": [1], "type": "low_dim"},
        "robot0_eef_rot_axis_angle_wrt_start": {"shape": [6], "type": "low_dim"},
    },
}
_TOOLHANG_SHAPE_META = {
    "image_resolution": 240,
    "action": {"shape": [10]},
    "obs": {
        "sideview_image": {"shape": [3, 240, 240], "type": "rgb"},
        "robot0_eye_in_hand_image": {"shape": [3, 240, 240], "type": "rgb"},
        "robot0_eef_pos": {"shape": [3], "type": "low_dim"},
        "robot0_eef_quat": {"shape": [4], "type": "low_dim"},
        "robot0_gripper_qpos": {"shape": [2], "type": "low_dim"},
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


TOOLHANG = _run_config("toolhang", _TOOLHANG_SHAPE_META, "mar_base", 256, 128, None,
                       use_proprioception=True, predict_proprioception=True)

_UMI_DATASETS = {
    "cup": {"path": "data/umi/cup.zarr", "mask_mirror": True,
            "prompt": "pick up the cup and place it on the saucer"},
    "towel": {"path": "data/umi/towel.zarr", "mask_mirror": False, "prompt": "fold the towel"},
    "mouse": {"path": "data/umi/mouse.zarr", "mask_mirror": True,
              "prompt": "pick up the mouse and place it on the mousepad"},
}


def _training_sections(name: str, batch_size: int = 32, topk=None) -> dict:
    """The training sections that ``uva_umi_multi.yaml``, ``uva_toolhang.yaml``,
    ``uva_libero10.yaml`` and (with its batch and top-k) ``uva_pusht.yaml``
    share but for the run's name."""
    return {
        "name": "uva",
        "dataloader": {"batch_size": batch_size, "num_workers": 8, "shuffle": True},
        "val_dataloader": {"batch_size": batch_size, "num_workers": 8, "shuffle": False},
        "training": {
            "checkpoint_every": 10, "debug": False, "gradient_accumulate_every": 1,
            "lr_scheduler": "cosine", "lr_warmup_steps": 1000, "max_train_steps": None,
            "max_val_steps": None, "num_epochs": 3050, "resume": True, "rollout_every": 10,
            "sample_every": 5, "seed": 42, "use_ema": True, "val_every": 1, "mesh": {"data": -1},
        },
        "checkpoint": {"save_last_ckpt": True, "topk": topk or {
            "monitor_key": "val_action_l2_distances",
            "format_str": "epoch={epoch:04d}-val_action_l2={val_action_l2_distances:.4f}",
            "k": 5, "mode": "min"}},
        "ema": {"inv_gamma": 1.0, "max_value": 0.9999, "min_value": 0.0, "power": 0.75,
                "update_after_step": 0},
        "logging": {"name": f"train_uva_{name}", "project": "unified_video_action_tpu",
                    "mode": "offline"},
        "output_dir": f"data/outputs/train_uva_{name}",
    }


# uva_pusht.yaml's whole run (the training, checkpoint, EMA, logging and
# loader sections of uva_pusht.yaml, task/pusht.yaml's dataset and runner)
# on PUSHT_256's policy: the host loader (no device_resident), batch 16,
# data_aug on, the committed corpus in place of the reference's zarr
PUSHT_256_RUN = copy.deepcopy(PUSHT_256)
PUSHT_256_RUN["task"].update({
    "task_type": "single_dataset",
    "task_modes": [],
    "dataset": {
        "_target_": "unified_video_action_tpu_torch.data.pusht_dataset.PushTImageDataset",
        "horizon": 32, "pad_after": 7, "pad_before": 1, "seed": 42, "val_ratio": 0.02,
        "data_aug": True, "normalizer_type": "all",
        "dataset_path": "corpora/pusht_demos_r5b.npz",
    },
    "env_runner": {
        "_target_": "unified_video_action_tpu_torch.runners.pusht_runner.PushTImageRunner",
        "fps": 10, "max_steps": 300, "n_action_steps": 8, "n_envs": None, "n_obs_steps": 16,
        "n_test": 50, "n_test_vis": 4, "n_train": 6, "n_train_vis": 2,
        "test_start_seed": 100000, "train_start_seed": 0, "fix_goal": True,
    },
})
PUSHT_256_RUN.update(_training_sections("pusht", batch_size=16, topk={
    "monitor_key": "test_mean_score",
    "format_str": "epoch={epoch:04d}-test_mean_score={test_mean_score:.3f}", "k": 1, "mode": "max"}))

UMI_MULTI = _run_config("umi", _UMI_SHAPE_META, "mar_base", 256, 128, None,
                        shift_action=False, different_history_freq=True, use_proprioception=True,
                        use_history_action=True, language_emb_model="clip")
UMI_MULTI["task"].update({
    "task_type": "multiple_datasets",
    "task_modes": ["policy_model", "full_dynamic_model"],
    "datasets": copy.deepcopy(_UMI_DATASETS),
    "dataset": {
        "_target_": "unified_video_action_tpu_torch.data.umi_dataset.build_umi_multi_from_config",
        "datasets_cfg": copy.deepcopy(_UMI_DATASETS),
        "normalizer_type": "none",
        "random_img_sampling": True,
        "val_ratio": 0.02,
    },
})
UMI_MULTI.update(_training_sections("umi_multi"))
# what training UMI_MULTI takes: JAX's compute_loss refuses the history
# actions of UMI's 32-step window (15 rows, mar.py:412), so training runs
# without that stream; every other stream trains
UMI_TRAIN_OVERRIDES = ("model.policy.use_history_action=false",)

TOOLHANG["task"].update({
    "task_type": "single_dataset",
    "task_modes": [],
    "dataset": {
        "_target_": "unified_video_action_tpu_torch.data.robomimic_dataset.RobomimicReplayImageDataset",
        "dataset_path": "data/robomimic/tool_hang/ph/image_abs.npz",
        "shape_meta": copy.deepcopy(_TOOLHANG_SHAPE_META),
        "horizon": 32, "pad_before": 1, "pad_after": 7, "abs_action": True, "seed": 42,
        "val_ratio": 0.02, "normalizer_type": "all",
    },
    "env_runner": {
        "_target_": "unified_video_action_tpu_torch.runners.robomimic_runner.RobomimicImageRunner",
        "dataset_path": "data/robomimic/tool_hang/ph/image_abs.npz",
        "shape_meta": copy.deepcopy(_TOOLHANG_SHAPE_META),
        "max_steps": 700, "n_action_steps": 8, "n_obs_steps": 16, "n_test": 50, "n_train": 6,
        "test_start_seed": 100000, "abs_action": True,
    },
})
TOOLHANG.update(_training_sections("toolhang"))

_LIBERO_SHAPE_META = {
    "image_resolution": 128,
    "action": {"shape": [10]},
    "obs": {
        "agentview_rgb": {"shape": [3, 128, 128], "type": "rgb"},
        "language": {"shape": [15], "type": "low_dim"},
    },
}
LIBERO10 = _run_config("libero10", _LIBERO_SHAPE_META, "mar_base", 256, 128, None)
LIBERO10["task"].update({
    "task_type": "single_dataset",
    "task_modes": [],
    "dataset": {
        "_target_": "unified_video_action_tpu_torch.data.libero_dataset.LiberoReplayImageDataset",
        "dataset_dir": "data/libero/libero_10",
        "shape_meta": copy.deepcopy(_LIBERO_SHAPE_META),
        "horizon": 32, "pad_before": 1, "pad_after": 7, "abs_action": True, "seed": 42,
        "val_ratio": 0.02, "data_aug": True, "language_max_length": 77,
    },
    "env_runner": {
        "_target_": "unified_video_action_tpu_torch.runners.libero_runner.LiberoImageRunner",
        "dataset_dir": "data/libero/libero_10",
        "max_steps": 500, "n_action_steps": 8, "n_obs_steps": 16, "n_test": 10,
        "test_start_seed": 100000, "abs_action": True, "env_backend": "libero",
    },
})
LIBERO10.update(_training_sections("libero10"))

# what training the two suites takes: B = 32 at N = 1024 does not fit the
# card without recomputing the blocks' activations (as UMI at N = 1088)
SUITE_TRAIN_OVERRIDES = ("model.policy.autoregressive_model_params.grad_checkpointing=true",)


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
