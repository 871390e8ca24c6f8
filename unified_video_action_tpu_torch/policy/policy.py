"""UnifiedVideoActionPolicy (port of ``policy/policy.py``: for serving, at
:353-679, ``_prep_frames``, ``_encode_frames`` (with ``vae_encode_chunk``),
the modalities (``_prep_modalities``, ``_build_proprio_eval``, history
actions from ``past_action``), ``sample_policy``, the unnormalize step,
``predict_action`` and the latent-cached ``predict_action_cached``, each
with its ``*_async`` half; for training, the task-mode parsing (:188-209),
``init_params`` (:220), ``compute_loss`` (:681-766), ``_build_proprio_train``
(:768-842) and ``choose_task_mode`` (:844)).

``predict_action`` takes the observation dict, as JAX's does: it selects
the conditioning frames of the window on the host (packed to YUV420 under
``obs_codec="yuv420"``) and runs ``predict_action_frames`` on them, which
returns a (B, 16, action_dim) action chunk: decode, resize and map to
[-1, 1], VAE-encode and sample the posterior, scale the latents by
``LATENT_SCALE``, one MAR encoder+decoder pass, the action head's diffusion
sampler, then unnormalize. ``predict_action_cached`` takes the observation
window too, VAE-encodes only the selected frames it has not seen at the
previous control step and reuses the cached latents of the others. Their
``*_async`` halves do the same host work and return the action tensor on the
device without waiting for it (the rollout runner overlaps env stepping with
it). Randomness is either drawn from a ``torch.Generator`` or injected as a dict
of tensors (:meth:`UnifiedVideoActionPolicy.sample_noise` says which).

The constructor takes the JAX policy's keyword arguments (the
``model.policy`` section of a run config) so one config drives both. The
deployed tier is ``serving_quant="int8"`` (W8A8 dense layers in the MAR and
the action denoiser, ``QuantLinear``) with ``obs_codec="yuv420"``.

Tasks: PushT, the language-conditioned kitchen suite
(``language_emb_model="clip"``: every entry point takes ``language_goal``, a
string, a list of strings or precomputed (B or 1, 512) latents, encoded by
``text_encoder``, which is ``utils.language.HashTextEncoder`` until the CLIP
tokenizer is ported), UMI (its goal always precomputed latents, as JAX takes
it), toolhang and LIBERO (whose composed config has no text buffer: the
runner's goal is not read, as in JAX), Fetch and the human-video keypoint
task (``human_pp``: 14-d hand keypoints, frames of ``obs["image"]``, JAX's
robomimic-family state width where proprioception is asked for). The
action head takes any of JAX's four pools (``act_model_type``). The
conditioning streams follow the config:
``use_history_action`` (the obs dict's ``past_action``, normalized as the
actions), ``use_proprioception`` (the state of the task's keys: UMI's four
relative-pose keys, PushT's ``agent_pos``, robomimic's eef pose and gripper,
with toolhang's second camera VAE-encoded as a stream), ``predict_wrist_img``
and ``predict_proprioception`` (training heads), ``different_history_freq``
(the trainer draws the history frames). Other tasks are refused.

``train=True`` builds the policy for training: the MAR stays fp32, in train
mode and trainable, and ``compute_loss`` runs it in the compute dtype by
casting its parameters for the call (flax's ``dtype=bfloat16`` with fp32
parameters; the gradients reach the fp32 parameters); the VAE is frozen in
the compute dtype, as for serving. Training with a goal (``batch
["language_latents"]``) draws the label drop of classifier-free guidance.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer, NormalizerField
from unified_video_action_tpu_torch.models.initializers import init_module
from unified_video_action_tpu_torch.models.mar import (
    MODEL_SIZES,
    TASK_MODES,
    Mar,
    MarConfig,
    MarDropout,
)
from unified_video_action_tpu_torch.models.transformer import set_attn_impl, set_int8_impl
from unified_video_action_tpu_torch.models.vae import LATENT_SCALE, KLVae, sample_posterior
from unified_video_action_tpu_torch.utils import image as image_util
from unified_video_action_tpu_torch.utils import obs_codec as obs_codec_util
from unified_video_action_tpu_torch.utils.frames import select_frame_indices, split_trajectory
from unified_video_action_tpu_torch.utils.device import resolve_device
from unified_video_action_tpu_torch.utils.language import get_text_encoder

# Keys of the JAX policy's config that the port reads nowhere: the optimizer
# section (the trainer reads it from the config)
_TRAINING_KEYS = {"optimizer"}
# Serving options of the JAX policy that the port ignores: it always runs
# attention through its CUDA kernel (``set_attn_impl`` switches a model to the
# plain version), whatever the JAX program chose ("xla", "pallas", "ring").
_IGNORED_KEYS = {"attn_impl"}
# the tasks whose serving path is ported (a task matches if its name holds one)
_PORTED_TASKS = ("pusht", "kitchen", "umi", "toolhang", "libero", "fetch", "human_pp")
# the state keys of each task family's proprioception (policy.py:655-666, :786-811)
UMI_STATE_KEYS = ("robot0_eef_pos", "robot0_eef_rot_axis_angle", "robot0_gripper_width",
                  "robot0_eef_rot_axis_angle_wrt_start")
ROBOMIMIC_STATE_KEYS = ("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos")

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}


def _get(d: Optional[Mapping], key: str, default=None):
    v = (d or {}).get(key, default)
    return default if v is None else v


class UnifiedVideoActionPolicy:
    def __init__(
        self,
        shape_meta: dict,
        vae_model_params: dict,
        autoregressive_model_params: dict,
        action_model_params: dict,
        n_action_steps: int = 8,
        task_name: str = "pusht",
        normalizer_type: str = "all",
        compute_dtype: str = "bfloat16",
        serving_quant: Optional[str] = None,
        obs_codec: Optional[str] = None,
        vae_encode_chunk: Optional[int] = None,
        language_emb_model: Optional[str] = None,
        selected_training_mode: Optional[str] = None,
        task_modes: Sequence[str] = (),
        shift_action: bool = True,
        use_history_action: Optional[bool] = None,
        use_proprioception: Optional[bool] = None,
        action_mask_ratio: float = 0.5,
        different_history_freq: Optional[bool] = None,
        predict_wrist_img: Optional[bool] = None,
        predict_proprioception: Optional[bool] = None,
        train: bool = False,
        device: Union[str, torch.device] = "cuda",
        **kwargs: Any,
    ):
        for key, value in kwargs.items():
            if key in _TRAINING_KEYS or key in _IGNORED_KEYS:
                continue
            raise TypeError(f"unknown policy option {key!r}")
        if not any(t in task_name for t in _PORTED_TASKS):
            raise NotImplementedError(f"task {task_name!r} is not ported yet; only {_PORTED_TASKS}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        if serving_quant not in (None, "", "none", "int8"):
            raise ValueError(f"serving_quant must be None or 'int8', got {serving_quant!r}")
        if obs_codec not in (None, "", "none", "raw", "yuv420"):
            raise ValueError(f"obs_codec must be None or 'yuv420', got {obs_codec!r}")
        amp = autoregressive_model_params
        predict_action = bool(_get(action_model_params, "predict_action", False))

        self.device = resolve_device(device)
        self.dtype = _DTYPES[compute_dtype]
        self.task_name = task_name
        self.n_action_steps = n_action_steps
        self.normalizer_type = normalizer_type
        self.shift_action = shift_action
        self.training = train
        self.action_dim = int(_get(_get(shape_meta, "action"), "shape", [2])[0])
        self.temperature = float(_get(amp, "temperature", 1.0))
        self.serving_quant = serving_quant if serving_quant == "int8" else None
        self.obs_codec = obs_codec if obs_codec == "yuv420" else None
        self.vae_encode_chunk = int(vae_encode_chunk or 0)
        self.language_emb_model = language_emb_model
        self.use_history_action = bool(use_history_action)
        self.use_proprioception = bool(use_proprioception)
        self.different_history_freq = bool(different_history_freq)
        # (encoder, CLIP token budget), or (None, None) without language
        self.text_encoder, self.max_length = get_text_encoder(task_name, language_emb_model)

        model_size = _get(amp, "model_size", "mar_base")
        if model_size == "custom":
            size_kwargs = {
                k: int(amp[k]) for k in (
                    "encoder_embed_dim", "encoder_depth", "encoder_num_heads",
                    "decoder_embed_dim", "decoder_depth", "decoder_num_heads",
                )
            }
        else:
            size_kwargs = MODEL_SIZES[model_size]
        # the state's and the proprioception head's widths by task (policy.py:106-108, :140)
        family = next((k for k in ("umi", "pusht") if k in task_name), "")
        self.mar_cfg = MarConfig(
            img_size=int(_get(amp, "img_size", 256)),
            vae_stride=int(_get(amp, "vae_stride", 16)),
            patch_size=int(_get(amp, "patch_size", 1)),
            vae_embed_dim=int(_get(amp, "vae_embed_dim", 16)),
            attn_dropout=float(_get(amp, "attn_dropout", 0.1)),
            proj_dropout=float(_get(amp, "proj_dropout", 0.1)),
            mask_ratio_min=float(_get(amp, "mask_ratio_min", 0.7)),
            diffloss_d=int(_get(amp, "diffloss_d", 6)),
            diffloss_w=int(_get(amp, "diffloss_w", 1024)),
            num_sampling_steps=str(_get(amp, "num_sampling_steps", "100")),
            predict_video=bool(_get(amp, "predict_video", True)),
            predict_action=predict_action,
            act_diff_training_steps=int(_get(amp, "act_diff_training_steps", 1000)),
            diffloss_act_d=int(_get(amp, "diffloss_act_d", 6)),
            diffloss_act_w=int(_get(amp, "diffloss_act_w", 1024)),
            act_diff_testing_steps=str(_get(amp, "act_diff_testing_steps", "100")),
            act_model_type=_get(action_model_params, "act_model_type", "conv_fc"),
            action_dim=self.action_dim,
            language_emb_model=language_emb_model,
            label_drop_prob=float(_get(amp, "label_drop_prob", 0.1)),
            use_proprioception=self.use_proprioception,
            use_history_action=self.use_history_action,
            action_mask_ratio=float(action_mask_ratio),
            different_history_freq=self.different_history_freq,
            predict_wrist_img=bool(predict_wrist_img),
            predict_proprioception=bool(predict_proprioception),
            proprio_dim={"umi": 16, "pusht": 2}.get(family, 9),
            proprio_pred_dim={"umi": 6, "toolhang": 9}.get(task_name, 0),
            proprio_use_image="toolhang" in task_name,
            task_name=task_name,
            quant=self.serving_quant == "int8",
            grad_checkpointing=bool(_get(amp, "grad_checkpointing", False)),
            **size_kwargs,
        )
        self.pretrained_model_path = _get(amp, "pretrained_model_path")
        self.task_modes = self._parse_task_modes(selected_training_mode, task_modes)
        ddconfig = _get(vae_model_params, "ddconfig", {})
        self.vae_path = _get(vae_model_params, "autoencoder_path")
        with torch.device(self.device):
            self.mar = Mar(self.mar_cfg)
            self.vae = KLVae(
                embed_dim=int(_get(ddconfig, "vae_embed_dim", 16)),
                ch_mult=tuple(_get(ddconfig, "ch_mult", (1, 1, 2, 2, 4))),
                resolution=self.mar_cfg.img_size,
                ch=int(_get(ddconfig, "ch", 128)),
            )
        if train:
            if self.serving_quant or self.obs_codec:
                raise ValueError("serving_quant and obs_codec are serving options; train without them")
            self.mar.train()
        else:
            self.mar.to(self.dtype).eval().requires_grad_(False)
        self.vae.to(self.dtype).eval().requires_grad_(False)
        self.normalizer = LinearNormalizer({"action": NormalizerField.identity(self.action_dim)})
        # the VAE's fp32 flax tree as read (init_params, load_params)
        self.vae_tree: Optional[Dict[str, Dict]] = None

    def _parse_task_modes(self, selected: Optional[str], task_modes: Sequence[str]) -> Tuple[str, ...]:
        """The modes training draws from (``policy.py:188-209``): every mode,
        ``task_modes``, one selected mode, or the stage-2 pair that
        ``policy_model_full_dynamics_model`` names; without the action head,
        the action-only modes drop out."""
        if selected is None:
            modes = tuple(task_modes) if task_modes else TASK_MODES
        elif selected == "policy_model_full_dynamics_model":
            modes = ("policy_model", "full_dynamic_model")
        else:
            modes = (selected,)
        for m in modes:
            if m not in TASK_MODES:
                raise ValueError(f"unknown task mode {m!r}; the modes are {TASK_MODES}")
        if not self.mar_cfg.predict_action:
            modes = tuple(m for m in modes if m not in ("policy_model", "inverse_model")) \
                or ("video_model",)
        return modes

    def choose_task_mode(self, rng: np.random.Generator) -> str:
        """One batch's task mode, drawn on the host (the reference's
        ``random.choice``)."""
        return self.task_modes[rng.integers(len(self.task_modes))]
    @classmethod
    def from_run_config(cls, meta_path: str, **overrides: Any) -> "UnifiedVideoActionPolicy":
        """Build from an exported checkpoint's ``meta.json`` (plain JSON; its
        ``cfg`` is the run config), e.g.
        ``pretrained_models/uva_pusht_small/latest/meta.json``."""
        with open(meta_path) as f:
            return cls.from_cfg(json.load(f)["cfg"], **overrides)

    @classmethod
    def from_cfg(cls, cfg: Mapping, **overrides: Any) -> "UnifiedVideoActionPolicy":
        """Build from a run config (a nested dict: ``model.policy`` and
        ``task.name``), e.g. ``from_cfg(config.PUSHT_256, device="cuda")``,
        the reference's 256 px PushT model; ``overrides`` replace policy
        options."""
        kwargs = {k: v for k, v in cfg["model"]["policy"].items() if k != "_target_"}
        kwargs["task_name"] = cfg["task"]["name"]
        kwargs.update(overrides)
        return cls(**kwargs)

    # -- weights ------------------------------------------------------------

    def load_params(self, mar_tree: Mapping, vae_tree: Mapping) -> None:
        """Load the JAX policy's ``{"mar": ..., "vae": ...}`` trees (flax
        layout, numpy leaves) through the weight bridge. Under
        ``serving_quant="int8"`` the bridge quantizes the dense kernels from
        their fp32 values, whatever the compute dtype. ``vae_tree`` is kept
        as :attr:`vae_tree`, in fp32 where the VAE runs in bf16. Either tree
        must hold every leaf, the decoder's and ``post_quant_conv`` too."""
        convert.load_into(self.mar, mar_tree)
        convert.load_into(self.vae, vae_tree)
        self.vae_tree = vae_tree

    def init_params(self, seed: int) -> None:
        """JAX's ``init_params``: the MAR's parameters drawn from flax's
        initializers (``models/initializers.py``) by a generator on the
        policy's device seeded with ``seed``, the VAE read from
        ``vae_model_params.autoencoder_path`` (an npz of the flax tree, or
        the reference's torch ``.ckpt`` such as ``kl16.ckpt``; kept in fp32
        as :attr:`vae_tree`; without a path the VAE keeps its weights, and
        ``load_params`` sets them), then the stage bootstrap from
        ``pretrained_model_path`` where that path exists
        (:meth:`load_pretrained`)."""
        init_module(self.mar, torch.Generator(device=self.device).manual_seed(seed))
        if self.vae_path:
            if not os.path.exists(self.vae_path):
                raise FileNotFoundError(f"autoencoder_path {self.vae_path!r} does not exist")
            if self.vae_path.endswith(".npz"):
                self.vae_tree = convert.load_flat_npz(self.vae_path)
            else:
                self.vae_tree = self._import_vae_ckpt(self.vae_path)
            convert.load_into(self.vae, self.vae_tree)
        if self.pretrained_model_path and os.path.exists(self.pretrained_model_path):
            self.load_pretrained(self.pretrained_model_path)

    def _import_vae_ckpt(self, path: str) -> Dict[str, Dict]:
        """The VAE's flax tree with the reference torch checkpoint ``path``
        (its ``model`` state dict, or the file's top level) merged on where
        the shapes match (JAX's ``_load_vae_ckpt``, ``policy.py:284-291``).
        The state dict is read in the geometry of the reference's
        ``kl16.ckpt`` (``import_kl_vae``'s defaults, as JAX's call reads it),
        so the encoder's per-level attention is taken from the level where
        it sits at 256 px."""
        from unified_video_action_tpu_torch.models import torch_import

        ckpt = torch_import.load_torch_checkpoint(path)
        sd = torch_import.state_dict_arrays(ckpt.get("model", ckpt))
        imported = torch_import.import_kl_vae(sd)
        merged, skipped = convert.merge_params(convert.to_flax_tree(self.vae), imported)
        if skipped:
            print(f"[vae import] skipped {len(skipped)} leaves: {skipped[:5]}", flush=True)
        return merged

    def load_pretrained(self, path: str) -> None:
        """The stage bootstrap (JAX's ``_load_mar_ckpt``, ``policy.py:
        292-340``): the MAR weights of ``path`` merged onto the current ones
        where the flax path exists and the shape matches
        (``convert.merge_params``). ``path`` is a checkpoint directory of the
        port (``training/checkpoint.py``: a full checkpoint or a slim export,
        the EMA weights where it holds them) or a reference torch file: the
        framework's checkpoint (``state_dicts.ema_model``, keys under
        ``model.``) or the MAR release (``model_ema``), through
        ``models/torch_import.py``. Sets ``_last_mar_import_skipped`` (the
        checkpoint's leaves left out, as JAX counts them) and
        ``_last_mar_import_kept_at_init`` (this MAR's leaves that the
        checkpoint did not set: absent from it or of another shape), and
        prints both. An orbax directory is refused (ROADMAP, "Not queued":
        the card has no orbax)."""
        from unified_video_action_tpu_torch.models import torch_import
        from unified_video_action_tpu_torch.training import checkpoint as ckpt_lib

        if not os.path.isdir(path):
            c = self.mar_cfg
            sd = torch_import.state_dict_arrays(
                torch_import.mar_state_dict(torch_import.load_torch_checkpoint(path)))
            src = torch_import.import_mar(sd, encoder_depth=c.encoder_depth,
                                          decoder_depth=c.decoder_depth,
                                          diffloss_depth=c.diffloss_d,
                                          diffloss_act_depth=c.diffloss_act_d)
        elif ckpt_lib.is_port_checkpoint(path):
            src, _ = ckpt_lib.read_weights(path)
        elif os.path.isdir(os.path.join(path, "state")):
            raise NotImplementedError(
                f"pretrained_model_path {path!r} is an orbax checkpoint: reading orbax needs "
                f"JAX, which the port does not import (ROADMAP, 'Not queued'); give a checkpoint "
                f"directory of the port or a reference torch .ckpt")
        else:
            raise FileNotFoundError(f"pretrained_model_path {path!r} holds no checkpoint")
        init = convert.to_flax_tree(self.mar)
        merged, skipped = convert.merge_params(init, src)
        flat_init, flat_src = convert.flatten_tree(init), convert.flatten_tree(src)
        kept = [p for p, v in flat_init.items()
                if p not in flat_src or np.shape(flat_src[p]) != np.shape(v)]
        convert.load_into(self.mar, merged)
        self._last_mar_import_skipped = len(skipped)
        self._last_mar_import_kept_at_init = len(kept)
        print(f"[mar import] stage bootstrap from {path}: {len(kept)} leaves kept at init "
              f"(absent from the checkpoint or of another shape); {len(skipped)} checkpoint "
              f"leaves skipped{': ' + str(skipped[:5]) if skipped else ''}", flush=True)

    def vae_params(self) -> Dict[str, Dict]:
        """The VAE's flax tree in fp32: :attr:`vae_tree` where one was read,
        else the VAE's current weights."""
        return self.vae_tree if self.vae_tree is not None else convert.to_flax_tree(self.vae)

    def set_normalizer(self, normalizer: LinearNormalizer) -> None:
        self.normalizer = normalizer

    def set_attn_impl(self, attn_impl: str) -> None:
        """``"kernel"`` or ``"plain"`` for every attention layer of the MAR."""
        set_attn_impl(self.mar, attn_impl)

    def set_int8_impl(self, int8_impl: str) -> None:
        """``"kernel"`` or ``"plain"`` for every W8A8 layer of the MAR and the
        action denoiser (``serving_quant="int8"`` only)."""
        set_int8_impl(self.mar, int8_impl)

    # -- serving ------------------------------------------------------------

    @property
    def encodes_second_camera(self) -> bool:
        """Whether serving VAE-encodes a second camera (toolhang's wrist view,
        ``proprio_use_image``) as a conditioning stream."""
        return self.mar_cfg.use_proprioception and self.mar_cfg.proprio_use_image

    def noise_shapes(self, batch: int, n_new: Optional[int] = None) -> Dict[str, tuple]:
        """Shapes of one call's draws; ``n_new`` is the number of frames the
        call VAE-encodes (all ``n_frames`` unless a cached call reuses some).
        A second camera adds its posterior noise over all ``n_frames``
        (``vae_wrist``: a cached call encodes it anew, as JAX does)."""
        c = self.mar_cfg
        if not c.predict_action:
            raise ValueError("predicting actions needs the action head "
                             "(action_model_params.predict_action)")
        n = batch * c.num_action_tokens
        n_new = c.n_frames if n_new is None else n_new
        latent = (c.vae_embed_dim, c.seq_hw, c.seq_hw)
        out = {
            "vae": (batch * n_new, *latent),
            "init": (n, c.action_dim),
            "steps": (self.mar.diffactloss.num_steps, n, c.action_dim),
        }
        if self.encodes_second_camera:
            out["vae_wrist"] = (batch * c.n_frames, *latent)
        return out

    def sample_noise(self, batch: int, generator: Optional[torch.Generator] = None,
                     n_new: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The standard-normal draws of one call: the VAE posterior noise,
        the sampler's start and its per-step noise (and the second camera's
        posterior noise where there is one)."""
        return {
            k: torch.randn(s, generator=generator, device=self.device, dtype=torch.float32)
            for k, s in self.noise_shapes(batch, n_new).items()
        }

    def _noise(self, batch: int, n_new: int, noise: Optional[Mapping[str, torch.Tensor]],
               generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        if noise is None:
            return self.sample_noise(batch, generator, n_new)
        want = self.noise_shapes(batch, n_new)
        for k, s in want.items():
            if tuple(noise[k].shape) != s:
                raise ValueError(f"noise[{k!r}] must be {s}, got {tuple(noise[k].shape)}")
        return {k: noise[k].to(self.device, torch.float32) for k in want}

    def _prep_frames(self, frames: torch.Tensor) -> torch.Tensor:
        if self.obs_codec == "yuv420" and frames.dim() == 3:
            # packed (B, T, P) planar YUV420 -> RGB in [0, 1]
            frames = obs_codec_util.decode_yuv420(frames)
        if frames.dtype == torch.uint8:
            frames = frames.float() / 255.0
        frames = image_util.resize_video(frames, self.mar_cfg.img_size)
        return image_util.to_model_range(frames)

    def _encode_frames(self, frames: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """(B, T, 3, H, W) in [-1, 1] -> (B, T, C, h, w) scaled latents. With
        ``vae_encode_chunk`` = ck and more than ck frames, the VAE encodes ck
        frames a call and the remainder in one more (``policy.py:352-384``);
        the posterior noise is drawn for all frames at once either way."""
        B, T = frames.shape[:2]
        flat = frames.reshape(B * T, *frames.shape[2:])
        ck = self.vae_encode_chunk
        if ck and flat.shape[0] > ck:
            parts = [self.vae.encode(flat[i:i + ck]) for i in range(0, flat.shape[0], ck)]
            mean, logvar = (torch.cat(t) for t in zip(*parts))
        else:
            mean, logvar = self.vae.encode(flat)
        z = sample_posterior(mean, logvar, noise) * LATENT_SCALE
        return z.reshape(B, T, *z.shape[1:])

    def _build_proprio_eval(self, obs: Mapping[str, Any],
                            frame_idx: Optional[Sequence[int]] = None
                            ) -> Optional[Dict[str, torch.Tensor]]:
        """JAX's ``_build_proprio_eval`` (``policy.py:651-675``) on the host:
        None without proprioception; else ``{"state": (B, n, proprio_dim)}``
        fp32 from the task's keys over the whole window (UMI's four
        relative-pose keys, PushT's ``agent_pos``, robomimic's eef position,
        quaternion and gripper), and for robomimic the wrist camera's frames
        at ``frame_idx`` as ``second_image_raw`` (uint8, floats in [0, 1]
        rounded), which the device encodes."""
        if not self.use_proprioception:
            return None

        def state(keys):
            return torch.from_numpy(np.concatenate(
                [np.asarray(obs[k], dtype=np.float32) for k in keys], axis=-1))

        if "umi" in self.task_name:
            return {"state": state(UMI_STATE_KEYS)}
        if "pusht" in self.task_name:
            return {"state": state(("agent_pos",))}
        out = {"state": state(ROBOMIMIC_STATE_KEYS)}
        if "wrist_image" in obs:
            wrist = np.asarray(obs["wrist_image"])
            if frame_idx is not None:
                wrist = wrist[:, np.asarray(frame_idx)]
            if wrist.dtype != np.uint8 and wrist.max() <= 1.0 + 1e-6:
                wrist = np.round(wrist * 255.0).astype(np.uint8)
            out["second_image_raw"] = torch.from_numpy(np.ascontiguousarray(wrist))
        return out

    def _history_actions(self, obs: Mapping[str, Any]) -> Optional[torch.Tensor]:
        """The obs dict's ``past_action`` (B, n, A) where the config has
        history actions (``policy.py:534-536``), else None."""
        if not (self.use_history_action and "past_action" in obs):
            return None
        return torch.from_numpy(np.asarray(obs["past_action"], dtype=np.float32))

    def _prep_modalities(self, proprio: Optional[Mapping[str, torch.Tensor]],
                         history_actions: Optional[torch.Tensor],
                         noise: Mapping[str, torch.Tensor]):
        """The device half of the modalities (``policy.py:404-416``): the
        second camera VAE-encoded under ``noise["vae_wrist"]``, the history
        actions normalized as the actions are."""
        if proprio is not None:
            proprio = {k: v.to(self.device) for k, v in proprio.items()}
            if "second_image_raw" in proprio:
                raw = proprio.pop("second_image_raw")
                proprio["second_image"] = self._encode_frames(self._prep_frames(raw),
                                                              noise["vae_wrist"])
        if history_actions is not None:
            history_actions = history_actions.to(self.device, torch.float32)
            if self.normalizer_type == "all":
                history_actions = self.normalizer["action"].normalize(history_actions)
        return proprio, history_actions

    # -- training -----------------------------------------------------------

    @property
    def encodes_wrist_in_training(self) -> bool:
        """Whether a training batch's wrist camera is VAE-encoded
        (``policy.py:826``): as a conditioning stream or the wrist head's target."""
        c = self.mar_cfg
        return ((c.use_proprioception or c.predict_wrist_img)
                and (c.proprio_use_image or c.predict_wrist_img))

    def train_noise_shapes(self, batch: int, n_sel: int = 8,
                           n_history: Optional[int] = None) -> Dict[str, tuple]:
        """Shapes of one training loss's draws over ``n_sel`` selected frames:
        the VAE posterior noise of the conditioning and target halves (and
        of the wrist camera's, where it is encoded), and the MAR's
        (``Mar.train_draw_shapes``, the history keep mask over ``n_history``
        past actions)."""
        c = self.mar_cfg
        vae = (batch * (n_sel // 2), c.vae_embed_dim, c.seq_hw, c.seq_hw)
        out = {"vae_cond": vae, "vae_target": vae}
        if self.encodes_wrist_in_training:
            out["vae_wrist_cond"] = vae
            if c.predict_wrist_img:
                out["vae_wrist_target"] = vae
        return {**out, **self.mar.train_draw_shapes(batch, n_history)}

    def sample_train_noise(self, batch: int, generator: torch.Generator,
                           n_sel: int = 8, n_history: Optional[int] = None) -> Dict[str, torch.Tensor]:
        shapes = self.train_noise_shapes(batch, n_sel, n_history)
        out = {k: torch.randn(s, generator=generator, device=self.device)
               for k, s in shapes.items() if k.startswith("vae")}
        out.update(self.mar.sample_train_draws(batch, generator, self.device, n_history))
        return out

    def _build_proprio_train(self, obs: Mapping[str, Any], frame_indices: np.ndarray,
                             noise: Mapping[str, torch.Tensor]):
        """JAX's ``_build_proprio_train`` (``policy.py:768-842``) -> (proprio,
        proprio_target). UMI: the state of its four keys over the 16-step
        window, gathered per sample at the first half of ``img_indices``
        under ``different_history_freq``; PushT: ``agent_pos``'s first half;
        robomimic: the eef pose and gripper, the first half conditioning (at
        the history frames of ``frame_indices`` under
        ``different_history_freq``) and the second the proprioception head's
        target; the wrist camera at ``frame_indices`` resized and encoded,
        its first half the second image, its second the wrist head's target."""
        c = self.mar_cfg
        if not (c.use_proprioception or c.predict_wrist_img):
            return None, None
        proprio: Dict[str, torch.Tensor] = {}
        target = None

        def cat(keys):
            return torch.cat([torch.as_tensor(obs[k]).float() for k in keys], dim=-1)

        if "umi" in self.task_name:
            state = cat(UMI_STATE_KEYS)
            if c.different_history_freq and "img_indices" in obs:
                idx = torch.as_tensor(obs["img_indices"]).to(torch.int64)
                idx = idx.reshape(idx.shape[0], -1)[:, : idx.shape[1] // 2]
                state = state.gather(1, idx[..., None].expand(-1, -1, state.shape[-1]))
            proprio["state"] = state
        elif "pusht" in self.task_name:
            ap = torch.as_tensor(obs["agent_pos"]).float()
            proprio["state"] = ap[:, : ap.shape[1] // 2]
        else:
            full = cat(ROBOMIMIC_STATE_KEYS)
            half = full.shape[1] // 2
            state = full[:, :half]
            if c.different_history_freq:
                hist = torch.as_tensor(np.asarray(frame_indices)[: len(frame_indices) // 2],
                                       device=state.device)
                state = state[:, hist]
            proprio["state"] = state
            if c.predict_proprioception:
                target = full[:, half:]
        if self.encodes_wrist_in_training:
            wrist = torch.as_tensor(obs["wrist_image"])
            wrist = wrist[:, torch.as_tensor(np.asarray(frame_indices), device=wrist.device)]
            wf = image_util.to_model_range(image_util.resize_video(
                image_util.to_unit_float(wrist), c.img_size))
            half = wf.shape[1] // 2
            with torch.no_grad():
                proprio["second_image"] = self._encode_frames(wf[:, :half], noise["vae_wrist_cond"])
                if c.predict_wrist_img:
                    proprio["pred_second_image"] = self._encode_frames(wf[:, half:],
                                                                       noise["vae_wrist_target"])
        return proprio, target

    def compute_loss(self, batch: Mapping[str, Any], task_mode: str,
                     frame_indices: Optional[np.ndarray] = None, pregathered: bool = False,
                     noise: Optional[Mapping[str, torch.Tensor]] = None,
                     generator: Optional[torch.Generator] = None,
                     drop: MarDropout = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One task mode's training loss (``policy.py:681-766``) -> (loss,
        video loss, action loss), fp32 scalars with the MAR's graph.

        ``batch``: ``{"obs": {"image": (B, T, 3, H, W) uint8 or float in
        [0, 1] (or the task's camera key), optional "aug_top"/"aug_left"/
        "aug_sigma" (B,), the state keys and "img_indices" of the task},
        "action": (B, T_a, A), optional "language_latents": (B, 512)}`` on
        the policy's device. ``frame_indices``: the frames that train
        (default the training selection of T); with ``pregathered`` (or
        ``img_indices`` in the obs, UMI's items) the image holds only those
        frames already. The first half of them conditions, the second is the
        target; the VAE encodes both under ``no_grad``. The actions split
        into history and future on their own length (``split_trajectory``).
        ``noise`` injects the draws of :meth:`sample_train_noise`, ``drop``
        the blocks' keep masks (``{"encoder_blocks": [...],
        "decoder_blocks": [...]}``); what is not given is drawn from
        ``generator``."""
        if not self.training:
            raise RuntimeError("compute_loss needs a policy built with train=True")
        if task_mode not in TASK_MODES:
            raise ValueError(f"task_mode must be one of {TASK_MODES}, got {task_mode!r}")
        c = self.mar_cfg
        obs = image_util.remap_image_keys(self.task_name, dict(batch["obs"]))
        image = image_util.to_unit_float(obs["image"])
        B, T = image.shape[:2]
        actions = batch["action"]
        if self.normalizer_type == "all":
            actions = self.normalizer["action"].normalize(actions)
        pregathered = pregathered or "img_indices" in obs
        if frame_indices is None:
            frame_indices = np.arange(T) if pregathered else select_frame_indices(T, eval=False)
        sel = image if pregathered else image[:, torch.as_tensor(frame_indices, device=image.device)]
        if "aug_top" in obs:
            sel = image_util.augment_video(sel, obs["aug_top"], obs["aug_left"], obs["aug_sigma"])
        frames = image_util.to_model_range(image_util.resize_video(sel, c.img_size))
        half = len(frame_indices) // 2
        history, future = split_trajectory(actions, actions.shape[1], self.shift_action,
                                           self.use_history_action)
        n_history = None if history is None else history.shape[1]
        if drop is None and (c.attn_dropout or c.proj_dropout):
            drop = generator
            if generator is None:
                raise ValueError("compute_loss draws the dropout masks that drop does not give "
                                 "from generator: pass one")
        if noise is None:
            if generator is None:
                raise ValueError("compute_loss draws the noise that noise does not give from "
                                 "generator: pass one")
            noise = self.sample_train_noise(B, generator, 2 * half, n_history)
        else:
            want = self.train_noise_shapes(B, 2 * half, n_history)
            for k, s in want.items():
                if tuple(noise[k].shape) != s:
                    raise ValueError(f"noise[{k!r}] must be {s}, got {tuple(noise[k].shape)}")
        with torch.no_grad():
            cond = self._encode_frames(frames[:, :half], noise["vae_cond"])
            target = self._encode_frames(frames[:, half:], noise["vae_target"])
        proprio, proprio_target = self._build_proprio_train(obs, frame_indices, noise)
        text = batch.get("language_latents") if c.has_text else None
        args = (target, cond, task_mode, future, noise, drop)
        kwargs = dict(history_actions=history, text_latents=text, proprio=proprio,
                      proprio_target=proprio_target)
        if self.dtype == torch.float32:
            return self.mar(*args, **kwargs)
        cast = {n: p.to(self.dtype) for n, p in self.mar.named_parameters()}
        return functional_call(self.mar, cast, args, kwargs)

    def _encode_language_goal(self, language_goal: Any, batch: int) -> Optional[torch.Tensor]:
        """JAX's ``_encode_language_goal`` (``policy.py:632-649``): None without
        language or without a goal; a string or a list of strings is encoded
        by ``text_encoder``, an array (and any UMI goal) passes through as
        precomputed latents, and one goal is tiled over the batch. Returns
        (B, 512) fp32 on the policy's device."""
        if self.language_emb_model is None or language_goal is None:
            return None
        if isinstance(language_goal, torch.Tensor):
            lat = language_goal
        elif "umi" in self.task_name or isinstance(language_goal, np.ndarray):
            lat = torch.as_tensor(np.asarray(language_goal))
        else:
            lat = torch.from_numpy(self.text_encoder.encode(language_goal))
        if lat.dim() == 2 and lat.shape[0] == 1 and batch > 1:
            lat = lat.expand(batch, *lat.shape[1:])
        return lat.to(self.device, torch.float32)

    def _sample(self, cond: torch.Tensor, noise: Mapping[str, torch.Tensor],
                text_latents: Optional[torch.Tensor] = None,
                history_actions: Optional[torch.Tensor] = None,
                proprio: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """(B, T, C, h, w) conditioning latents -> (B, 16, A) unnormalized actions."""
        nact = self.mar.sample_policy(cond, noise["init"], noise["steps"],
                                      temperature=self.temperature, text_latents=text_latents,
                                      history_actions=history_actions, proprio=proprio)
        nact = nact[..., : self.action_dim]
        if self.normalizer_type == "all":
            nact = self.normalizer["action"].unnormalize(nact)
        return nact

    def predict_action(self, obs_dict: Mapping[str, Any], generator: Optional[torch.Generator] = None,
                       noise: Optional[Mapping[str, torch.Tensor]] = None,
                       language_goal: Any = None) -> Dict[str, np.ndarray]:
        """JAX's ``predict_action`` (``policy.py:574-590``): ``obs_dict["image"]``
        (or the task's camera key, e.g. the kitchen's ``agentview_rgb`` or
        UMI's ``camera0_rgb``) is the observation window on the host, (B, T,
        3, H, W) uint8 or float in [0, 1], beside the state keys and
        ``past_action`` the config reads; ``language_goal`` as
        :meth:`_encode_language_goal` takes it. Returns numpy ``{"action":
        (B, n_action_steps, A), "action_pred": (B, 16, A)}``, unnormalized
        fp32: the action of :meth:`predict_action_async`, copied to the host."""
        action_pred = self.predict_action_async(obs_dict, generator, noise,
                                                language_goal).cpu().numpy()
        return {"action": action_pred[:, : self.n_action_steps], "action_pred": action_pred}

    @torch.no_grad()
    def predict_action_async(self, obs_dict: Mapping[str, Any],
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[Mapping[str, torch.Tensor]] = None,
                             language_goal: Any = None) -> torch.Tensor:
        """The dispatch half of :meth:`predict_action` (``policy.py:592-630``):
        the frames of ``select_frame_indices(T)`` are selected on the host,
        float frames rounded to uint8, and under ``obs_codec="yuv420"`` packed
        to YUV420 there; the goal, the history actions and the state (with
        the wrist camera's selected frames) are read on the host; one copy to
        the device, then :meth:`predict_action_frames`. Returns the (B, 16,
        A) unnormalized action tensor on the policy's device, without
        waiting for it."""
        obs = image_util.remap_image_keys(self.task_name, dict(obs_dict))
        image = np.asarray(obs["image"])
        idx = select_frame_indices(image.shape[1], self.mar_cfg.n_frames)
        sel = image[:, idx]
        if sel.dtype != np.uint8 and sel.max() <= 1.0 + 1e-6:
            sel = np.round(sel * 255.0).astype(np.uint8)
        if self.obs_codec == "yuv420":
            sel = obs_codec_util.encode_yuv420(sel)
        frames = torch.from_numpy(np.ascontiguousarray(sel))
        text_latents = self._encode_language_goal(language_goal, image.shape[0])
        return self.predict_action_frames(frames, generator, noise, text_latents,
                                          self._history_actions(obs),
                                          self._build_proprio_eval(obs, idx))

    @torch.no_grad()
    def predict_action_frames(self, frames: torch.Tensor, generator: Optional[torch.Generator] = None,
                              noise: Optional[Mapping[str, torch.Tensor]] = None,
                              text_latents: Optional[torch.Tensor] = None,
                              history_actions: Optional[torch.Tensor] = None,
                              proprio: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """The counterpart of JAX's jitted predict program (``policy.py:436-451``,
        ``_build_predict_fn``), which :meth:`predict_action` runs on the frames
        it selected: frames as the device receives them, uint8 (B, 4, 3, H, W)
        or float in [0, 1], and under ``obs_codec="yuv420"`` only packed uint8
        (B, 4, P) (a 5-D tensor is refused: it would skip the codec) -> (B, 16,
        A) unnormalized fp32 action chunk on the policy's device (the first
        ``n_action_steps`` are executed). ``noise`` injects the draws of
        :meth:`sample_noise`; otherwise they come from ``generator``.
        ``text_latents``: the encoded goal (B, 512), or None;
        ``history_actions`` (B, n, A) unnormalized, or None; ``proprio``: as
        :meth:`_build_proprio_eval` makes it, or None."""
        n = self.mar_cfg.n_frames
        want = f"packed (B, {n}, P)" if self.obs_codec == "yuv420" else f"(B, {n}, 3, H, W)"
        if frames.dim() != (3 if self.obs_codec == "yuv420" else 5) or frames.shape[1] != n:
            raise ValueError(f"frames must be {want}, got {tuple(frames.shape)}")
        B = frames.shape[0]
        noise = self._noise(B, n, noise, generator)
        cond = self._encode_frames(self._prep_frames(frames.to(self.device)), noise["vae"])
        proprio, history_actions = self._prep_modalities(proprio, history_actions, noise)
        return self._sample(cond, noise, text_latents, history_actions, proprio)

    def cache_plan(self, total_frames: int, cache: Optional[torch.Tensor],
                   n_shift: int) -> Tuple[List[int], List[int]]:
        """``(reuse_from, new_positions)`` of a cached call on a window of
        ``total_frames``: the slots of the previous call's cache whose frames
        were selected again (each selected frame index p with p + n_shift
        selected last time), and the window positions to encode anew. With
        no cache, or nothing to reuse, every selected frame is new."""
        idx = [int(i) for i in select_frame_indices(total_frames, self.mar_cfg.n_frames)]
        reuse_from = [idx.index(p + n_shift) for p in idx if (p + n_shift) in idx]
        if cache is None or not reuse_from:
            return [], idx
        return reuse_from, idx[len(reuse_from):]

    def predict_action_cached(
        self,
        obs_dict: Mapping[str, Any],
        cache: Optional[torch.Tensor] = None,
        n_shift: int = 8,
        noise: Optional[Mapping[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        language_goal: Any = None,
    ) -> Tuple[Dict[str, np.ndarray], torch.Tensor]:
        """Rollout serving with latent reuse (``policy.py:481-509``): the
        action of :meth:`predict_action_cached_async` copied to the host.

        Returns ``({"action": (B, n_action_steps, A), "action_pred": (B, 16, A)}``
        as numpy arrays, ``new cache``); the cache stays on the device.
        """
        nact, cond = self.predict_action_cached_async(obs_dict, cache, n_shift, noise, generator,
                                                      language_goal)
        action_pred = nact.cpu().numpy()
        return {"action": action_pred[:, : self.n_action_steps], "action_pred": action_pred}, cond

    @torch.no_grad()
    def predict_action_cached_async(
        self,
        obs_dict: Mapping[str, Any],
        cache: Optional[torch.Tensor] = None,
        n_shift: int = 8,
        noise: Optional[Mapping[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        language_goal: Any = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dispatch half of :meth:`predict_action_cached`
        (``policy.py:511-572``).

        ``obs_dict["image"]``: the observation window, (B, T, 3, H, W) uint8 or
        float in [0, 1], on the host, beside the state keys and
        ``past_action`` the config reads. ``cache``: the previous call's
        conditioning latents (B, 4, C, h, w) on the device; ``n_shift``: the
        env steps between the two calls. Only the frames that the previous
        call did not encode are encoded (packed to YUV420 on the host first
        under ``obs_codec="yuv420"``); ``noise["vae"]`` covers those frames
        only (``noise_shapes(B, n_new)``, ``n_new`` from :meth:`cache_plan`).
        A second camera is encoded anew at every selected frame.
        ``language_goal`` as :meth:`predict_action` takes it.

        Returns ``(action_pred, new cache)`` on the device without waiting
        for them: the (B, 16, A) unnormalized actions and the (B, 4, C, h, w)
        latents.
        """
        obs = image_util.remap_image_keys(self.task_name, dict(obs_dict))
        image = np.asarray(obs["image"])
        if image.dtype != np.uint8 and image.max() <= 1.0 + 1e-6:
            image = np.round(image * 255.0).astype(np.uint8)
        B = image.shape[0]
        reuse_from, new_positions = self.cache_plan(image.shape[1], cache, n_shift)
        if reuse_from:
            c = self.mar_cfg
            want = (B, c.n_frames, c.vae_embed_dim, c.seq_hw, c.seq_hw)
            if tuple(cache.shape) != want:
                raise ValueError(f"cache must be {want}, got {tuple(cache.shape)}")
        new = image[:, new_positions]
        if self.obs_codec == "yuv420":
            new = obs_codec_util.encode_yuv420(new)
        text_latents = self._encode_language_goal(language_goal, B)
        idx = select_frame_indices(image.shape[1], self.mar_cfg.n_frames)
        history, proprio = self._history_actions(obs), self._build_proprio_eval(obs, idx)
        noise = self._noise(B, len(new_positions), noise, generator)
        frames = self._prep_frames(torch.from_numpy(np.ascontiguousarray(new)).to(self.device))
        new_lat = self._encode_frames(frames, noise["vae"])
        cond = torch.cat([cache[:, reuse_from], new_lat], dim=1) if reuse_from else new_lat
        proprio, history = self._prep_modalities(proprio, history, noise)
        return self._sample(cond, noise, text_latents, history, proprio), cond
