"""UnifiedVideoActionPolicy for serving (port of ``policy/policy.py:353-450``:
``_prep_frames``, ``_encode_frames``, ``sample_policy`` and the unnormalize
step).

``predict_action`` takes the conditioning frames the policy attends to,
uint8 (B, 4, 3, H, W), and returns a (B, 16, action_dim) action chunk:
resize and map to [-1, 1], VAE-encode and sample the posterior, scale the
latents by ``LATENT_SCALE``, one MAR encoder+decoder pass, the action
head's diffusion sampler, then unnormalize. Its randomness is either drawn
from a ``torch.Generator`` or injected as a dict of tensors
(:meth:`UnifiedVideoActionPolicy.sample_noise` says which).

The constructor takes the JAX policy's keyword arguments (the
``model.policy`` section of a run config) so one config drives both.
``predict_action_cached``, ``serving_quant``, ``obs_codec``, language goals,
proprioception and training wait for later slices and are refused.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Optional, Union

import torch

from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer, NormalizerField
from unified_video_action_tpu_torch.models.mar import MODEL_SIZES, Mar, MarConfig
from unified_video_action_tpu_torch.models.transformer import set_attn_impl
from unified_video_action_tpu_torch.models.vae import LATENT_SCALE, KLVae, sample_posterior
from unified_video_action_tpu_torch.utils import image as image_util
from unified_video_action_tpu_torch.utils.device import resolve_device

# Keys of the JAX policy's config that only training reads.
_TRAINING_KEYS = {
    "selected_training_mode", "task_modes", "optimizer", "action_mask_ratio",
    "shift_action",
}
# Serving options of the JAX policy that the port ignores: it always runs
# attention through its CUDA kernel (``set_attn_impl`` switches a model to the
# plain version), whatever the JAX program chose ("xla", "pallas", "ring").
_IGNORED_KEYS = {"attn_impl"}
# Serving options of the JAX policy that this slice does not port: each must
# be unset (None, False, "", "none" or "raw").
_UNPORTED_KEYS = {
    "use_history_action", "use_proprioception", "different_history_freq",
    "predict_wrist_img", "predict_proprioception", "language_emb_model",
    "serving_quant", "obs_codec", "vae_encode_chunk",
}
# Subtrees of the JAX parameter trees that no ported module holds yet.
MAR_SKIP = (("diffloss",),)          # video head: not on the policy path
VAE_SKIP = (("decoder",), ("post_quant_conv",))  # decode half of the VAE

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
        device: Union[str, torch.device] = "cuda",
        **kwargs: Any,
    ):
        for key, value in kwargs.items():
            if key in _TRAINING_KEYS or key in _IGNORED_KEYS:
                continue
            if key in _UNPORTED_KEYS:
                if value not in (None, False, "", "none", "raw"):
                    raise NotImplementedError(f"{key}={value!r} is not ported yet")
                continue
            raise TypeError(f"unknown policy option {key!r}")
        if "pusht" not in task_name:
            raise NotImplementedError(f"task {task_name!r} is not ported yet; only pusht")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        amp = autoregressive_model_params
        if not _get(action_model_params, "predict_action", False):
            raise ValueError("serving needs the action head (action_model_params.predict_action)")

        self.device = resolve_device(device)
        self.dtype = _DTYPES[compute_dtype]
        self.task_name = task_name
        self.n_action_steps = n_action_steps
        self.normalizer_type = normalizer_type
        self.action_dim = int(_get(_get(shape_meta, "action"), "shape", [2])[0])
        self.temperature = float(_get(amp, "temperature", 1.0))

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
        self.mar_cfg = MarConfig(
            img_size=int(_get(amp, "img_size", 256)),
            vae_stride=int(_get(amp, "vae_stride", 16)),
            patch_size=int(_get(amp, "patch_size", 1)),
            vae_embed_dim=int(_get(amp, "vae_embed_dim", 16)),
            diffloss_act_d=int(_get(amp, "diffloss_act_d", 6)),
            diffloss_act_w=int(_get(amp, "diffloss_act_w", 1024)),
            act_diff_testing_steps=str(_get(amp, "act_diff_testing_steps", "100")),
            act_model_type=_get(action_model_params, "act_model_type", "conv_fc"),
            action_dim=self.action_dim,
            **size_kwargs,
        )
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
        self.mar.to(self.dtype).eval().requires_grad_(False)
        self.vae.to(self.dtype).eval().requires_grad_(False)
        self.normalizer = LinearNormalizer({"action": NormalizerField.identity(self.action_dim)})

    @classmethod
    def from_run_config(cls, meta_path: str, **overrides: Any) -> "UnifiedVideoActionPolicy":
        """Build from an exported checkpoint's ``meta.json`` (plain JSON; its
        ``cfg`` is the run config), e.g.
        ``pretrained_models/uva_pusht_small/latest/meta.json``."""
        with open(meta_path) as f:
            cfg = json.load(f)["cfg"]
        kwargs = {k: v for k, v in cfg["model"]["policy"].items() if k != "_target_"}
        kwargs["task_name"] = cfg["task"]["name"]
        kwargs.update(overrides)
        return cls(**kwargs)

    # -- weights ------------------------------------------------------------

    def load_params(self, mar_tree: Mapping, vae_tree: Mapping) -> None:
        """Load the JAX policy's ``{"mar": ..., "vae": ...}`` trees (flax
        layout, numpy leaves) through the weight bridge."""
        convert.load_into(self.mar, mar_tree, skip=MAR_SKIP)
        convert.load_into(self.vae, vae_tree, skip=VAE_SKIP)

    def set_normalizer(self, normalizer: LinearNormalizer) -> None:
        self.normalizer = normalizer

    def set_attn_impl(self, attn_impl: str) -> None:
        """``"kernel"`` or ``"plain"`` for every attention layer of the MAR."""
        set_attn_impl(self.mar, attn_impl)

    # -- serving ------------------------------------------------------------

    def noise_shapes(self, batch: int) -> Dict[str, tuple]:
        c = self.mar_cfg
        n = batch * c.num_action_tokens
        return {
            "vae": (batch * c.n_frames, c.vae_embed_dim, c.seq_hw, c.seq_hw),
            "init": (n, c.action_dim),
            "steps": (self.mar.diffactloss.num_steps, n, c.action_dim),
        }

    def sample_noise(self, batch: int,
                     generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The standard-normal draws of one ``predict_action`` call: the VAE
        posterior noise, the sampler's start and its per-step noise."""
        return {
            k: torch.randn(s, generator=generator, device=self.device, dtype=torch.float32)
            for k, s in self.noise_shapes(batch).items()
        }

    def _prep_frames(self, frames: torch.Tensor) -> torch.Tensor:
        if frames.dtype == torch.uint8:
            frames = frames.float() / 255.0
        frames = image_util.resize_video(frames, self.mar_cfg.img_size)
        return image_util.to_model_range(frames)

    def _encode_frames(self, frames: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """(B, T, 3, H, W) in [-1, 1] -> (B, T, C, h, w) scaled latents."""
        B, T = frames.shape[:2]
        mean, logvar = self.vae.encode(frames.reshape(B * T, *frames.shape[2:]))
        z = sample_posterior(mean, logvar, noise) * LATENT_SCALE
        return z.reshape(B, T, *z.shape[1:])

    @torch.no_grad()
    def predict_action(self, frames: torch.Tensor, generator: Optional[torch.Generator] = None,
                       noise: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """frames: uint8 (B, 4, 3, H, W), or float in [0, 1] -> (B, 16, A)
        unnormalized fp32 action chunk on the policy's device (the first
        ``n_action_steps`` are executed). ``noise`` injects the draws of
        :meth:`sample_noise`; otherwise they come from ``generator``."""
        if frames.dim() != 5 or frames.shape[1] != self.mar_cfg.n_frames:
            raise ValueError(
                f"frames must be (B, {self.mar_cfg.n_frames}, 3, H, W), got {tuple(frames.shape)}"
            )
        B = frames.shape[0]
        frames = frames.to(self.device)
        if noise is None:
            noise = self.sample_noise(B, generator)
        else:
            want = self.noise_shapes(B)
            for k, s in want.items():
                if tuple(noise[k].shape) != s:
                    raise ValueError(f"noise[{k!r}] must be {s}, got {tuple(noise[k].shape)}")
            noise = {k: noise[k].to(self.device, torch.float32) for k in want}
        cond = self._encode_frames(self._prep_frames(frames), noise["vae"])
        nact = self.mar.sample_policy(cond, noise["init"], noise["steps"],
                                      temperature=self.temperature)
        nact = nact[..., : self.action_dim]
        if self.normalizer_type == "all":
            nact = self.normalizer["action"].unnormalize(nact)
        return nact
