"""UnifiedVideoActionPolicy for serving (port of ``policy/policy.py:353-630``:
``_prep_frames``, ``_encode_frames`` (with ``vae_encode_chunk``),
``sample_policy``, the unnormalize step, ``predict_action`` and the
latent-cached ``predict_action_cached``, each with its ``*_async`` half).

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

Tasks: PushT and the language-conditioned kitchen suite
(``language_emb_model="clip"``: every entry point takes ``language_goal``, a
string, a list of strings or precomputed (B or 1, 512) latents, encoded by
``text_encoder``, which is ``utils.language.HashTextEncoder`` until the CLIP
tower is ported). Other tasks, proprioception and training wait for later
slices and are refused.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer, NormalizerField
from unified_video_action_tpu_torch.models.mar import MODEL_SIZES, Mar, MarConfig
from unified_video_action_tpu_torch.models.transformer import set_attn_impl, set_int8_impl
from unified_video_action_tpu_torch.models.vae import LATENT_SCALE, KLVae, sample_posterior
from unified_video_action_tpu_torch.utils import image as image_util
from unified_video_action_tpu_torch.utils import obs_codec as obs_codec_util
from unified_video_action_tpu_torch.utils.frames import select_frame_indices
from unified_video_action_tpu_torch.utils.device import resolve_device
from unified_video_action_tpu_torch.utils.language import get_text_encoder

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
    "predict_wrist_img", "predict_proprioception",
}
# the tasks whose serving path is ported (a task matches if its name holds one)
_PORTED_TASKS = ("pusht", "kitchen")
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
        serving_quant: Optional[str] = None,
        obs_codec: Optional[str] = None,
        vae_encode_chunk: Optional[int] = None,
        language_emb_model: Optional[str] = None,
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
        if not any(t in task_name for t in _PORTED_TASKS):
            raise NotImplementedError(f"task {task_name!r} is not ported yet; only {_PORTED_TASKS}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        if serving_quant not in (None, "", "none", "int8"):
            raise ValueError(f"serving_quant must be None or 'int8', got {serving_quant!r}")
        if obs_codec not in (None, "", "none", "raw", "yuv420"):
            raise ValueError(f"obs_codec must be None or 'yuv420', got {obs_codec!r}")
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
        self.serving_quant = serving_quant if serving_quant == "int8" else None
        self.obs_codec = obs_codec if obs_codec == "yuv420" else None
        self.vae_encode_chunk = int(vae_encode_chunk or 0)
        self.language_emb_model = language_emb_model
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
            language_emb_model=language_emb_model,
            quant=self.serving_quant == "int8",
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
        their fp32 values, whatever the compute dtype."""
        convert.load_into(self.mar, mar_tree, skip=MAR_SKIP)
        convert.load_into(self.vae, vae_tree, skip=VAE_SKIP)

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

    def noise_shapes(self, batch: int, n_new: Optional[int] = None) -> Dict[str, tuple]:
        """Shapes of one call's draws; ``n_new`` is the number of frames the
        call VAE-encodes (all ``n_frames`` unless a cached call reuses some)."""
        c = self.mar_cfg
        n = batch * c.num_action_tokens
        n_new = c.n_frames if n_new is None else n_new
        return {
            "vae": (batch * n_new, c.vae_embed_dim, c.seq_hw, c.seq_hw),
            "init": (n, c.action_dim),
            "steps": (self.mar.diffactloss.num_steps, n, c.action_dim),
        }

    def sample_noise(self, batch: int, generator: Optional[torch.Generator] = None,
                     n_new: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The standard-normal draws of one call: the VAE posterior noise,
        the sampler's start and its per-step noise."""
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
        if self.obs_codec == "yuv420":
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

    def _encode_language_goal(self, language_goal: Any, batch: int) -> Optional[torch.Tensor]:
        """JAX's ``_encode_language_goal`` (``policy.py:632-650``): None without
        language or without a goal; a string or a list of strings is encoded
        by ``text_encoder``, an array passes through as precomputed latents,
        and one goal is tiled over the batch. Returns (B, 512) fp32 on the
        policy's device."""
        if self.language_emb_model is None or language_goal is None:
            return None
        if isinstance(language_goal, (np.ndarray, torch.Tensor)):
            lat = torch.as_tensor(language_goal)
        else:
            lat = torch.from_numpy(self.text_encoder.encode(language_goal))
        if lat.dim() == 2 and lat.shape[0] == 1 and batch > 1:
            lat = lat.expand(batch, *lat.shape[1:])
        return lat.to(self.device, torch.float32)

    def _sample(self, cond: torch.Tensor, noise: Mapping[str, torch.Tensor],
                text_latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, C, h, w) conditioning latents -> (B, 16, A) unnormalized actions."""
        nact = self.mar.sample_policy(cond, noise["init"], noise["steps"],
                                      temperature=self.temperature, text_latents=text_latents)
        nact = nact[..., : self.action_dim]
        if self.normalizer_type == "all":
            nact = self.normalizer["action"].unnormalize(nact)
        return nact

    def predict_action(self, obs_dict: Mapping[str, Any], generator: Optional[torch.Generator] = None,
                       noise: Optional[Mapping[str, torch.Tensor]] = None,
                       language_goal: Any = None) -> Dict[str, np.ndarray]:
        """JAX's ``predict_action`` (``policy.py:574-590``): ``obs_dict["image"]``
        (or the task's camera key, e.g. the kitchen's ``agentview_rgb``) is
        the observation window on the host, (B, T, 3, H, W) uint8 or float in
        [0, 1]; ``language_goal`` as :meth:`_encode_language_goal` takes it.
        Returns numpy ``{"action": (B, n_action_steps, A), "action_pred":
        (B, 16, A)}``, unnormalized fp32: the action of
        :meth:`predict_action_async`, copied to the host."""
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
        to YUV420 there; the goal is encoded on the host; one copy to the
        device, then :meth:`predict_action_frames`. Returns the (B, 16, A)
        unnormalized action tensor on the policy's device, without waiting
        for it."""
        obs = image_util.remap_image_keys(self.task_name, dict(obs_dict))
        image = np.asarray(obs["image"])
        sel = image[:, select_frame_indices(image.shape[1], self.mar_cfg.n_frames)]
        if sel.dtype != np.uint8 and sel.max() <= 1.0 + 1e-6:
            sel = np.round(sel * 255.0).astype(np.uint8)
        if self.obs_codec == "yuv420":
            sel = obs_codec_util.encode_yuv420(sel)
        frames = torch.from_numpy(np.ascontiguousarray(sel))
        text_latents = self._encode_language_goal(language_goal, image.shape[0])
        return self.predict_action_frames(frames, generator, noise, text_latents)

    @torch.no_grad()
    def predict_action_frames(self, frames: torch.Tensor, generator: Optional[torch.Generator] = None,
                              noise: Optional[Mapping[str, torch.Tensor]] = None,
                              text_latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The counterpart of JAX's jitted predict program (``policy.py:436-451``,
        ``_build_predict_fn``), which :meth:`predict_action` runs on the frames
        it selected: frames as the device receives them, uint8 (B, 4, 3, H, W)
        or float in [0, 1], and under ``obs_codec="yuv420"`` only packed uint8
        (B, 4, P) (a 5-D tensor is refused: it would skip the codec) -> (B, 16,
        A) unnormalized fp32 action chunk on the policy's device (the first
        ``n_action_steps`` are executed). ``noise`` injects the draws of
        :meth:`sample_noise`; otherwise they come from ``generator``.
        ``text_latents``: the encoded goal (B, 512), or None."""
        n = self.mar_cfg.n_frames
        want = f"packed (B, {n}, P)" if self.obs_codec == "yuv420" else f"(B, {n}, 3, H, W)"
        if frames.dim() != (3 if self.obs_codec == "yuv420" else 5) or frames.shape[1] != n:
            raise ValueError(f"frames must be {want}, got {tuple(frames.shape)}")
        B = frames.shape[0]
        noise = self._noise(B, n, noise, generator)
        cond = self._encode_frames(self._prep_frames(frames.to(self.device)), noise["vae"])
        return self._sample(cond, noise, text_latents)

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
        float in [0, 1], on the host. ``cache``: the previous call's
        conditioning latents (B, 4, C, h, w) on the device; ``n_shift``: the
        env steps between the two calls. Only the frames that the previous
        call did not encode are encoded (packed to YUV420 on the host first
        under ``obs_codec="yuv420"``); ``noise["vae"]`` covers those frames
        only (``noise_shapes(B, n_new)``, ``n_new`` from :meth:`cache_plan`).
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
        noise = self._noise(B, len(new_positions), noise, generator)
        frames = self._prep_frames(torch.from_numpy(np.ascontiguousarray(new)).to(self.device))
        new_lat = self._encode_frames(frames, noise["vae"])
        cond = torch.cat([cache[:, reuse_from], new_lat], dim=1) if reuse_from else new_lat
        return self._sample(cond, noise, text_latents), cond
