"""Diffusion heads (port of ``models/heads.py``: ``VideoDiffusionHead``'s
training loss and sampler at :31-93, ``_adaptive_pool_matrix`` and
``ConvFcPool`` at :96-148, the other three pools ``ConvOriPool``,
``Conv2Pool`` and ``Fc2Pool`` at :151-208, ``ActionDiffusionHead`` at
:211-298).

``ConvFcPool`` pools the decoder's (B, T·S, D) tokens into 16 action-slot
latents: a per-frame 3x3 conv, an adaptive average pool to 4x4 with torch's
(overlapping) window semantics, an MLP, a linear frame-to-slot
interpolation and a refining MLP. The head then samples one action per slot
with the per-token ``MlpDenoiser`` under the respaced diffusion, from
injected noise. Each head's ``loss`` is JAX's ``__call__``: the per-token
training losses of its 1000-step cosine diffusion at given steps ``t`` and
noise, the video head's masked to the predicted tokens. The video head
samples each token under its own respaced diffusion (``num_sampling_steps``)
from injected noise, with ``clip_denoised=False``, and under classifier-free
guidance (``cfg != 1``) through ``cfg_denoise_fn``. Under ``quant`` the
denoisers' dense layers are W8A8; the pool stays float, as in JAX
(``heads.py:137-147``, ``:224-246``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unified_video_action_tpu_torch.models.denoiser import MlpDenoiser, cfg_denoise_fn
from unified_video_action_tpu_torch.models.diffusion import create_diffusion


def _adaptive_pool_matrix(W: int, out: int) -> np.ndarray:
    """(out, W) row-stochastic matrix of torch AdaptiveAvgPool1d windows:
    window i spans [floor(i·W/out), ceil((i+1)·W/out))."""
    P = np.zeros((out, W), np.float32)
    for i in range(out):
        a = (i * W) // out
        b = -(-((i + 1) * W) // out)
        P[i, a:b] = 1.0 / (b - a)
    return P


class ConvFcPool(nn.Module):
    """(B, T·S, D) decoder tokens -> (B, num_actions, D) action-slot latents."""

    def __init__(self, z_channels: int, n_frames: int = 4, num_actions: int = 16):
        super().__init__()
        D = z_channels
        self.n_frames = n_frames
        self.conv = nn.Conv2d(D, D, 3, padding=1)
        self.fc1 = nn.Linear(D * 16, D)
        self.fc2 = nn.Linear(D, D)
        self.interpolate = nn.Linear(n_frames, num_actions)
        self.refine1 = nn.Linear(D, D)
        self.refine2 = nn.Linear(D, D)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        B, TS, D = z.shape
        T = self.n_frames
        S = TS // T
        W = int(round(S ** 0.5))
        if W * W != S:
            raise ValueError(f"{TS} tokens over {T} frames is not a square grid per frame")
        z = z.reshape(B * T, W, W, D).permute(0, 3, 1, 2)  # NCHW, spatial (w, h)
        z = F.relu(self.conv(z))
        P = torch.as_tensor(_adaptive_pool_matrix(W, 4), dtype=z.dtype, device=z.device)
        # pooled[b, d, i, j] = sum_wh P[i, w] z[b, d, w, h] P[j, h]; flattened in
        # torch (c, w, h) order as the fc1 weights expect
        z = torch.einsum("iw,bdwh,jh->bdij", P, z, P).reshape(B * T, D * 16)
        z = self.fc2(F.relu(self.fc1(z))).reshape(B, T, D)
        z = self.interpolate(z.transpose(1, 2)).transpose(1, 2)  # (B, num_actions, D)
        return self.refine2(F.relu(self.refine1(z)))


class ConvOriPool(nn.Module):
    """``conv_ori``: a temporal transposed convolution (each frame's tokens
    to 4 slots) and the spatial mean (JAX's ``ConvOriPool``,
    ``heads.py:151-170``). flax's ``ConvTranspose`` does not flip its kernel
    and torch's does: ``convert.py`` reverses the kernel's axes."""

    def __init__(self, z_channels: int, n_frames: int = 4):
        super().__init__()
        self.n_frames = n_frames
        self.conv_transpose3d = nn.ConvTranspose3d(z_channels, z_channels, (4, 1, 1), stride=(4, 1, 1))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        B, TS, D = z.shape
        T = self.n_frames
        W = int(round((TS // T) ** 0.5))
        z = z.reshape(B, T, W, W, D).permute(0, 4, 1, 2, 3)  # (B, D, T, W, W)
        return self.conv_transpose3d(z).mean(dim=(3, 4)).transpose(1, 2)  # (B, 4T, D)


class Conv2Pool(nn.Module):
    """``conv2``: the decoder's tokens as channels of two 1-d convolutions
    along the feature axis, ``n_tokens`` -> 256 -> ``num_actions`` (JAX's
    ``Conv2Pool``, ``heads.py:173-191``, whose flax ``Conv`` runs on (B, D,
    tokens), channels last: torch's ``Conv1d`` on (B, tokens, D) is the
    same)."""

    def __init__(self, n_tokens: int, num_actions: int = 16):
        super().__init__()
        self.conv1 = nn.Conv1d(n_tokens, 256, 7, padding=3)
        self.conv2 = nn.Conv1d(256, num_actions, 7, padding=3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(z)))


class Fc2Pool(nn.Module):
    """``fc2``: a token-mixing MLP, ``n_tokens`` -> 256 -> ``num_actions``
    (JAX's ``Fc2Pool``, ``heads.py:194-208``)."""

    def __init__(self, n_tokens: int, num_actions: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(n_tokens, 256)
        self.fc2 = nn.Linear(256, num_actions)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(z.transpose(1, 2)))).transpose(1, 2)


ACT_MODEL_TYPES = ("conv_fc", "conv_ori", "conv2", "fc2")


class VideoDiffusionHead(nn.Module):
    """DiffLoss equivalent: the per-token denoiser of the frame latents, its
    training diffusion and its sampling diffusion."""

    def __init__(self, target_channels: int, z_channels: int, width: int, depth: int,
                 num_sampling_steps: str = "100", quant: bool = False):
        super().__init__()
        self.target_channels = target_channels
        self.net = MlpDenoiser(
            in_channels=target_channels,
            model_channels=width,
            out_channels=target_channels * 2,
            z_channels=z_channels,
            depth=depth,
            quant=quant,
        )
        self.train_diffusion = create_diffusion("", noise_schedule="cosine")
        self.gen_diffusion = create_diffusion(num_sampling_steps, noise_schedule="cosine")

    @property
    def num_steps(self) -> int:
        return self.gen_diffusion.num_timesteps

    def draw_shapes(self, n: int, cfg: float = 1.0) -> dict:
        """Shapes of :meth:`sample`'s draws for ``n`` rows: the start (for half
        the rows under guidance, which duplicates it) and the per-step noise
        (for all rows: JAX's loop draws ``x.shape`` a step)."""
        C = self.target_channels
        return {"init": (n // 2 if cfg != 1.0 else n, C), "steps": (self.num_steps, n, C)}

    def sample(self, z: torch.Tensor, noise: torch.Tensor, step_noise: torch.Tensor,
               temperature: float = 1.0, cfg: float = 1.0) -> torch.Tensor:
        """z: (N, D) conditioning -> (N, C) sampled tokens, from the
        standard-normal draws of :meth:`draw_shapes`. Under ``cfg != 1`` the
        first N/2 rows of ``z`` are conditional and the rest unconditional;
        both halves start from the same ``noise``."""
        if cfg != 1.0:
            noise = torch.cat([noise, noise], dim=0)
            guided = cfg_denoise_fn(self.net, cfg, self.target_channels)
            denoise = lambda x_t, tt: guided(x_t, tt, z)
        else:
            denoise = lambda x_t, tt: self.net(x_t, tt, z)
        return self.gen_diffusion.p_sample_loop(denoise, noise.float(), step_noise.float(),
                                                clip_denoised=False, temperature=temperature)

    def loss(self, target: torch.Tensor, z: torch.Tensor, mask: torch.Tensor,
             t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Masked-mean diffusion loss. target (B, L, C), z (B, L, D), mask
        (B, L) with 1 on the tokens to predict; t (B·L,) int64 steps in [0,
        1000) and noise (B·L, C)."""
        B, L, C = target.shape
        z = z.reshape(B * L, -1)
        mask = mask.reshape(B * L)
        out = self.train_diffusion.training_losses(
            lambda x_t, tt: self.net(x_t, tt, z), target.reshape(B * L, C), t, noise)
        return (out["loss"] * mask).sum() / mask.sum().clamp(min=1.0)


class ActionDiffusionHead(nn.Module):
    """DiffActLoss equivalent with the pool ``act_model_type`` names
    (``ACT_MODEL_TYPES``; JAX's choice at ``heads.py:222-231``). ``conv2`` and
    ``fc2`` mix the decoder's ``n_tokens`` tokens, a width torch's layers
    take at construction (flax infers it at the first call)."""

    def __init__(self, target_channels: int, z_channels: int, width: int, depth: int,
                 n_frames: int = 4, num_actions: int = 16, act_diff_training_steps: int = 1000,
                 act_diff_testing_steps: str = "100", act_model_type: str = "conv_fc",
                 quant: bool = False, n_tokens: int = 0):
        super().__init__()
        if act_model_type not in ACT_MODEL_TYPES:
            raise NotImplementedError(f"act_model_type {act_model_type!r}: one of {ACT_MODEL_TYPES}")
        self.target_channels = target_channels
        if act_model_type == "conv_fc":
            self.pool = ConvFcPool(z_channels, n_frames=n_frames, num_actions=num_actions)
        elif act_model_type == "conv_ori":
            self.pool = ConvOriPool(z_channels, n_frames=n_frames)
        else:
            pool = Conv2Pool if act_model_type == "conv2" else Fc2Pool
            self.pool = pool(n_tokens, num_actions=num_actions)
        self.net = MlpDenoiser(
            in_channels=target_channels,
            model_channels=width,
            out_channels=target_channels * 2,
            z_channels=z_channels,
            depth=depth,
            quant=quant,
        )
        self.train_diffusion = create_diffusion("", noise_schedule="cosine",
                                                diffusion_steps=act_diff_training_steps)
        self.gen_diffusion = create_diffusion(act_diff_testing_steps, noise_schedule="cosine")

    @property
    def num_steps(self) -> int:
        return self.gen_diffusion.num_timesteps

    def loss(self, target: torch.Tensor, z: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
        """Mean diffusion loss of the action chunk. target (B, num_actions, A),
        z (B, T·S, D) decoder tokens; t (B·num_actions,) int64 steps and noise
        (B·num_actions, A)."""
        B, L, A = target.shape
        pooled = self.pool(z)
        if pooled.shape[1] != L:
            raise ValueError(f"action chunk length {L} != the head's {pooled.shape[1]} slots")
        pooled = pooled.reshape(B * L, -1)
        out = self.train_diffusion.training_losses(
            lambda x_t, tt: self.net(x_t, tt, pooled), target.reshape(B * L, A), t, noise)
        return out["loss"].mean()

    def sample(self, z: torch.Tensor, noise: torch.Tensor, step_noise: torch.Tensor,
               temperature: float = 1.0) -> torch.Tensor:
        """z: (B, T·S, D) -> (B, num_actions, A) action chunk.

        ``noise`` (B·num_actions, A) is the sampler's start and ``step_noise``
        (steps, B·num_actions, A) its per-step draws, both standard normal.
        """
        B = z.shape[0]
        pooled = self.pool(z)
        L = pooled.shape[1]
        cond = pooled.reshape(B * L, -1)
        out = self.gen_diffusion.p_sample_loop(
            lambda x_t, tt: self.net(x_t, tt, cond),
            noise.float(), step_noise.float(),
            clip_denoised=True, temperature=temperature,
        )
        return out.reshape(B, L, self.target_channels)
