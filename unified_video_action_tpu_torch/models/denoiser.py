"""Per-token AdaLN MLP denoiser (port of ``models/denoiser.py:24-189``) and
the classifier-free-guidance wrapper ``cfg_denoise_fn`` (:191-207).

The diffusion heads call it once per sampler step on every token: x (N, C),
the original timestep t (N,) and the conditioning c (N, z). It returns fp32
(N, out_channels), epsilon ‖ the learned-range variance coefficient.
Submodules carry the flax names so ``convert.py`` maps them by name.

With ``quant=True`` the layers that JAX's ``_dense_cls`` reaches
(:65-189) are W8A8 ``QuantLinear``s: each block's ``ada_mod``, ``fc1`` and
``fc2``, the final ``ada_mod``, ``input_proj`` and ``cond_embed``; the
timestep MLP and the final ``proj`` stay float. A ``QuantLinear`` keeps its
input's dtype where flax's ``Dense(dtype=...)`` casts to the compute dtype,
so in the quant denoiser ``input_proj`` turns the fp32 sampler state into an
fp32 residual stream, as in JAX; the LayerNorms then normalize it in fp32
and hand the compute dtype on (flax's ``LayerNorm(dtype=...)``).

The dense layers carry the flax initializers that JAX names (``xavier_uniform``,
``normal(0.02)``, ``zeros``) in ``kernel_init``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from unified_video_action_tpu_torch.models.transformer import QuantLinear, dense


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos ‖ sin] ordering (GLIDE convention)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``ln(x)`` in ``dtype``; an input of another dtype (the quant
    denoiser's fp32 residual stream) is normalized in its own dtype first."""
    if x.dtype == dtype:
        return ln(x)
    w, b = ((None if p is None else p.to(x.dtype)) for p in (ln.weight, ln.bias))
    return F.layer_norm(x, ln.normalized_shape, w, b, ln.eps).to(dtype)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale) + shift


class TimestepEmbed(nn.Module):
    def __init__(self, hidden: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.fc1 = dense(freq_dim, hidden, False, "normal_0.02")
        self.fc2 = dense(hidden, hidden, False, "normal_0.02")

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.freq_dim).to(self.fc1.weight.dtype)
        return self.fc2(F.silu(self.fc1(emb)))


class AdaLNResBlock(nn.Module):
    def __init__(self, channels: int, quant: bool = False):
        super().__init__()
        self.ada_mod = dense(channels, 3 * channels, quant, "zeros")
        self.ln = nn.LayerNorm(channels, eps=1e-6)
        self.fc1 = dense(channels, channels, quant, "xavier_uniform")
        self.fc2 = dense(channels, channels, quant, "xavier_uniform")

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift, scale, gate = self.ada_mod(F.silu(y)).chunk(3, dim=-1)
        h = _modulate(_norm(self.ln, x, y.dtype), shift, scale)
        h = self.fc2(F.silu(self.fc1(h)))
        return x + gate * h


class AdaLNFinal(nn.Module):
    def __init__(self, channels: int, out_channels: int, quant: bool = False):
        super().__init__()
        self.ada_mod = dense(channels, 2 * channels, quant, "zeros")
        self.ln = nn.LayerNorm(channels, eps=1e-6, elementwise_affine=False)
        self.proj = dense(channels, out_channels, False, "zeros")

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift, scale = self.ada_mod(F.silu(y)).chunk(2, dim=-1)
        return self.proj(_modulate(_norm(self.ln, x, y.dtype), shift, scale))


class MlpDenoiser(nn.Module):
    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 z_channels: int, depth: int, quant: bool = False):
        super().__init__()
        self.depth = depth
        self.input_proj = dense(in_channels, model_channels, quant, "xavier_uniform")
        self.time_embed = TimestepEmbed(model_channels)
        self.cond_embed = dense(z_channels, model_channels, quant, "xavier_uniform")
        for i in range(depth):
            self.add_module(f"block_{i}", AdaLNResBlock(model_channels, quant))
        self.final = AdaLNFinal(model_channels, out_channels, quant)

    def forward(self, x: torch.Tensor, t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """x: (N, in_channels); t: (N,) original timesteps; c: (N, z_channels)."""
        dtype = self.time_embed.fc1.weight.dtype
        h = self.input_proj(x if isinstance(self.input_proj, QuantLinear) else x.to(dtype))
        y = self.time_embed(t) + self.cond_embed(c.to(dtype))
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, y)
        return self.final(h, y).float()


def cfg_denoise_fn(apply_fn, cfg_scale: float, in_channels: int):
    """Classifier-free guidance around ``apply_fn(x, t, c)`` (the reference's
    ``forward_with_cfg``, diffusion_loss.py:285-293): the first half of the
    rows is conditional, the second unconditional. Both halves are run on
    the first half's x, and both get the guided epsilon
    ``uncond + cfg_scale·(cond − uncond)``; the learned-variance channels
    after ``in_channels`` pass through per half."""

    def fn(x: torch.Tensor, t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        n = x.shape[0] // 2
        half = x[:n]
        out = apply_fn(torch.cat([half, half], dim=0), t, c)
        eps, rest = out[:, :in_channels], out[:, in_channels:]
        cond_eps, uncond_eps = eps[:n], eps[n:]
        guided = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([guided, guided], dim=0), rest], dim=1)

    return fn
