"""Per-token AdaLN MLP denoiser (port of ``models/denoiser.py:24-189``).

The diffusion heads call it once per sampler step on every token: x (N, C),
the original timestep t (N,) and the conditioning c (N, z). It returns fp32
(N, out_channels), epsilon ‖ the learned-range variance coefficient.
Submodules carry the flax names so ``convert.py`` maps them by name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


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


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale) + shift


class TimestepEmbed(nn.Module):
    def __init__(self, hidden: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.fc1 = nn.Linear(freq_dim, hidden)
        self.fc2 = nn.Linear(hidden, hidden)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.freq_dim).to(self.fc1.weight.dtype)
        return self.fc2(F.silu(self.fc1(emb)))


class AdaLNResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.ada_mod = nn.Linear(channels, 3 * channels)
        self.ln = nn.LayerNorm(channels, eps=1e-6)
        self.fc1 = nn.Linear(channels, channels)
        self.fc2 = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift, scale, gate = self.ada_mod(F.silu(y)).chunk(3, dim=-1)
        h = _modulate(self.ln(x), shift, scale)
        h = self.fc2(F.silu(self.fc1(h)))
        return x + gate * h


class AdaLNFinal(nn.Module):
    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.ada_mod = nn.Linear(channels, 2 * channels)
        self.ln = nn.LayerNorm(channels, eps=1e-6, elementwise_affine=False)
        self.proj = nn.Linear(channels, out_channels)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift, scale = self.ada_mod(F.silu(y)).chunk(2, dim=-1)
        return self.proj(_modulate(self.ln(x), shift, scale))


class MlpDenoiser(nn.Module):
    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 z_channels: int, depth: int):
        super().__init__()
        self.depth = depth
        self.input_proj = nn.Linear(in_channels, model_channels)
        self.time_embed = TimestepEmbed(model_channels)
        self.cond_embed = nn.Linear(z_channels, model_channels)
        for i in range(depth):
            self.add_module(f"block_{i}", AdaLNResBlock(model_channels))
        self.final = AdaLNFinal(model_channels, out_channels)

    def forward(self, x: torch.Tensor, t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """x: (N, in_channels); t: (N,) original timesteps; c: (N, z_channels)."""
        dtype = self.input_proj.weight.dtype
        h = self.input_proj(x.to(dtype))
        y = self.time_embed(t) + self.cond_embed(c.to(dtype))
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, y)
        return self.final(h, y).float()
