"""KL-16 VAE encoder (port of ``models/vae.py:32-123`` and ``:157-211``).

The encode path only: ``ResnetBlock``, ``AttnBlock``, ``Downsample``,
``Encoder``, ``KLVae.encode``, ``sample_posterior`` and ``LATENT_SCALE``.
The decoder waits for a later slice; ``convert.py`` is told to leave the
``decoder`` and ``post_quant_conv`` leaves of a JAX tree alone.

The JAX package runs NHWC inside and NCHW at ``encode``; here convolutions
run NCHW throughout and ``encode`` keeps the same (B, 3, H, W) signature.
The layers that flax writes as ``nn.Dense`` over channels (the 1x1 attention
projections, the shortcut, ``quant_conv``) stay ``nn.Linear`` here so their
parameters map one to one. ``AttnBlock`` is a plain matmul attention over
H·W positions, as in the JAX package (it is not a Pallas kernel there).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# The reference scales sampled latents by 0.2325 before the MAR
# (utils/data_utils.py:396).
LATENT_SCALE = 0.2325


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _channels_last_linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A Dense over the channel axis of an NCHW tensor."""
    return layer(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, out_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.shortcut = nn.Linear(in_channels, out_channels) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(_swish(self.norm1(x)))
        h = self.conv2(_swish(self.norm2(h)))
        if self.shortcut is not None:
            x = _channels_last_linear(self.shortcut, x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).flatten(2).transpose(1, 2)  # (B, HW, C)
        q, k, v = self.q(h), self.k(h), self.v(h)
        attn = torch.softmax(torch.bmm(q, k.transpose(1, 2)) * (C ** -0.5), dim=-1)
        h = self.proj_out(torch.bmm(attn, v))
        return x + h.transpose(1, 2).reshape(B, C, H, W)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the reference pads (0, 1, 0, 1) asymmetrically, then a VALID stride-2 conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 resolution: int = 256, z_channels: int = 16, double_z: bool = True):
        super().__init__()
        self.conv_in = nn.Conv2d(3, ch, 3, padding=1)
        self.order = []  # child names in call order
        curr_res, c_in = resolution, ch
        for i, mult in enumerate(ch_mult):
            for j in range(num_res_blocks):
                self._add(f"down_{i}_block_{j}", ResnetBlock(c_in, ch * mult))
                c_in = ch * mult
                if curr_res in attn_resolutions:
                    self._add(f"down_{i}_attn_{j}", AttnBlock(c_in))
            if i != len(ch_mult) - 1:
                self._add(f"down_{i}_downsample", Downsample(c_in))
                curr_res //= 2
        self._add("mid_block_1", ResnetBlock(c_in, c_in))
        self._add("mid_attn_1", AttnBlock(c_in))
        self._add("mid_block_2", ResnetBlock(c_in, c_in))
        self.norm_out = nn.GroupNorm(32, c_in, eps=1e-6)
        self.conv_out = nn.Conv2d(c_in, 2 * z_channels if double_z else z_channels, 3, padding=1)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.order.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for name in self.order:
            h = getattr(self, name)(h)
        return self.conv_out(_swish(self.norm_out(h)))


class KLVae(nn.Module):
    """The AutoencoderKL's encode half. ``encode`` maps (B, 3, H, W) frames in
    [-1, 1] to fp32 (mean, logvar), each (B, embed_dim, H/16, W/16)."""

    def __init__(self, embed_dim: int = 16, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 resolution: int = 256, ch: int = 128):
        super().__init__()
        self.encoder = Encoder(ch=ch, ch_mult=ch_mult, z_channels=embed_dim,
                               resolution=resolution)
        self.quant_conv = nn.Linear(2 * embed_dim, 2 * embed_dim)

    def encode(self, x_nchw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x_nchw.to(self.quant_conv.weight.dtype)
        moments = _channels_last_linear(self.quant_conv, self.encoder(x)).float()
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)


def sample_posterior(mean: torch.Tensor, logvar: torch.Tensor,
                     noise: torch.Tensor) -> torch.Tensor:
    """mean + exp(logvar / 2) · noise, with the standard-normal ``noise`` given."""
    return mean + torch.exp(0.5 * logvar) * noise
