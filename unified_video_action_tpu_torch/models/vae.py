"""KL-16 VAE (port of ``models/vae.py``): ``ResnetBlock``, ``AttnBlock``,
``Downsample``, ``Upsample`` (:84-91), ``Encoder``, ``Decoder`` (:125-155),
``KLVae.encode`` and ``KLVae.decode`` (:193-196), ``sample_posterior`` and
``LATENT_SCALE``.

The JAX package runs NHWC inside and NCHW at ``encode`` and ``decode``; here
convolutions run NCHW throughout and both keep the same NCHW signatures.
The layers that flax writes as ``nn.Dense`` over channels (the 1x1 attention
projections, the shortcut, ``quant_conv``, ``post_quant_conv``) stay
``nn.Linear`` here so their parameters map one to one. ``AttnBlock`` is a
plain matmul attention over H·W positions, as in the JAX package (it is not
a Pallas kernel there).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# The reference scales sampled latents by 0.2325 before the MAR and divides
# back before decoding (utils/data_utils.py:396, eval/eval.py:204).
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


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # nearest x2 (jax.image.resize "nearest" at an integer factor repeats each pixel)
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


class _ConvStack(nn.Module):
    """conv_in, the named children in call order, then GroupNorm, swish and
    conv_out: the shape of both the encoder and the decoder."""

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.order.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for name in self.order:
            h = getattr(self, name)(h)
        return self.conv_out(_swish(self.norm_out(h)))


class Encoder(_ConvStack):
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


class Decoder(_ConvStack):
    """conv_in, the mid ResNet, AttnBlock and ResNet, then per level from the
    coarsest ``num_res_blocks + 1`` ResNet blocks (no per-level attention, as
    in the reference) and, after every level but the finest, a nearest x2
    upsample; then GroupNorm, swish and conv_out."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, z_channels: int = 16, out_ch: int = 3):
        super().__init__()
        c_in = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_channels, c_in, 3, padding=1)
        self.order = []  # child names in call order
        self._add("mid_block_1", ResnetBlock(c_in, c_in))
        self._add("mid_attn_1", AttnBlock(c_in))
        self._add("mid_block_2", ResnetBlock(c_in, c_in))
        for i in reversed(range(len(ch_mult))):
            for j in range(num_res_blocks + 1):
                self._add(f"up_{i}_block_{j}", ResnetBlock(c_in, ch * ch_mult[i]))
                c_in = ch * ch_mult[i]
            if i != 0:
                self._add(f"up_{i}_upsample", Upsample(c_in))
        self.norm_out = nn.GroupNorm(32, c_in, eps=1e-6)
        self.conv_out = nn.Conv2d(c_in, out_ch, 3, padding=1)


class KLVae(nn.Module):
    """The AutoencoderKL. ``encode`` maps (B, 3, H, W) frames in [-1, 1] to
    fp32 (mean, logvar), each (B, embed_dim, H/16, W/16); ``decode`` maps
    (B, embed_dim, h, w) latents back to fp32 frames, one x2 per level of
    ``ch_mult`` after the first: (B, 3, 16h, 16w) at the default's five."""

    def __init__(self, embed_dim: int = 16, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 resolution: int = 256, ch: int = 128):
        super().__init__()
        self.encoder = Encoder(ch=ch, ch_mult=ch_mult, z_channels=embed_dim,
                               resolution=resolution)
        self.decoder = Decoder(ch=ch, ch_mult=ch_mult, z_channels=embed_dim)
        self.quant_conv = nn.Linear(2 * embed_dim, 2 * embed_dim)
        self.post_quant_conv = nn.Linear(embed_dim, embed_dim)

    def encode(self, x_nchw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x_nchw.to(self.quant_conv.weight.dtype)
        moments = _channels_last_linear(self.quant_conv, self.encoder(x)).float()
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z_nchw: torch.Tensor) -> torch.Tensor:
        z = z_nchw.to(self.post_quant_conv.weight.dtype)
        return self.decoder(_channels_last_linear(self.post_quant_conv, z)).float()


def sample_posterior(mean: torch.Tensor, logvar: torch.Tensor,
                     noise: torch.Tensor) -> torch.Tensor:
    """mean + exp(logvar / 2) · noise, with the standard-normal ``noise`` given."""
    return mean + torch.exp(0.5 * logvar) * noise
