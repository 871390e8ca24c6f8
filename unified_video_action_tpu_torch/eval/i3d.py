"""InceptionI3d video embedder for FVD (port of ``eval/i3d.py``: ``Unit3D``
(:28), ``InceptionBlock`` (:54), ``InceptionI3d`` (:73) and
``load_i3d_embedder`` (:156)).

The modules carry the names of the reference's ``pytorch_i3d`` state dict
(fvd/pytorch_i3d.py): ``<Block>.<unit>.conv3d.weight``, ``.bn.{weight, bias,
running_mean, running_var}``, branches ``b0``, ``b1a``, ``b1b``, ``b2a``,
``b2b``, ``b3b`` inside the ``Mixed_*`` blocks, and ``logits.conv3d.{weight,
bias}``; so the Kinetics-400 weights file ``i3d_pretrained_400.pt`` loads as
it is. Convolutions and max pools pad as TensorFlow's ``SAME`` does (flax's
``padding="SAME"``: the odd cell at the end), max pools with -inf; every
BatchNorm runs on its running statistics with eps 1e-3.

The weights are not in the repository: ``load_i3d_embedder`` raises
``FileNotFoundError`` without them, and ``eval.metrics.get_video_embedder``
then falls back to pixel statistics. Frames are resized to 224 x 224 as
``jax.image.resize(..., "linear")`` resizes them (a triangle kernel at
half-pixel centres, widened by the scale when it shrinks the frame: the
antialiasing of ``jax.image.scale_and_translate``); T stays as it is.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_WEIGHTS = "pretrained_models/i3d_pretrained_400.pt"
INPUT_SIZE = 224


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of TensorFlow's SAME along one axis."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
              value: float = 0.0) -> torch.Tensor:
    """Pad (B, C, T, H, W) for a SAME window of ``kernel`` and ``stride``."""
    pads = []
    for axis in (4, 3, 2):  # F.pad takes the last axis first
        pads += _same_pads(x.shape[axis], kernel[axis - 2], stride[axis - 2])
    return F.pad(x, pads, value=value)


def max_pool_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]) -> torch.Tensor:
    return F.max_pool3d(_pad_same(x, kernel, stride, float("-inf")), kernel, stride)


class Unit3D(nn.Module):
    """A SAME 3-D convolution, BatchNorm (eps 1e-3) and ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), use_bn: bool = True, activation: bool = True):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv3d = nn.Conv3d(in_channels, out_channels, self.kernel, self.stride, bias=not use_bn)
        self.bn = nn.BatchNorm3d(out_channels, eps=1e-3) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(_pad_same(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionBlock(nn.Module):
    """Four branches concatenated over channels: 1x1x1; 1x1x1 then 3x3x3
    (twice); a SAME 3x3x3 max pool then 1x1x1. ``channels``: (b0, b1a, b1b,
    b2a, b2b, b3b)."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        c = channels
        self.b0 = Unit3D(in_channels, c[0])
        self.b1a = Unit3D(in_channels, c[1])
        self.b1b = Unit3D(c[1], c[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, c[3])
        self.b2b = Unit3D(c[3], c[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, c[5])
        self.out_channels = c[0] + c[2] + c[4] + c[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], dim=1)


# (name, channels) of the inception blocks, with the max pool before a name
_BLOCKS = (("Mixed_3b", (64, 96, 128, 16, 32, 32)), ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
           ("Mixed_4b", (192, 96, 208, 16, 48, 64)), ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
           ("Mixed_4d", (128, 128, 256, 24, 64, 64)), ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
           ("Mixed_4f", (256, 160, 320, 32, 128, 128)), ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
           ("Mixed_5c", (384, 192, 384, 48, 128, 128)))
_POOL_BEFORE = {"Mixed_3b": ((1, 3, 3), (1, 2, 2)), "Mixed_4b": ((3, 3, 3), (2, 2, 2)),
                "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class InceptionI3d(nn.Module):
    """(B, 3, T, H, W) frames in [-1, 1] -> (B, num_classes) logits."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        c = 192
        for name, channels in _BLOCKS:
            block = InceptionBlock(c, channels)
            self.add_module(name, block)
            c = block.out_channels
        self.logits = Unit3D(c, num_classes, use_bn=False, activation=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        for name, _ in _BLOCKS:
            if name in _POOL_BEFORE:
                x = max_pool_same(x, *_POOL_BEFORE[name])
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3, 4), keepdim=True)
        return self.logits(x)[:, :, 0, 0, 0]


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 weights of ``jax.image.resize``'s
    "linear" method along one axis (``compute_weight_mat`` of
    ``jax.image.scale_and_translate``, antialiased)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(inv_scale) - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).T.astype(np.float32)


def resize_frames(v: torch.Tensor, size: int = INPUT_SIZE) -> torch.Tensor:
    """(B, T, H, W, C) float -> (B, T, size, size, C) by :func:`resize_weights`."""
    H, W = v.shape[2:4]
    wh, ww = (torch.as_tensor(resize_weights(n, size), device=v.device) for n in (H, W))
    return torch.einsum("ih,bthwc,jw->btijc", wh, v, ww)


def load_i3d_embedder(weights_path: str = None, batch: int = 16,
                      device: str = "cuda") -> Callable[[np.ndarray], np.ndarray]:
    """(B, T, H, W, 3) uint8 or float videos -> (B, 400) logits on the host,
    the I3D of ``weights_path`` (default ``$I3D_WEIGHTS`` or
    ``pretrained_models/i3d_pretrained_400.pt``, a torch state dict of the
    reference's layout) on ``device``, ``batch`` videos a call. Frames above
    1.5 are taken for [0, 255]; they are resized to 224 and mapped to
    [-1, 1] (fvd/fvd.py:7-50)."""
    path = weights_path or os.environ.get("I3D_WEIGHTS", DEFAULT_WEIGHTS)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model = InceptionI3d()
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"{path}: not the reference I3D's state dict (missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]})")
    model = model.to(device).eval()

    @torch.no_grad()
    def embed(videos: np.ndarray) -> np.ndarray:
        v = torch.as_tensor(np.asarray(videos, np.float32), device=device)
        if v.max() > 1.5:
            v = v / 255.0
        outs = []
        for i in range(0, v.shape[0], batch):
            x = resize_frames(v[i:i + batch]) * 2.0 - 1.0
            outs.append(model(x.permute(0, 4, 1, 2, 3)).cpu().numpy())
        return np.concatenate(outs, axis=0)

    return embed
