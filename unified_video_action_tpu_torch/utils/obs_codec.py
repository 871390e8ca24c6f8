"""Planar YUV 4:2:0 observation codec for serving (the port's own copy of
``utils/obs_codec.py``: ``CODECS``, ``packed_size``, ``hw_from_packed`` and
the numpy ``encode_yuv420`` at :27-78, and ``decode_yuv420`` at :80-105 in
torch).

The client encodes frames on the host in numpy, so that only the packed
planes cross to the card (1.5 bytes a pixel instead of 3); the policy decodes
them on the card with a handful of elementwise ops (nearest-neighbour chroma
upsample, the BT.601 full-range inverse, a clip to [0, 1] in fp32) before the
VAE encode. Lossy only in chroma (2x2 subsampling) and in Y's rounding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

CODECS = ("yuv420",)


def packed_size(h: int, w: int) -> int:
    """Bytes per frame: full-resolution Y plane + 2x2-subsampled U and V planes."""
    if h % 2 or w % 2:
        raise ValueError(f"yuv420 needs even dims, got {h}x{w}")
    return h * w + 2 * (h // 2) * (w // 2)


def hw_from_packed(p: int) -> int:
    """The side of a square frame from its packed length (p = h·h·3/2)."""
    h = int(round((p * 2 / 3) ** 0.5))
    if packed_size(h, h) != p:
        raise ValueError(f"packed length {p} is not a square yuv420 frame")
    return h


def encode_yuv420(rgb: np.ndarray) -> np.ndarray:
    """(..., 3, H, W) uint8 RGB -> (..., packed_size) uint8 planar YUV420,
    BT.601 full range (Y uses the whole 0..255 code range)."""
    if rgb.dtype != np.uint8:
        raise ValueError(f"encode_yuv420 expects uint8, got {rgb.dtype}")
    *lead, c, h, w = rgb.shape
    if c != 3:
        raise ValueError(f"expected channel-first RGB, got shape {rgb.shape}")
    x = rgb.reshape(-1, 3, h, w).astype(np.float32)
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    # 2x2 mean subsample of the chroma planes
    u = u.reshape(-1, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    v = v.reshape(-1, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    n = x.shape[0]
    packed = np.concatenate(
        [
            np.clip(np.rint(y), 0, 255).reshape(n, -1),
            np.clip(np.rint(u), 0, 255).reshape(n, -1),
            np.clip(np.rint(v), 0, 255).reshape(n, -1),
        ],
        axis=1,
    ).astype(np.uint8)
    return packed.reshape(*lead, packed.shape[-1])


def decode_yuv420(packed: torch.Tensor, h: Optional[int] = None,
                  w: Optional[int] = None) -> torch.Tensor:
    """(..., packed_size) uint8 -> (..., 3, H, W) float32 RGB in [0, 1]."""
    p = packed.shape[-1]
    if h is None:
        h = w = hw_from_packed(p)
    elif w is None:
        w = h
    lead = packed.shape[:-1]
    x = packed.reshape(-1, p).float()
    ny = h * w
    nc = (h // 2) * (w // 2)
    y = x[:, :ny].reshape(-1, h, w)
    u = x[:, ny:ny + nc].reshape(-1, h // 2, w // 2) - 128.0
    v = x[:, ny + nc:].reshape(-1, h // 2, w // 2) - 128.0
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    rgb = torch.stack([r, g, b], dim=1)
    return torch.clamp(rgb / 255.0, 0.0, 1.0).reshape(*lead, 3, h, w)
