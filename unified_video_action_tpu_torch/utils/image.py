"""Frame preprocessing for serving (port of ``utils/image.py:57-72``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_video(x: torch.Tensor, size: int = 256) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, T, C, size, size), bilinear with half-pixel
    centres and no antialiasing (``jax.image.resize(..., "linear",
    antialias=False)``). The identity when the frames already have that size."""
    B, T, C, H, W = x.shape
    if H == size and W == size:
        return x
    flat = x.reshape(B * T, C, H, W)
    out = F.interpolate(
        flat, size=(size, size), mode="bilinear", align_corners=False, antialias=False
    )
    return out.reshape(B, T, C, size, size)


def to_model_range(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] float frames -> [-1, 1] (reference: x·255/127.5 − 1)."""
    return x * (255.0 / 127.5) - 1.0
