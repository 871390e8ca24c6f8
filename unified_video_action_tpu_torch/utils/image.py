"""Frame preprocessing for serving (port of ``utils/image.py``: the
per-task camera-key remap at :25-43, ``resize_video`` and
``to_model_range`` at :57-72)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

# per-task main/wrist camera key remaps (reference data_utils.py:19-125)
TASK_IMAGE_KEYS = {
    "libero": {"agentview_rgb": "image", "agentview_image": "image"},
    "kitchen": {"agentview_rgb": "image", "agentview_image": "image"},
    "umi": {"camera0_rgb": "image"},
    "toolhang": {
        "sideview_image": "image",
        "robot0_eye_in_hand_image": "wrist_image",
    },
}


def remap_image_keys(task_name: str, obs: Dict) -> Dict:
    """A copy of ``obs`` with the task's camera keys renamed to ``image`` and
    ``wrist_image`` (the first task whose name is in ``task_name`` wins)."""
    mapping = {}
    for task, m in TASK_IMAGE_KEYS.items():
        if task in task_name:
            mapping = m
            break
    out = dict(obs)
    for src, dst in mapping.items():
        if src in out:
            out[dst] = out.pop(src)
    return out


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
