"""Frame preprocessing (port of ``utils/image.py``: the per-task camera-key
remap and ``main_image_key`` at :25-54, ``resize_video`` and ``to_model_range`` at :57-72, and for
training ``aug_margins``, ``augment_video`` and ``to_unit_float`` at
:75-133)."""

from __future__ import annotations

from typing import Dict, Tuple

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


def main_image_key(task_name: str, obs: Dict) -> str:
    """The raw obs key that :func:`remap_image_keys` would rename to
    ``image`` (host code gathers frames before the remap), else ``image``."""
    for task, m in TASK_IMAGE_KEYS.items():
        if task in task_name:
            for src, dst in m.items():
                if dst == "image" and src in obs:
                    return src
    return "image"


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


# train-aug crop fraction (reference pusht_image_dataset.py:93-130), shared by
# the host's draw of the crop corners and the crop itself
AUG_CROP_FRAC = 0.95


def aug_margins(H: int, W: int, crop_frac: float = AUG_CROP_FRAC) -> Tuple[int, int]:
    """Exclusive upper bounds of the (top, left) crop corners that
    :func:`augment_video`'s crop size allows."""
    return H - int(round(H * crop_frac)) + 1, W - int(round(W * crop_frac)) + 1


def _blur_taps(x: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    """5-tap filter along ``dim`` (3 or 4) of (B, T, C, H, W) with per-sample
    taps ``k`` (B, 5), reflect-101 borders."""
    B, T, C, H, W = x.shape
    pad = (0, 0, 2, 2) if dim == 3 else (2, 2, 0, 0)
    p = F.pad(x.reshape(B * T, C, H, W), pad, mode="reflect").reshape(
        B, T, C, H + 4 * (dim == 3), W + 4 * (dim == 4))
    n = x.shape[dim]
    kb = k[:, :, None, None, None, None]
    out = 0
    for i in range(5):
        out = out + kb[:, i] * p.narrow(dim, i, n)
    return out


def augment_video(x: torch.Tensor, top: torch.Tensor, left: torch.Tensor, sigma: torch.Tensor,
                  crop_frac: float = AUG_CROP_FRAC) -> torch.Tensor:
    """The video-consistent train augmentation on the device (the reference's
    cv2 crop and blur per clip, pusht_image_dataset.py:93-130): x (B, T, C,
    H, W) float in [0, 1]; top, left (B,) int crop corners and sigma (B,)
    blur widths, one per clip. A crop of ``crop_frac`` of the frame, a
    bilinear resize back without antialiasing, then a 5-tap separable
    gaussian of width sigma (cv2's getGaussianKernel formula) with
    reflect-101 borders."""
    B, T, C, H, W = x.shape
    ch, cw = int(round(H * crop_frac)), int(round(W * crop_frac))
    rows = top.long()[:, None] + torch.arange(ch, device=x.device)  # (B, ch)
    cols = left.long()[:, None] + torch.arange(cw, device=x.device)  # (B, cw)
    crops = x.gather(3, rows[:, None, None, :, None].expand(B, T, C, ch, W))
    crops = crops.gather(4, cols[:, None, None, None, :].expand(B, T, C, ch, cw))
    r = F.interpolate(crops.reshape(B * T, C, ch, cw), size=(H, W), mode="bilinear",
                      align_corners=False, antialias=False).reshape(B, T, C, H, W)
    xs = torch.arange(-2.0, 3.0, dtype=r.dtype, device=r.device)
    k = torch.exp(-(xs[None, :] ** 2) / (2.0 * sigma.to(r.dtype)[:, None] ** 2))
    k = k / k.sum(-1, keepdim=True)
    return _blur_taps(_blur_taps(r, k, 3), k, 4)


def to_unit_float(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 frames -> [0, 1] floats; float frames pass through."""
    if x.dtype == torch.uint8:
        return x.to(dtype) / 255.0
    return x
