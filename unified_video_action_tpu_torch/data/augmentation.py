"""Video-consistent image augmentation (the port's own copy of the JAX
package's ``data/augmentation.py``: every transform of ``_REGISTRY`` at
:159-167 and ``VideoTransforms`` at :170-189), on the host.

Equivalent of the reference's kornia ``VideoSequential`` transforms
(base_lazy_dataset.py:365-411; config/task/umi_lazy.yaml: RandomCrop 208 ->
Resize 224 -> ColorJitter -> RandomSharpness -> RandomAutoContrast ->
RandomGrayscale -> GaussianBlur). Each transform takes and returns (T, C,
H, W) float32 in [0, 1] and makes ONE random draw per clip, so every frame
of a video gets the same transform; a ``VideoTransforms`` draws from
``np.random.default_rng((seed, sample_seed))``, the same draws as JAX's.

The JAX package computes the resize, the hue shift and the blurs with
OpenCV and skips the hue shift and both blurs where OpenCV is absent. The
card's machine has no OpenCV, and the port always computes them, here in
numpy, to OpenCV's float32 arithmetic: ``cv2.resize`` with ``INTER_AREA``
(both its area-averaging path and, where one axis grows, its area-mode
linear taps) and ``INTER_LINEAR``, ``cv2.cvtColor`` ``COLOR_RGB2HSV`` /
``COLOR_HSV2RGB`` on float32 (H in degrees; computed with torch's CPU ops,
which release the GIL, so the host loader's threads run them in parallel),
and ``cv2.GaussianBlur`` (the sampled Gaussian kernel,
``BORDER_REFLECT_101``); on uint8, ``cv2.GaussianBlur`` bit for bit
(``gaussian_blur_u8``, OpenCV's fixed-point path, which PushT's host
augmentation takes).
``tests/test_torch_augmentation.py`` holds each against OpenCV.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

_FLT_EPSILON = float(np.finfo(np.float32).eps)
_SIXTH = float(np.float32(6.0 / 360.0))  # OpenCV's hscale for H in degrees, a float


def _to_hwc(v):  # (T, C, H, W) -> (T, H, W, C)
    return np.moveaxis(v, 1, -1)


def _to_chw(v):
    return np.moveaxis(v, -1, 1)


# -- OpenCV's arithmetic, in numpy -------------------------------------------


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) weights of ``cv2.resize``'s INTER_AREA averaging on one
    axis (``computeResizeAreaTab``): each output cell averages the input
    cells it covers, the partial ones by their covered fraction."""
    scale = ssize / dsize
    w = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            w[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def _linear_weights(ssize: int, dsize: int, area_mode: bool) -> np.ndarray:
    """(dsize, ssize) weights of ``cv2.resize``'s two-tap interpolation on
    one axis: INTER_LINEAR's half-pixel centres, or under ``area_mode`` (an
    INTER_AREA resize that grows an axis) OpenCV's area-mode taps; edges
    replicated."""
    inv_scale = dsize / ssize
    scale = 1.0 / inv_scale
    w = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        if area_mode:
            sx = math.floor(dx * scale)
            fx = float(np.float32((dx + 1) - (sx + 1) * inv_scale))
            fx = 0.0 if fx <= 0 else fx - math.floor(fx)
        else:
            fx = float(np.float32((dx + 0.5) * scale - 0.5))
            sx = math.floor(fx)
            fx -= sx
            if sx < 0:
                fx, sx = 0.0, 0
        if sx >= ssize - 1:
            fx, sx = 0.0, ssize - 1
        fx = float(np.float32(fx))
        w[dx, sx] += 1.0 - fx
        w[dx, min(sx + 1, ssize - 1)] += fx
    return w


def cv2_resize(img: np.ndarray, size_hw: Tuple[int, int], area: bool) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_AREA if area else
    INTER_LINEAR)`` of a (..., H, W, C) float32 image."""
    H, W = img.shape[-3:-1]
    h, w = size_hw
    if area and H >= h and W >= w:
        wy, wx = _area_weights(H, h), _area_weights(W, w)
    else:
        wy, wx = _linear_weights(H, h, area), _linear_weights(W, w, area)
    out = np.einsum("yh,...hwc->...ywc", wy, img.astype(np.float64))
    out = np.einsum("xw,...ywc->...yxc", wx, out)
    return out.astype(np.float32)


def _hsv_planes(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """OpenCV's ``RGB2HSV_f`` on float32 channel planes: H in [0, 360), S
    and V in [0, 1]."""
    v = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = v - vmin
    s = diff / (v.abs() + _FLT_EPSILON)
    # (float)(60. / (diff + FLT_EPSILON)): a float sum, a double quotient
    diff = (60.0 / (diff + _FLT_EPSILON).double()).float()
    h = torch.where(v == r, (g - b) * diff,
                    torch.where(v == g, (b - r) * diff + 120.0, (r - g) * diff + 240.0))
    return h + torch.where(h < 0, 360.0, 0.0), s, v


# for each sector of the hue, the entries of the table that b, g and r take
_SECTORS = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _rgb_planes(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor):
    """OpenCV's ``HSV2RGB_f`` on float32 channel planes (H in degrees);
    returns r, g, b."""
    h = torch.fmod(h * _SIXTH, 6.0)
    h = torch.where(h < 0, h + 6.0, h)
    sector = torch.floor(h)
    h = h - sector
    bad = (sector < 0) | (sector >= 6)
    sector = torch.where(bad, 0.0, sector).long()
    h = torch.where(bad, 0.0, h)
    # s == 0 makes every entry v, as OpenCV's grey branch
    tab = torch.stack([v, v * (1 - s), v * (1 - s * h), v * (1 - s * (1 - h))])
    return [tab.gather(0, _SECTORS[:, c][sector][None])[0] for c in (2, 1, 0)]


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(x, cv2.COLOR_RGB2HSV)`` of float32 RGB in [0, 1]
    (last axis): H in [0, 360), S and V in [0, 1]."""
    t = torch.from_numpy(np.ascontiguousarray(rgb, dtype=np.float32))
    return torch.stack(_hsv_planes(t[..., 0], t[..., 1], t[..., 2]), dim=-1).numpy()


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(x, cv2.COLOR_HSV2RGB)`` of float32 HSV (last axis; H
    in degrees)."""
    t = torch.from_numpy(np.ascontiguousarray(hsv, dtype=np.float32))
    return torch.stack(_rgb_planes(t[..., 0], t[..., 1], t[..., 2]), dim=-1).numpy()


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, cv2.CV_32F)`` for sigma > 0."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: np.ndarray, ksize: Tuple[int, int], sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, ksize, sigma)`` of a (..., H, W, C) float32
    image (the same sigma on both axes, ``BORDER_REFLECT_101``)."""
    kx, ky = gaussian_kernel(ksize[0], sigma), gaussian_kernel(ksize[1], sigma)
    out = img.astype(np.float32)
    for axis, k in ((-2, kx), (-3, ky)):
        r = len(k) // 2
        n = out.shape[axis]
        idx = np.arange(-r, n + r)
        idx = np.abs(idx)
        idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)  # reflect 101
        padded = np.take(out, idx, axis=axis)
        acc = np.zeros(out.shape, np.float32)
        for j, kj in enumerate(k):
            sl = [slice(None)] * out.ndim
            sl[axis] = slice(j, j + n)
            acc += kj * padded[tuple(sl)]
        out = acc
    return out


def gaussian_kernel_q8(ksize: int, sigma: float) -> np.ndarray:
    """The integer taps (summing to 256) of OpenCV's 8-bit fixed-point
    Gaussian kernel for an odd ``ksize`` and sigma > 0, which
    ``cv2.GaussianBlur`` uses on uint8 images: the bit-exact kernel
    (``getGaussianKernelBitExact``: the taps' exponentials in half-pixel
    units, normalized by the sum of the half and the centre) scaled by 256
    and rounded with the error carried from tap to tap
    (``getGaussianKernelFixedPoint_ED``), the centre taking what remains."""
    n2 = (ksize - 1) // 2
    scale2 = -0.125 / (float(sigma) * float(sigma))
    values = [math.exp(float(x * x) * scale2) for x in range(1 - ksize, 1 - ksize + 2 * n2, 2)]
    total = 0.0
    for v in values:
        total += v
    mul = 1.0 / (total * 2.0 + 1.0)
    taps, err = [], 0.0
    for v in values:
        adj = v * mul * 256.0 + err
        q = round(adj)  # half to even, as cvRound
        err = adj - q
        taps.append(q)
    return np.array(taps + [256 - 2 * sum(taps)] + taps[::-1], np.int64)


def gaussian_blur_u8(img: np.ndarray, ksize: Tuple[int, int], sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, ksize, sigma)`` of a uint8 (H, W) or (H, W, C)
    image (the same sigma on both axes, ``BORDER_REFLECT_101``), bit for
    bit: OpenCV's fixed-point path, the rows filtered with
    :func:`gaussian_kernel_q8` into 8 fraction bits, the columns into 16,
    then rounded (``+ 2^15 >> 16``). The sums are exact in int32 (at most
    255 * 2^16), and the symmetric taps are paired before their product."""
    if img.dtype != np.uint8:
        raise TypeError(f"gaussian_blur_u8 takes uint8, got {img.dtype}")
    out = img.astype(np.int32)
    for axis, k in ((1, gaussian_kernel_q8(ksize[0], sigma)), (0, gaussian_kernel_q8(ksize[1], sigma))):
        r = len(k) // 2
        n = out.shape[axis]
        idx = np.abs(np.arange(-r, n + r))
        idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)  # reflect 101
        padded = np.take(out, idx, axis=axis)

        def tap(j):
            sl = [slice(None)] * out.ndim
            sl[axis] = slice(j, j + n)
            return padded[tuple(sl)]

        acc = np.int32(k[r]) * tap(r)
        for j in range(r):
            acc += np.int32(k[j]) * (tap(j) + tap(2 * r - j))
        out = acc
    return ((out + (1 << 15)) >> 16).astype(np.uint8)


# -- the transforms ------------------------------------------------------------


@dataclasses.dataclass
class RandomCrop:
    size: Tuple[int, int]
    p: float = 1.0

    def __call__(self, v: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.uniform() > self.p:
            return v
        T, C, H, W = v.shape
        ch, cw = self.size
        top = int(rng.integers(0, H - ch + 1))
        left = int(rng.integers(0, W - cw + 1))
        return v[:, :, top : top + ch, left : left + cw]


@dataclasses.dataclass
class Resize:
    size: Tuple[int, int]
    antialias: bool = True

    def __call__(self, v: np.ndarray, rng) -> np.ndarray:
        area = self.antialias and self.size[0] < v.shape[2]
        return _to_chw(cv2_resize(_to_hwc(v), tuple(self.size), area)).astype(v.dtype)


@dataclasses.dataclass
class ColorJitter:
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0
    p: float = 1.0

    def __call__(self, v: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.uniform() > self.p:
            return v
        b = 1 + rng.uniform(-self.brightness, self.brightness)
        c = 1 + rng.uniform(-self.contrast, self.contrast)
        s = 1 + rng.uniform(-self.saturation, self.saturation)
        h = rng.uniform(-self.hue, self.hue)
        out = v * b
        mean = out.mean(axis=(2, 3), keepdims=True)
        out = (out - mean) * c + mean
        gray = out.mean(axis=1, keepdims=True)
        out = (out - gray) * s + gray
        if abs(h) > 1e-6 and v.shape[1] == 3:
            # JAX shifts the hue per frame of the (H, W, 3) layout; the same
            # arithmetic on the (T, 3, H, W) planes
            # (in torch on the CPU: its loops release the GIL, so the loader's
            # threads run them in parallel)
            planes = torch.from_numpy(np.clip(out, 0, 1)).unbind(1)
            hue, sat, val = _hsv_planes(*planes)
            hue = torch.remainder(hue + np.float32(h * 360.0), 360.0)
            out = torch.stack(_rgb_planes(hue, sat, val), dim=1).numpy()
        return np.clip(out, 0, 1)


@dataclasses.dataclass
class RandomSharpness:
    sharpness: float = 0.5
    p: float = 0.5

    def __call__(self, v: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.uniform() > self.p:
            return v
        factor = rng.uniform(0, self.sharpness)
        hwc = _to_hwc(v)
        blur = gaussian_blur(hwc, (5, 5), 1.0)
        return _to_chw(np.clip(hwc + factor * (hwc - blur), 0, 1).astype(v.dtype))


@dataclasses.dataclass
class RandomAutoContrast:
    p: float = 0.5

    def __call__(self, v: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.uniform() > self.p:
            return v
        lo = v.min(axis=(0, 2, 3), keepdims=True)
        hi = v.max(axis=(0, 2, 3), keepdims=True)
        return (v - lo) / np.maximum(hi - lo, 1e-6)


@dataclasses.dataclass
class RandomGrayscale:
    p: float = 0.1

    def __call__(self, v: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.uniform() > self.p or v.shape[1] != 3:
            return v
        w = np.array([0.299, 0.587, 0.114], v.dtype).reshape(1, 3, 1, 1)
        gray = (v * w).sum(axis=1, keepdims=True)
        return np.repeat(gray, 3, axis=1)


@dataclasses.dataclass
class GaussianBlur:
    kernel_size: Tuple[int, int] = (5, 5)
    sigma: Tuple[float, float] = (0.1, 2.0)
    p: float = 0.5

    def __call__(self, v: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.uniform() > self.p:
            return v
        sigma = float(rng.uniform(*self.sigma))
        return _to_chw(gaussian_blur(_to_hwc(v), tuple(self.kernel_size), sigma).astype(v.dtype))


_REGISTRY = {
    "RandomCrop": RandomCrop,
    "Resize": Resize,
    "ColorJitter": ColorJitter,
    "RandomSharpness": RandomSharpness,
    "RandomAutoContrast": RandomAutoContrast,
    "RandomGrayscale": RandomGrayscale,
    "GaussianBlur": GaussianBlur,
}


class VideoTransforms:
    """Compose transforms from config dicts ({'name': ..., **kwargs})."""

    def __init__(self, specs: Sequence[dict], seed: int = 0):
        self.transforms = []
        for spec in specs:
            spec = dict(spec)
            cls = _REGISTRY[spec.pop("name")]
            for key in ("size", "kernel_size", "sigma"):
                if key in spec and isinstance(spec[key], list):
                    spec[key] = tuple(spec[key])
            self.transforms.append(cls(**spec))
        self.seed = seed

    def __call__(self, video: np.ndarray, sample_seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng((self.seed, sample_seed))
        for t in self.transforms:
            video = t(video, rng)
        return video
