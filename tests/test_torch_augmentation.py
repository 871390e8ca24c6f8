"""The port's video augmentation (``data/augmentation.py``) against the JAX
package's, which computes its resize, hue shift and blurs with OpenCV, on
the CPU.

- Each transform of ``_REGISTRY`` through ``VideoTransforms`` at seeded
  ``sample_seed``s (the same ``default_rng((seed, sample_seed))`` draws on
  both sides): the output within AUG_ATOL of JAX's; the transforms
  without OpenCV in JAX (RandomCrop, RandomAutoContrast, RandomGrayscale,
  ColorJitter with no hue) bit-equal. Measured over 40 sample seeds: at
  most 2.2e-6 (the linear resize's coefficients, which OpenCV rounds to
  float32). The UMI pipeline composed of all seven within PIPELINE_ATOL:
  RandomAutoContrast divides the differences before it by the clip's range;
  measured 5.3e-6.
- The numpy twins of OpenCV's functions against OpenCV itself: the resize
  (INTER_AREA, shrinking, growing and both, and INTER_LINEAR) within
  RESIZE_ATOL, the float32 RGB -> HSV within one float32 step at 360
  (HUE_ATOL degrees; S and V exact) and HSV -> RGB within 1e-6, the
  Gaussian kernel exactly and the blur within 1e-6.
"""

import cv2
import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu.data import augmentation as jaug
from unified_video_action_tpu_torch.data import augmentation as paug

AUG_ATOL = 5e-6
PIPELINE_ATOL = 2e-5
RESIZE_ATOL = 5e-6
HUE_ATOL = 6.2e-5  # two float32 steps at 360 degrees
BLUR_ATOL = 1e-6

SPECS = {
    "RandomCrop": {"name": "RandomCrop", "size": [30, 36], "p": 0.9},
    "Resize_down": {"name": "Resize", "size": [28, 30]},
    "Resize_up": {"name": "Resize", "size": [56, 60]},
    "Resize_linear_down": {"name": "Resize", "size": [28, 30], "antialias": False},
    "ColorJitter": {"name": "ColorJitter", "brightness": 0.3, "contrast": 0.4, "saturation": 0.5,
                    "hue": 0.08, "p": 1.0},
    "ColorJitter_no_hue": {"name": "ColorJitter", "brightness": 0.3, "contrast": 0.4,
                           "saturation": 0.5, "p": 1.0},
    "RandomSharpness": {"name": "RandomSharpness", "sharpness": 0.5, "p": 0.7},
    "RandomAutoContrast": {"name": "RandomAutoContrast", "p": 0.5},
    "RandomGrayscale": {"name": "RandomGrayscale", "p": 0.5},
    "GaussianBlur": {"name": "GaussianBlur", "kernel_size": [5, 5], "sigma": [0.1, 2.0], "p": 0.8},
}
# the JAX package's transforms that make no OpenCV call
EXACT = {"RandomCrop", "ColorJitter_no_hue", "RandomAutoContrast", "RandomGrayscale"}
# config/task/umi_lazy.yaml's pipeline, at a small size
UMI_PIPELINE = [
    {"name": "RandomCrop", "size": [36, 36]},
    {"name": "Resize", "size": [40, 40]},
    {"name": "ColorJitter", "brightness": 0.3, "contrast": 0.4, "saturation": 0.5, "hue": 0.08},
    {"name": "RandomSharpness", "sharpness": 0.5},
    {"name": "RandomAutoContrast"},
    {"name": "RandomGrayscale"},
    {"name": "GaussianBlur", "kernel_size": [5, 5], "sigma": [0.1, 2.0]},
]


def _video(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(3, 3, 40, 48)).astype(np.float32)


@pytest.mark.parametrize("sample_seed", [0, 1, 5, 17])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_transform_matches_jax(name, sample_seed):
    video = _video(sample_seed + 100)
    want = jaug.VideoTransforms([SPECS[name]], seed=3)(video.copy(), sample_seed=sample_seed)
    got = paug.VideoTransforms([SPECS[name]], seed=3)(video.copy(), sample_seed=sample_seed)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=AUG_ATOL)


@pytest.mark.parametrize("sample_seed", [0, 2, 3])
def test_umi_pipeline_matches_jax(sample_seed):
    video = _video(sample_seed)
    want = jaug.VideoTransforms(UMI_PIPELINE, seed=42)(video.copy(), sample_seed=sample_seed)
    got = paug.VideoTransforms(UMI_PIPELINE, seed=42)(video.copy(), sample_seed=sample_seed)
    assert got.shape == want.shape == (3, 3, 40, 40)
    np.testing.assert_allclose(got, want, rtol=0, atol=PIPELINE_ATOL)


@pytest.mark.parametrize("size,area", [((24, 30), True), ((18, 15), True), ((74, 90), True),
                                       ((20, 60), True), ((12, 45), True), ((24, 30), False),
                                       ((74, 90), False), ((40, 20), False)])
def test_resize_matches_opencv(size, area):
    img = np.random.default_rng(1).uniform(size=(37, 45, 3)).astype(np.float32)
    want = cv2.resize(img, (size[1], size[0]),
                      interpolation=cv2.INTER_AREA if area else cv2.INTER_LINEAR)
    np.testing.assert_allclose(paug.cv2_resize(img, size, area), want, rtol=0, atol=RESIZE_ATOL)


def test_hsv_and_blur_match_opencv():
    img = np.random.default_rng(2).uniform(size=(33, 41, 3)).astype(np.float32)
    img[0, :3] = [[0.5, 0.5, 0.5], [0.2, 0.2, 0.7], [0.7, 0.2, 0.2]]  # grey and ties
    want = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    got = paug.rgb_to_hsv(img)
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=HUE_ATOL)
    np.testing.assert_array_equal(got[..., 1:], want[..., 1:])
    want[..., 0] = (want[..., 0] + 0.07 * 360.0) % 360.0
    np.testing.assert_allclose(paug.hsv_to_rgb(want), cv2.cvtColor(want, cv2.COLOR_HSV2RGB),
                               rtol=0, atol=1e-6)
    for sigma in (0.1, 0.7, 1.0, 1.93):
        np.testing.assert_array_equal(paug.gaussian_kernel(5, sigma),
                                      cv2.getGaussianKernel(5, sigma, cv2.CV_32F)[:, 0])
        np.testing.assert_allclose(paug.gaussian_blur(img, (5, 5), sigma),
                                   cv2.GaussianBlur(img, (5, 5), sigma), rtol=0, atol=BLUR_ATOL)
