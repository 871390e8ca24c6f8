"""Port of utils/image.py (resize_video, to_model_range) and of the
normalizer that serving reads (data/normalizer.py), against the JAX package
on the CPU.

Tolerance: FP32_TOL (rtol = atol = 1e-5) for the bilinear resize, whose
two-tap weights are computed in another order; the normalizer's arithmetic
must agree to float32 rounding.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import FP32_TOL
from unified_video_action_tpu.data.normalizer import LinearNormalizer as JaxNormalizer
from unified_video_action_tpu.utils import image as jimage
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer, NormalizerField
from unified_video_action_tpu_torch.utils import image as pimage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMALIZER = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest", "normalizer.npz")


def _frames(H, W, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (2, 4, 3, H, W)).astype(np.float32)


def test_resize_is_the_identity_at_the_model_size():
    x = torch.tensor(_frames(96, 96))
    assert pimage.resize_video(x, 96) is x


@pytest.mark.parametrize("src,dst", [(96, 256), (128, 256), (48, 32), (96, 40)])
def test_resize_matches_jax(src, dst):
    x = _frames(src, src, seed=src + dst)
    want = np.asarray(jimage.resize_video(jnp.asarray(x), dst))
    got = pimage.resize_video(torch.tensor(x), dst).numpy()
    assert got.shape == (2, 4, 3, dst, dst)
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_to_model_range_matches_jax():
    x = _frames(8, 8)
    np.testing.assert_allclose(
        pimage.to_model_range(torch.tensor(x)).numpy(),
        np.asarray(jimage.to_model_range(jnp.asarray(x))), rtol=0, atol=1e-6,
    )


def test_flagship_normalizer_loads_like_jax():
    j = JaxNormalizer.load(NORMALIZER)
    p = LinearNormalizer.load(NORMALIZER)
    assert set(p.fields) == set(j.fields) and "action" in p
    for name in j.fields:
        np.testing.assert_array_equal(p[name].scale, j[name].scale)
        np.testing.assert_array_equal(p[name].offset, j[name].offset)
        assert set(p[name].input_stats) == set(j[name].input_stats)


def test_unnormalize_matches_jax():
    j = JaxNormalizer.load(NORMALIZER)["action"]
    p = LinearNormalizer.load(NORMALIZER)["action"]
    x = np.random.default_rng(1).uniform(-1, 1, (3, 16, 2)).astype(np.float32)
    want = np.asarray(j.unnormalize(jnp.asarray(x)))
    got = p.unnormalize(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.normalize(torch.tensor(got)).numpy(), x, rtol=1e-5, atol=1e-5)


def test_identity_field():
    f = NormalizerField.identity(2)
    x = torch.randn(4, 2, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(f.unnormalize(x), x)
