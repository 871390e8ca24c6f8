"""The port's serving front end against the JAX package on the CPU: the
YUV420 observation codec (utils/obs_codec.py), eval frame selection
(utils/frames.py) and the per-task camera-key remap (utils/image.py).

Tolerances: the numpy encoder is the same code on the same input, so its
output is bit-equal. The decoder is within atol 1e-6 of JAX's jitted one:
XLA folds ``/ 255.0`` into a multiplication by fl32(1/255) and may fuse the
BT.601 products into FMAs, which moves a [0, 1] value by a few ulp (6e-8
each). Index selection and key remaps are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu.utils import frames as jframes
from unified_video_action_tpu.utils import image as jimage
from unified_video_action_tpu.utils import obs_codec as jcodec
from unified_video_action_tpu_torch.utils import frames as pframes
from unified_video_action_tpu_torch.utils import image as pimage
from unified_video_action_tpu_torch.utils import obs_codec as pcodec


def _rgb(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(2, 4, 3, 96, 96), (3, 3, 32, 32), (1, 2, 3, 8, 12)])
def test_encode_yuv420_is_bit_equal(shape):
    rgb = _rgb(shape, seed=len(shape))
    got = pcodec.encode_yuv420(rgb)
    want = jcodec.encode_yuv420(rgb)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 4, 3, 96, 96), (3, 3, 32, 32)])
def test_decode_yuv420_matches_jax(shape):
    packed = jcodec.encode_yuv420(_rgb(shape, seed=7))
    got = pcodec.decode_yuv420(torch.from_numpy(packed))
    want = np.asarray(jax.jit(jcodec.decode_yuv420)(jnp.asarray(packed)))
    assert got.dtype == torch.float32 and got.shape == want.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    eager = np.asarray(jcodec.decode_yuv420(jnp.asarray(packed)))
    np.testing.assert_allclose(got.numpy(), eager, rtol=0, atol=1e-6)


def test_decode_of_non_square_frames_takes_its_shape():
    packed = jcodec.encode_yuv420(_rgb((2, 3, 8, 12), seed=8))
    got = pcodec.decode_yuv420(torch.from_numpy(packed), 8, 12)
    want = np.asarray(jcodec.decode_yuv420(jnp.asarray(packed), 8, 12))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_codec_sizes_and_errors_match():
    assert pcodec.CODECS == jcodec.CODECS
    for h, w in [(96, 96), (32, 48), (224, 224)]:
        assert pcodec.packed_size(h, w) == jcodec.packed_size(h, w)
    assert pcodec.hw_from_packed(13824) == jcodec.hw_from_packed(13824) == 96
    with pytest.raises(ValueError):
        pcodec.packed_size(95, 96)
    with pytest.raises(ValueError):
        pcodec.hw_from_packed(13825)
    with pytest.raises(ValueError):
        pcodec.encode_yuv420(np.zeros((3, 4, 4), np.float32))


@pytest.mark.parametrize("total", [4, 8, 16, 32])
def test_select_frame_indices_matches_jax_eval(total):
    got = pframes.select_frame_indices(total)
    want = jframes.select_frame_indices(total, eval=True)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("task", ["pusht", "libero_10", "kitchen", "umi", "toolhang"])
def test_remap_image_keys_matches_jax(task):
    obs = {"agentview_rgb": 1, "agentview_image": 2, "camera0_rgb": 3, "sideview_image": 4,
           "robot0_eye_in_hand_image": 5, "image": 6, "agent_pos": 7}
    # JAX's table, and Fetch's key, which JAX lacks (ROADMAP C16)
    assert {k: v for k, v in pimage.TASK_IMAGE_KEYS.items() if k != "fetch"} == \
        jimage.TASK_IMAGE_KEYS
    assert pimage.TASK_IMAGE_KEYS["fetch"] == {"agentview_image": "image"}
    assert pimage.remap_image_keys(task, obs) == jimage.remap_image_keys(task, obs)
