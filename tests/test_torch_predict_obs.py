"""The port's obs-dict UnifiedVideoActionPolicy.predict_action against JAX's
predict_action (policy/policy.py:574-630) on the CPU, in fp32, at the tiny
config of tests/_torch_parity.py, with and without obs_codec="yuv420".

Both get the same 16-frame float [0, 1] observation window, so both select
frames 3, 7, 11, 15 on the host, round them to uint8 and (under yuv420) pack
them to YUV420 before the predict program. The port gets the JAX program's
own noise, drawn from its key (tests/_torch_parity.py:policy_draws).

Tolerance: that of tests/test_torch_policy.py, atol 1e-4 in normalized
action units and rtol 1e-5 (the sampler's first steps amplify float32
rounding differences of the denoiser by up to about 2e4 before x0 is
clipped).
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from tests._torch_parity import TINY_POLICY_KW, policy_draws, random_params, to_numpy
from unified_video_action_tpu.data.normalizer import LinearNormalizer as JaxNormalizer
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.utils.obs_codec import encode_yuv420

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMALIZER = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest", "normalizer.npz")
NORMALIZED_ATOL = 1e-4
B = 3


def _kwargs():
    kw = copy.deepcopy(TINY_POLICY_KW)
    kw["autoregressive_model_params"]["act_diff_testing_steps"] = "ddim10"
    return kw


def _pair(obs_codec):
    kw = _kwargs()
    jp = JaxPolicy(**kw, obs_codec=obs_codec)
    jp.set_normalizer(JaxNormalizer.load(NORMALIZER))
    params = random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=0)
    port = UnifiedVideoActionPolicy(**kw, obs_codec=obs_codec, device="cpu")
    port.load_params(to_numpy(params["mar"]), to_numpy(params["vae"]))
    port.set_normalizer(LinearNormalizer.load(NORMALIZER))
    return jp, params, port


def _window(seed=11):
    return {"image": np.random.default_rng(seed).random((B, 16, 3, 32, 32)).astype(np.float32)}


@pytest.mark.parametrize("obs_codec", [None, "yuv420"])
def test_predict_action_obs_dict_matches_jax(obs_codec):
    jp, params, port = _pair(obs_codec)
    obs = _window()
    key = jax.random.PRNGKey(21)
    want = jp.predict_action(params, obs, key)
    got = port.predict_action(obs, noise=policy_draws(key, port.noise_shapes(B)))
    assert set(got) == {"action", "action_pred"}
    for name, shape in (("action", (B, 8, 2)), ("action_pred", (B, 16, 2))):
        assert isinstance(got[name], np.ndarray)
        assert got[name].shape == want[name].shape == shape
        assert got[name].dtype == np.float32
    np.testing.assert_array_equal(got["action"], got["action_pred"][:, :8])
    scale = float(port.normalizer["action"].scale.min())
    np.testing.assert_allclose(got["action_pred"], want["action_pred"], rtol=1e-5,
                               atol=NORMALIZED_ATOL / scale)


def test_yuv420_frames_never_skip_the_codec():
    # the old frames-tensor call decoded only 3-D input, so a (B, 4, 3, H, W)
    # tensor served a yuv420 policy the raw-frame function; now
    # predict_action_frames refuses it, and predict_action packs the frames
    _, _, port = _pair("yuv420")
    obs = _window(seed=12)
    noise = port.sample_noise(B, torch.Generator().manual_seed(5))
    selected = np.round(obs["image"][:, [3, 7, 11, 15]] * 255.0).astype(np.uint8)
    with pytest.raises(ValueError, match="packed"):
        port.predict_action_frames(torch.from_numpy(selected), noise=noise)
    got = port.predict_action(obs, noise=noise)["action_pred"]
    packed = port.predict_action_frames(torch.from_numpy(encode_yuv420(selected)), noise=noise)
    np.testing.assert_array_equal(got, packed.numpy())
    # the codec changes the answer, so a call that skipped it would show
    raw_port = UnifiedVideoActionPolicy(**_kwargs(), device="cpu")
    raw_port.mar.load_state_dict(port.mar.state_dict())
    raw_port.vae.load_state_dict(port.vae.state_dict())
    raw_port.set_normalizer(port.normalizer)
    raw = raw_port.predict_action_frames(torch.from_numpy(selected), noise=noise)
    assert not np.allclose(got, raw.numpy(), rtol=0, atol=1e-6)
