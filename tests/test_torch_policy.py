"""The serving slice as a whole: the port's UnifiedVideoActionPolicy
.predict_action against the JAX policy's predict program on the CPU, in
fp32, at a small size (2+2 blocks of d=64, a 32 px VAE with ch=32, a
2-block denoiser), for 100 sampler steps and for ddim10, with the
flagship's action normalizer.

Both sides get the same uint8 frames and the same weights (numpy draws in
the JAX tree's layout, through the port's weight bridge); the port gets the
JAX program's own noise, drawn from its key as the program splits it
(policy.py:443, heads.py:283-297, gaussian.py:322-330).

Tolerance: atol 1e-4 in the normalized action units ([-1, 1]), rtol 1e-5.
The first steps of the cosine schedule multiply x and eps by
sqrt(1/alpha_bar), up to about 2e4 at t = 999, before x0 is clipped, so
float32 rounding differences in the denoiser's output leave the sampler
larger than 1e-5. The actions are compared after unnormalizing, where the
flagship's normalizer scales 1 unit to 244 PushT pixels.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import TINY_POLICY_KW, policy_draws, random_params, to_numpy
from unified_video_action_tpu.data.normalizer import LinearNormalizer as JaxNormalizer
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
from unified_video_action_tpu_torch.ops import attention as attention_ops
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATEST = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest")
NORMALIZED_ATOL = 1e-4


def _kwargs(steps):
    kw = copy.deepcopy(TINY_POLICY_KW)
    kw["autoregressive_model_params"]["act_diff_testing_steps"] = steps
    return kw


@pytest.mark.parametrize("steps", ["100", "ddim10"])
def test_predict_action_matches_jax(steps):
    kw = _kwargs(steps)
    jp = JaxPolicy(**kw)
    jp.set_normalizer(JaxNormalizer.load(os.path.join(LATEST, "normalizer.npz")))
    params = random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=0)

    port = UnifiedVideoActionPolicy(**kw, device="cpu")
    port.load_params(to_numpy(params["mar"]), to_numpy(params["vae"]))
    port.set_normalizer(LinearNormalizer.load(os.path.join(LATEST, "normalizer.npz")))

    frames = np.random.default_rng(1).integers(0, 256, (3, 4, 3, 32, 32), dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jp._build_predict_fn()(params, jnp.asarray(frames), key))

    noise = policy_draws(key, port.noise_shapes(3))
    got = port.predict_action(torch.tensor(frames), noise=noise)
    assert got.shape == (3, 16, 2) and got.dtype == torch.float32
    assert port.mar.diffactloss.num_steps == (100 if steps == "100" else 10)
    scale = float(port.normalizer["action"].scale.min())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=NORMALIZED_ATOL / scale)


def test_predict_action_draws_from_a_generator():
    port = UnifiedVideoActionPolicy(**TINY_POLICY_KW, device="cpu")
    frames = torch.zeros(2, 4, 3, 32, 32, dtype=torch.uint8)
    a = port.predict_action(frames, generator=torch.Generator().manual_seed(0))
    b = port.predict_action(frames, generator=torch.Generator().manual_seed(0))
    c = port.predict_action(frames, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_attention_routes_agree_on_the_cpu():
    port = UnifiedVideoActionPolicy(**TINY_POLICY_KW, device="cpu")
    frames = torch.randint(0, 256, (2, 4, 3, 32, 32), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    noise = port.sample_noise(2, torch.Generator().manual_seed(3))
    before = attention_ops.launch_count
    a = port.predict_action(frames, noise=noise)
    port.set_attn_impl("plain")
    b = port.predict_action(frames, noise=noise)
    assert attention_ops.launch_count == before  # CPU tensors never launch the kernel
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flagship_config_builds_mar_base():
    policy = UnifiedVideoActionPolicy.from_run_config(os.path.join(LATEST, "meta.json"), device="meta")
    c = policy.mar_cfg
    assert (c.encoder_embed_dim, c.encoder_depth, c.encoder_num_heads) == (768, 12, 12)
    assert (c.decoder_embed_dim, c.decoder_depth, c.decoder_num_heads) == (768, 12, 12)
    assert (c.img_size, c.seq_hw, c.total_tokens) == (96, 6, 144)
    assert policy.dtype == torch.bfloat16 and policy.temperature == 0.95
    assert policy.noise_shapes(1) == {"vae": (4, 16, 6, 6), "init": (16, 2), "steps": (100, 16, 2)}
    n_params = sum(p.numel() for p in policy.mar.parameters())
    assert 200_000_000 < n_params < 260_600_000


def test_cuda_is_required_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        UnifiedVideoActionPolicy(**TINY_POLICY_KW)


@pytest.mark.parametrize("option", [{"serving_quant": "int8"}, {"obs_codec": "yuv420"},
                                    {"use_proprioception": True}])
def test_unported_options_are_refused(option):
    with pytest.raises(NotImplementedError):
        UnifiedVideoActionPolicy(**TINY_POLICY_KW, **option, device="cpu")


def test_unknown_options_and_bad_noise_are_refused():
    with pytest.raises(TypeError, match="bogus"):
        UnifiedVideoActionPolicy(**TINY_POLICY_KW, bogus=1, device="cpu")
    port = UnifiedVideoActionPolicy(**TINY_POLICY_KW, device="cpu")
    noise = port.sample_noise(1)
    with pytest.raises(ValueError, match="noise"):
        port.predict_action(torch.zeros(2, 4, 3, 32, 32, dtype=torch.uint8), noise=noise)
    with pytest.raises(ValueError, match="frames"):
        port.predict_action(torch.zeros(2, 3, 3, 32, 32, dtype=torch.uint8), noise=noise)
