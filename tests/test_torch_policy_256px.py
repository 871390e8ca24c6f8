"""The reference's 256 px PushT path: the port's ``PUSHT_256`` config against
the JAX package's, and the port's policy at that geometry against the JAX
policy's predict program on the CPU, in fp32.

Geometry as the reference's: ``img_size`` 256, ``vae_stride`` 16, a KL-16 VAE
with ``ch_mult`` [1, 1, 2, 2, 4], 96 px uint8 frames upscaled to 256 on
both sides, so the MAR attends over 4 x 16 x 16 = 1024 tokens. Width cut to
run on the CPU: 2+2 blocks of d=64 with 4 heads, a VAE with ``ch`` 32, a
2-block denoiser of width 32.

Both sides get the same frames and weights (numpy draws in the JAX tree's
layout, through the port's weight bridge); the port gets the JAX program's
own noise (tests/_torch_parity.py:policy_draws). Tolerance: that of
tests/test_torch_policy.py, atol 1e-4 in normalized action units with rtol
1e-5 (the sampler's first steps amplify float32 rounding differences of the
denoiser by up to about 2e4 before x0 is clipped).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (
    BENCH_PARITY_OVERRIDES,
    TINY_POLICY_KW,
    assert_same_run_config,
    policy_draws,
    random_params,
    to_numpy,
)
from unified_video_action_tpu.config import load_config
from unified_video_action_tpu.data.normalizer import LinearNormalizer as JaxNormalizer
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch.config import PUSHT_256
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
from unified_video_action_tpu_torch.ops import attention as attention_ops
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMALIZER = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest", "normalizer.npz")
NORMALIZED_ATOL = 1e-4
B = 2

def test_pusht_256_is_the_jax_config_with_bench_overrides():
    # bench.py's parity overrides (tests/_torch_parity.py); the yaml reads
    # "100" as a string where quoted, the override reads 100 as an int
    jax_cfg = load_config("uva_pusht", BENCH_PARITY_OVERRIDES).to_dict()
    assert_same_run_config(PUSHT_256, jax_cfg, as_str=("act_diff_testing_steps",))


def test_pusht_256_builds_mar_base_at_1024_tokens():
    policy = UnifiedVideoActionPolicy.from_cfg(PUSHT_256, device="meta")
    c = policy.mar_cfg
    assert (c.encoder_embed_dim, c.encoder_depth, c.encoder_num_heads) == (768, 12, 12)
    assert (c.decoder_embed_dim, c.decoder_depth, c.decoder_num_heads) == (768, 12, 12)
    assert (c.img_size, c.seq_hw, c.total_tokens) == (256, 16, 1024)
    assert (c.diffloss_act_d, c.diffloss_act_w) == (6, 1024)
    assert policy.dtype == torch.bfloat16 and policy.temperature == 0.95
    assert policy.vae_encode_chunk == 64 and policy.mar.diffactloss.num_steps == 100
    assert policy.vae.encoder.conv_in.out_channels == 128
    assert policy.noise_shapes(1) == {"vae": (4, 16, 16, 16), "init": (16, 2), "steps": (100, 16, 2)}
    # the MAR and action head (225.3 M) and the video head
    assert 260_800_000 < sum(p.numel() for p in policy.mar.parameters()) < 261_400_000
    # the KL-16 VAE at ch 128: the encoder (28.3 M) and the decoder (38.2 M)
    assert 28_000_000 < sum(p.numel() for p in policy.vae.encoder.parameters()) < 28_600_000
    assert 66_000_000 < sum(p.numel() for p in policy.vae.parameters()) < 66_900_000
    # every ViT block at both serving batches goes to the online kernel
    for batch in (1, 128):
        plan = attention_ops.attention_plan(batch, c.total_tokens, c.encoder_num_heads,
                                            c.encoder_embed_dim // c.encoder_num_heads, policy.dtype)
        assert plan.kernel == "attention_wgmma_online"


def _tiny_256_kwargs(steps):
    kw = copy.deepcopy(TINY_POLICY_KW)
    kw["vae_model_params"]["ddconfig"] = {"vae_embed_dim": 16, "ch_mult": [1, 1, 2, 2, 4], "ch": 32}
    kw["autoregressive_model_params"].update(
        img_size=256, vae_stride=16, vae_embed_dim=16, act_diff_testing_steps=steps)
    return kw


def _pair(steps):
    kw = _tiny_256_kwargs(steps)
    jp = JaxPolicy(**kw)
    jp.set_normalizer(JaxNormalizer.load(NORMALIZER))
    params = random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=0)
    port = UnifiedVideoActionPolicy(**kw, device="cpu")
    port.load_params(to_numpy(params["mar"]), to_numpy(params["vae"]))
    port.set_normalizer(LinearNormalizer.load(NORMALIZER))
    assert port.mar_cfg.total_tokens == 1024
    return jp, params, port


@pytest.mark.parametrize("steps", ["100", "ddim10"])
def test_predict_action_frames_at_256px_matches_jax(steps):
    jp, params, port = _pair(steps)
    frames = np.random.default_rng(1).integers(0, 256, (B, 4, 3, 96, 96), dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jp._build_predict_fn()(params, jnp.asarray(frames), key))
    got = port.predict_action_frames(torch.tensor(frames),
                                     noise=policy_draws(key, port.noise_shapes(B)))
    assert got.shape == (B, 16, 2) and got.dtype == torch.float32
    scale = float(port.normalizer["action"].scale.min())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=NORMALIZED_ATOL / scale)


def test_predict_action_obs_dict_at_256px_matches_jax():
    jp, params, port = _pair("ddim10")
    obs = {"image": np.random.default_rng(11).random((B, 16, 3, 96, 96)).astype(np.float32)}
    key = jax.random.PRNGKey(21)
    want = jp.predict_action(params, obs, key)
    got = port.predict_action(obs, noise=policy_draws(key, port.noise_shapes(B)))
    assert got["action_pred"].shape == want["action_pred"].shape == (B, 16, 2)
    np.testing.assert_array_equal(got["action"], got["action_pred"][:, :8])
    scale = float(port.normalizer["action"].scale.min())
    np.testing.assert_allclose(got["action_pred"], want["action_pred"], rtol=1e-5,
                               atol=NORMALIZED_ATOL / scale)
