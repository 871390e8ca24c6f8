"""Port of models/vae.py's encode path against the JAX KLVae on the CPU.

A 32 px VAE with ch=32 and ch_mult (1, 1, 2, 2) reaches resolution 16 at
its second level, so the encoder's per-level AttnBlock runs as well as the
mid block's. The flagship's trained 96 px VAE (pusht_vae96.npz) is held to
the same tolerance when the file is in the checkout. Tolerance: FP32_TOL for
(mean, logvar), the same arithmetic in another order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import FP32_TOL, init_shapes, random_params, to_numpy
from unified_video_action_tpu.models import vae as jv
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.models import vae as pv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(embed_dim=8, ch_mult=(1, 1, 2, 2), resolution=32, ch=32)


@pytest.fixture(scope="module")
def vaes():
    jm = jv.KLVae(**CFG)
    x0 = jnp.zeros((1, 3, 32, 32))
    shapes = init_shapes(jm, x0, jax.random.PRNGKey(0))
    params = random_params(shapes, seed=0)
    pm = pv.KLVae(**CFG)
    convert.load_into(pm, to_numpy(params))
    return jm, params, pm


def _frames(B=3, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (B, 3, 32, 32)).astype(np.float32)


def test_encoder_has_the_per_level_attention():
    names = pv.Encoder(ch=32, ch_mult=(1, 1, 2, 2), resolution=32).order
    assert "down_1_attn_0" in names and "down_1_attn_1" in names and "mid_attn_1" in names
    assert "down_3_downsample" not in names


def test_encode_matches_jax(vaes):
    jm, params, pm = vaes
    x = _frames()
    mean, logvar = jm.apply({"params": params}, jnp.asarray(x), method=jv.KLVae.encode)
    with torch.no_grad():
        got_mean, got_logvar = pm.encode(torch.tensor(x))
    assert got_mean.shape == (3, 8, 4, 4) and got_mean.dtype == torch.float32
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(mean), **FP32_TOL)
    np.testing.assert_allclose(got_logvar.numpy(), np.asarray(logvar), **FP32_TOL)


def test_sample_posterior_with_injected_noise_matches_jax():
    rng = np.random.default_rng(2)
    mean = rng.standard_normal((2, 8, 4, 4)).astype(np.float32)
    logvar = rng.uniform(-3, 1, (2, 8, 4, 4)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jv.sample_posterior(jnp.asarray(mean), jnp.asarray(logvar), key))
    noise = torch.tensor(np.asarray(jax.random.normal(key, mean.shape)))
    got = pv.sample_posterior(torch.tensor(mean), torch.tensor(logvar), noise).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_latent_scale_is_the_reference_one():
    assert pv.LATENT_SCALE == jv.LATENT_SCALE == 0.2325


def test_logvar_is_clipped_like_jax(vaes):
    jm, params, _ = vaes
    # a quant_conv 100x larger drives logvar past both ends of [-30, 20]
    loud = jax.tree.map(lambda a: a, params)
    loud["quant_conv"] = dict(params["quant_conv"], kernel=100.0 * params["quant_conv"]["kernel"])
    pm = convert.load_into(pv.KLVae(**CFG), to_numpy(loud))
    x = _frames(B=2, seed=3)
    _, logvar = jm.apply({"params": loud}, jnp.asarray(x), method=jv.KLVae.encode)
    with torch.no_grad():
        _, got = pm.encode(torch.tensor(x))
    assert float(got.max()) == 20.0 and float(got.min()) == -30.0
    # the 100x layer scales the fp32 rounding differences 100x as well
    np.testing.assert_allclose(got.numpy(), np.asarray(logvar), rtol=1e-5, atol=100 * 1e-5)


def test_encode_matches_jax_on_the_committed_vae():
    # the flagship's trained 96 px VAE (ch=64), as the serving path loads it
    path = os.path.join(REPO, "pretrained_models", "vae", "pusht_vae96.npz")
    if not os.path.exists(path):
        pytest.skip(f"{path} is not in this checkout")
    cfg = dict(embed_dim=16, ch_mult=(1, 1, 2, 2, 4), resolution=96, ch=64)
    tree = convert.load_flat_npz(path)
    pm = convert.load_into(pv.KLVae(**cfg), tree)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 3, 96, 96)).astype(np.float32)
    mean, logvar = jv.KLVae(**cfg).apply({"params": tree}, jnp.asarray(x), method=jv.KLVae.encode)
    with torch.no_grad():
        got_mean, got_logvar = pm.encode(torch.tensor(x))
    assert got_mean.shape == (2, 16, 6, 6)
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(mean), **FP32_TOL)
    np.testing.assert_allclose(got_logvar.numpy(), np.asarray(logvar), **FP32_TOL)
