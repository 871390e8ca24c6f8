"""Port of models/vae.py's decode path (Upsample, Decoder, post_quant_conv,
KLVae.decode) against the JAX KLVae on the CPU, in fp32.

- A 32 px VAE with ch=32 and ch_mult (1, 1, 2, 2) of seeded random weights:
  three nearest x2 upsamples, the mid block's attention.
- The flagship's trained 96 px VAE (pretrained_models/vae/pusht_vae96.npz,
  ch=64): two frames of the committed corpus encoded to their posterior mean
  by JAX and decoded, against JAX's reconstruction; and the PSNR of the
  port's own reconstruction (its encode, then its decode) against JAX's.
- A VAE tree without the decoder is refused, the error naming the subtrees.

Tolerance: FP32_TOL for the decode, the same arithmetic in another order;
the PSNR within 0.01 dB of JAX's. (The port's own reconstruction is not held
to FP32_TOL: its encode's rounding, within FP32_TOL of JAX's mean, reaches
2e-4 through the trained decoder.)
"""

import os
import zipfile

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
VAE96 = os.path.join(REPO, "pretrained_models", "vae", "pusht_vae96.npz")
CORPUS = os.path.join(REPO, "corpora", "pusht_demos_r5b.npz")
CFG = dict(embed_dim=8, ch_mult=(1, 1, 2, 2), resolution=32, ch=32)
CFG96 = dict(embed_dim=16, ch_mult=(1, 1, 2, 2, 4), resolution=96, ch=64)
PSNR_DB_TOL = 0.01


def corpus_frames(indices):
    """Frames of the committed corpus, (N, 3, 96, 96) in [-1, 1], read from
    the start of its ``img`` array without inflating the rest."""
    with zipfile.ZipFile(CORPUS) as z, z.open("img.npy") as f:
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, _, dtype = read_header(f)
        count = (max(indices) + 1) * int(np.prod(shape[1:]))
        img = np.frombuffer(f.read(count * dtype.itemsize), dtype).reshape(-1, *shape[1:])
    x = img[list(indices)].astype(np.float32) / 127.5 - 1.0
    return np.ascontiguousarray(np.moveaxis(x, -1, 1))


def psnr(recon, frames):
    """dB over frames in [-1, 1] (peak-to-peak 2), the reconstruction clipped."""
    mse = float(np.mean((np.clip(recon, -1, 1) - frames) ** 2))
    return 10.0 * np.log10(4.0 / mse)


@pytest.fixture(scope="module")
def vaes():
    jm = jv.KLVae(**CFG)
    shapes = init_shapes(jm, jnp.zeros((1, 3, 32, 32)), jax.random.PRNGKey(0))
    params = random_params(shapes, seed=3)
    return jm, params, convert.load_into(pv.KLVae(**CFG), to_numpy(params))


def test_decoder_has_jax_layers(vaes):
    _, params, pm = vaes
    names = pm.decoder.order
    assert names[:3] == ["mid_block_1", "mid_attn_1", "mid_block_2"]
    assert [n for n in names if "upsample" in n] == ["up_3_upsample", "up_2_upsample", "up_1_upsample"]
    assert sum(n.startswith("up_") and "_block_" in n for n in names) == 4 * 3  # 2 + 1 a level
    assert set(params["decoder"]) == set(names) | {"conv_in", "norm_out", "conv_out"}


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_matches_jax(vaes, seed):
    jm, params, pm = vaes
    z = np.random.default_rng(seed).standard_normal((3, 8, 4, 4)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(z), method=jv.KLVae.decode))
    with torch.no_grad():
        got = pm.decode(torch.tensor(z))
    assert got.shape == (3, 3, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)


def test_upsample_is_nearest_then_conv():
    x = torch.arange(8.0).reshape(1, 2, 2, 2)
    up = pv.Upsample(2)
    with torch.no_grad():
        up.conv.weight.zero_()
        up.conv.weight[:, :, 1, 1] = torch.eye(2)
        up.conv.bias.zero_()
        y = up(x)
    want = jax.image.resize(jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), (1, 4, 4, 2), "nearest")
    np.testing.assert_array_equal(y.numpy(), np.asarray(want).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def trained():
    if not (os.path.exists(VAE96) and os.path.exists(CORPUS)):
        pytest.skip("the committed VAE or corpus is not in this checkout")
    tree = convert.load_flat_npz(VAE96)
    return tree, convert.load_into(pv.KLVae(**CFG96), tree)


def test_trained_decoder_reconstructs_corpus_frames_as_jax(trained):
    tree, pm = trained
    frames = corpus_frames((0, 500))
    jm = jv.KLVae(**CFG96)
    mean, _ = jm.apply({"params": tree}, jnp.asarray(frames), method=jv.KLVae.encode)
    want = np.asarray(jm.apply({"params": tree}, mean, method=jv.KLVae.decode))
    with torch.no_grad():
        # the decode alone, on JAX's latents
        got = pm.decode(torch.tensor(np.asarray(mean))).numpy()
        # the port's own reconstruction, its encode's rounding carried through
        own = pm.decode(pm.encode(torch.tensor(frames))[0]).numpy()
    assert got.shape == (2, 3, 96, 96)
    np.testing.assert_allclose(got, want, **FP32_TOL)
    got_db, want_db = psnr(own, frames), psnr(want, frames)
    # the trained VAE reconstructs (pusht_vae96_recon.png is JAX's picture of it)
    assert want_db > 25.0, want_db
    assert abs(got_db - want_db) <= PSNR_DB_TOL, (got_db, want_db)


def test_a_tree_without_the_decoder_is_refused(trained):
    tree, _ = trained
    encoder_only = {k: v for k, v in tree.items() if k not in ("decoder", "post_quant_conv")}
    with pytest.raises(ValueError, match=r"'decoder': \d+, 'post_quant_conv': 2"):
        convert.load_into(pv.KLVae(**CFG96), encoder_only)
