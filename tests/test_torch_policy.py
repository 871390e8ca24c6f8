"""The serving slice as a whole: the port's UnifiedVideoActionPolicy
.predict_action_frames (and, further down, the deployed tier's
.predict_action_cached) against the JAX policy's predict program on the CPU, in
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

from tests._torch_parity import (
    FP32_TOL,
    TINY_POLICY_KW,
    assert_int8_chunks,
    policy_draws,
    random_params,
    to_numpy,
)
from unified_video_action_tpu.data.normalizer import LinearNormalizer as JaxNormalizer
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
from unified_video_action_tpu_torch.models.transformer import QuantLinear
from unified_video_action_tpu_torch.ops import attention as attention_ops
from unified_video_action_tpu_torch.ops import int8_mm as int8_ops
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.utils.obs_codec import encode_yuv420

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
    got = port.predict_action_frames(torch.tensor(frames), noise=noise)
    assert got.shape == (3, 16, 2) and got.dtype == torch.float32
    assert port.mar.diffactloss.num_steps == (100 if steps == "100" else 10)
    scale = float(port.normalizer["action"].scale.min())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=NORMALIZED_ATOL / scale)


def test_predict_action_draws_from_a_generator():
    port = UnifiedVideoActionPolicy(**TINY_POLICY_KW, device="cpu")
    frames = torch.zeros(2, 4, 3, 32, 32, dtype=torch.uint8)
    a = port.predict_action_frames(frames, generator=torch.Generator().manual_seed(0))
    b = port.predict_action_frames(frames, generator=torch.Generator().manual_seed(0))
    c = port.predict_action_frames(frames, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_attention_routes_agree_on_the_cpu():
    port = UnifiedVideoActionPolicy(**TINY_POLICY_KW, device="cpu")
    frames = torch.randint(0, 256, (2, 4, 3, 32, 32), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    noise = port.sample_noise(2, torch.Generator().manual_seed(3))
    before = dict(attention_ops.launch_count)
    a = port.predict_action_frames(frames, noise=noise)
    port.set_attn_impl("plain")
    b = port.predict_action_frames(frames, noise=noise)
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


@pytest.mark.parametrize("option", [
    {"task_name": "libero10"},
    {"action_model_params": {"predict_action": True, "act_model_type": "conv_ori"}},
    {"action_model_params": {"predict_action": True, "act_model_type": "conv2"}},
])
def test_unported_options_are_refused(option):
    """What the port still refuses: the libero tasks and the action pools
    other than conv_fc (the conditioning streams that this test refused
    before are ported: tests/test_torch_mar_streams.py, test_torch_umi_policy.py)."""
    with pytest.raises(NotImplementedError):
        UnifiedVideoActionPolicy(**{**TINY_POLICY_KW, **option}, device="cpu")


def test_unknown_options_and_bad_noise_are_refused():
    with pytest.raises(TypeError, match="bogus"):
        UnifiedVideoActionPolicy(**TINY_POLICY_KW, bogus=1, device="cpu")
    port = UnifiedVideoActionPolicy(**TINY_POLICY_KW, device="cpu")
    noise = port.sample_noise(1)
    with pytest.raises(ValueError, match="noise"):
        port.predict_action_frames(torch.zeros(2, 4, 3, 32, 32, dtype=torch.uint8), noise=noise)
    with pytest.raises(ValueError, match="frames"):
        port.predict_action_frames(torch.zeros(2, 3, 3, 32, 32, dtype=torch.uint8), noise=noise)


# The deployed tier: ddim10 + serving_quant="int8" + obs_codec="yuv420",
# served through predict_action_cached (policy.py:453-568): a full call on a
# 16-frame window, then a cached call with n_shift=8 that encodes 2 new
# frames and reuses 2 cached latents.
#
# Tolerances.
# - The returned caches (frame selection, YUV420 codec, VAE encode, reuse):
#   atol 1e-5, the fp32 VAE's summation order (measured 1.4e-6).
# - The actions: the chunk parity of tests/_torch_parity.py, in normalized
#   units. The port's float parts (attention, LayerNorm, GELU, convolutions)
#   round in another order than XLA's, so now and then an activation lands
#   on the other side of an int8 step (the first one here: one row of
#   encoder block 0's attention projection), and that chunk then moves
#   about as far as quantization itself moves it. Measured: 3 and 2 of 8
#   chunks within 5e-6, against int8-vs-float gaps of at least 3.5e-3 for
#   every chunk, and a mean over all chunks of 0.22 and 0.55 of the mean gap.
DEPLOYED = dict(serving_quant="int8", obs_codec="yuv420")
CACHED_B = 8


def _deployed_pair(steps="ddim10"):
    kw = _kwargs(steps)
    normalizer = os.path.join(LATEST, "normalizer.npz")
    jq, jf = JaxPolicy(**kw, **DEPLOYED), JaxPolicy(**kw, obs_codec="yuv420")
    for jp in (jq, jf):
        jp.set_normalizer(JaxNormalizer.load(normalizer))
    params = random_params(jax.eval_shape(jq.init_params, jax.random.PRNGKey(0)), seed=0)
    port = UnifiedVideoActionPolicy(**kw, **DEPLOYED, device="cpu")
    port.load_params(to_numpy(params["mar"]), to_numpy(params["vae"]))
    port.set_normalizer(LinearNormalizer.load(normalizer))
    return jq, jf, params, port


def test_predict_action_cached_matches_jax():
    jq, jf, params, port = _deployed_pair()
    rng = np.random.default_rng(1)
    windows = [{"image": rng.integers(0, 256, (CACHED_B, 16, 3, 32, 32), dtype=np.uint8)}
               for _ in range(2)]
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    scale = float(port.normalizer["action"].scale.min())
    j_cache = f_cache = p_cache = None
    for call, (obs, key) in enumerate(zip(windows, keys)):
        want, j_new = jq.predict_action_cached(params, obs, key, cache=j_cache)
        want_float, f_cache = jf.predict_action_cached(params, obs, key, cache=f_cache)
        reuse_from, new_positions = port.cache_plan(16, p_cache, 8)
        assert (reuse_from, new_positions) == (([], [3, 7, 11, 15]), ([2, 3], [11, 15]))[call]
        noise = policy_draws(key, port.noise_shapes(CACHED_B, len(new_positions)))
        got, p_new = port.predict_action_cached(obs, cache=p_cache, noise=noise)
        assert got["action_pred"].shape == (CACHED_B, 16, 2)
        np.testing.assert_array_equal(got["action"], got["action_pred"][:, :8])
        assert p_new.shape == (CACHED_B, 4, 8, 4, 4) and p_new.dtype == torch.float32
        np.testing.assert_allclose(p_new.numpy(), np.asarray(j_new), rtol=0, atol=1e-5)
        if p_cache is not None:  # the reused slots are the previous cache's last two
            assert torch.equal(p_new[:, :2], p_cache[:, 2:])
        assert_int8_chunks(got["action_pred"] * scale, want["action_pred"] * scale,
                           want_float["action_pred"] * scale, min_exact=2)
        j_cache, p_cache = j_new, p_new


@pytest.mark.parametrize("obs_codec", [None, "yuv420"])
def test_cached_without_a_cache_equals_uncached(obs_codec):
    # tests/test_latent_cache.py:79-89 for the port: the same selected frames,
    # the same noise, the same arithmetic, bit for bit
    kw = dict(TINY_POLICY_KW, serving_quant="int8", obs_codec=obs_codec)
    port = UnifiedVideoActionPolicy(**kw, device="cpu")
    obs = {"image": np.random.default_rng(5).random((2, 16, 3, 32, 32)).astype(np.float32)}
    noise = port.sample_noise(2, torch.Generator().manual_seed(9))
    cached, cache = port.predict_action_cached(obs, cache=None, noise=noise)
    frames = np.round(obs["image"][:, [3, 7, 11, 15]] * 255.0).astype(np.uint8)
    if obs_codec:
        frames = encode_yuv420(frames)
    ref = port.predict_action_frames(torch.from_numpy(frames), noise=noise)
    np.testing.assert_array_equal(cached["action_pred"], ref.numpy())
    assert cache.shape == (2, 4, 8, 4, 4)


def test_deployed_options_are_checked():
    for bad in ({"serving_quant": "int4"}, {"obs_codec": "jpeg"}):
        with pytest.raises(ValueError):
            UnifiedVideoActionPolicy(**TINY_POLICY_KW, **bad, device="cpu")
    port = UnifiedVideoActionPolicy(**TINY_POLICY_KW, serving_quant="none", obs_codec="raw",
                                    device="cpu")
    assert port.serving_quant is None and port.obs_codec is None
    assert not any(isinstance(m, QuantLinear) for m in port.mar.modules())
    port = UnifiedVideoActionPolicy(**TINY_POLICY_KW, **DEPLOYED, device="cpu")
    with pytest.raises(ValueError, match="noise"):  # a cached call's VAE noise covers its new frames
        port.predict_action_cached({"image": np.zeros((1, 16, 3, 32, 32), np.uint8)},
                                   noise=port.sample_noise(1, n_new=2))
    with pytest.raises(ValueError, match="frames"):
        port.predict_action_frames(torch.zeros(1, 3, 24, dtype=torch.uint8))


def test_int8_routes_agree_on_the_cpu_and_every_quant_layer_runs():
    port = UnifiedVideoActionPolicy(**_kwargs("ddim10"), **DEPLOYED, device="cpu")
    c = port.mar_cfg
    calls = []
    for m in port.mar.modules():
        if isinstance(m, QuantLinear):
            m.register_forward_hook(lambda *a: calls.append(1))
    frames = torch.from_numpy(encode_yuv420(
        np.random.default_rng(2).integers(0, 256, (2, 4, 3, 32, 32), dtype=np.uint8)))
    noise = port.sample_noise(2, torch.Generator().manual_seed(3))
    before = dict(int8_ops.launch_count)
    a = port.predict_action_frames(frames, noise=noise)
    # 4 per ViT block, and per sampler step the denoiser's input_proj,
    # cond_embed, 3 per AdaLN block and the final ada_mod
    assert len(calls) == 4 * (c.encoder_depth + c.decoder_depth) + 10 * (3 * c.diffloss_act_d + 3)
    port.set_int8_impl("plain")
    b = port.predict_action_frames(frames, noise=noise)
    assert int8_ops.launch_count == before  # CPU tensors never launch the kernels
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flagship_deployed_tier_builds():
    policy = UnifiedVideoActionPolicy.from_run_config(
        os.path.join(LATEST, "meta.json"), device="meta", **DEPLOYED)
    quant = [m for m in policy.mar.modules() if isinstance(m, QuantLinear)]
    # the stacks and both denoisers (the video head's is held, not served)
    assert len(quant) == 24 * 4 + 2 * (6 * 3 + 3)
    assert all(m.w_scale.dtype == m.bias.dtype == torch.float32 for m in quant)
    assert policy.noise_shapes(1, 2)["vae"] == (2, 16, 6, 6)


@pytest.mark.parametrize("n_frames", [8, 7])
def test_vae_encode_chunk_equals_the_unchunked_encode(n_frames):
    # chunks of 3: two full chunks and a remainder of 2 or 1 frames, encoded
    # as one more call. The chunked encode equals the unchunked one to float32
    # rounding: a convolution library picks its algorithm by batch size (the
    # port at 8 frames bit-equal, at 7 up to 9.5e-7 off through the 1-frame
    # tail; JAX's chunked _encode_frames, lax.map over the divisible prefix
    # then the tail, up to 1.3e-6 off its unchunked encode). Held to FP32_TOL,
    # and the port's chunked encode to JAX's.
    kw = _kwargs("ddim10")
    rng = np.random.default_rng(4)
    frames = rng.uniform(-1, 1, (n_frames, 1, 3, 32, 32)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jp, jc = JaxPolicy(**kw), JaxPolicy(**kw, vae_encode_chunk=3)
    params = random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=0)
    want = np.asarray(jp._encode_frames(params["vae"], jnp.asarray(frames), key))
    np.testing.assert_allclose(np.asarray(jc._encode_frames(params["vae"], jnp.asarray(frames), key)),
                               want, **FP32_TOL)

    port = UnifiedVideoActionPolicy(**kw, vae_encode_chunk=3, device="cpu")
    port.load_params(to_numpy(params["mar"]), to_numpy(params["vae"]))
    assert port.vae_encode_chunk == 3
    noise = torch.tensor(np.asarray(jax.random.normal(key, (n_frames, 8, 4, 4))))  # as sample_posterior draws
    calls = []
    encode = port.vae.encode
    port.vae.encode = lambda x: (calls.append(x.shape[0]), encode(x))[1]
    chunked = port._encode_frames(torch.from_numpy(frames), noise)
    assert calls == [3, 3, 2] if n_frames == 8 else calls == [3, 3, 1]
    port.vae_encode_chunk = 0
    np.testing.assert_allclose(chunked.numpy(),
                               port._encode_frames(torch.from_numpy(frames), noise).numpy(), **FP32_TOL)
    np.testing.assert_allclose(chunked.numpy(), want, **FP32_TOL)


def test_async_halves_equal_the_host_entry_points():
    port = UnifiedVideoActionPolicy(**_kwargs("ddim10"), **DEPLOYED, device="cpu")
    obs = {"image": np.random.default_rng(7).random((2, 16, 3, 32, 32)).astype(np.float32)}
    noise = port.sample_noise(2, torch.Generator().manual_seed(8))
    nact = port.predict_action_async(obs, noise=noise)
    assert isinstance(nact, torch.Tensor) and nact.shape == (2, 16, 2)
    np.testing.assert_array_equal(nact.cpu().numpy(), port.predict_action(obs, noise=noise)["action_pred"])

    cache = None
    for n_new in (4, 2):
        noise = port.sample_noise(2, torch.Generator().manual_seed(9 + n_new), n_new=n_new)
        nact, cond = port.predict_action_cached_async(obs, cache=cache, noise=noise)
        result, cond_sync = port.predict_action_cached(obs, cache=cache, noise=noise)
        np.testing.assert_array_equal(nact.cpu().numpy(), result["action_pred"])
        np.testing.assert_array_equal(result["action"], result["action_pred"][:, :8])
        assert torch.equal(cond, cond_sync)
        cache = cond
