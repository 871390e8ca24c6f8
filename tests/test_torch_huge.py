"""mar_huge on the port, head dimension 80: the two configurations
(``config.PUSHT_HUGE96``, 96 px and 144 tokens, and ``config.PUSHT_HUGE256``,
256 px and 1024 tokens) against the JAX package's ``load_config`` with
``model_size=mar_huge``; the port's full-width mar_huge modules against
JAX's parameter tree leaf by leaf (built on the ``meta`` device: no 876 M
parameters are allocated); the MAR's policy_model pass, ``predict_action``
and the deployed tier's ``predict_action_cached`` at D = 80 against JAX's
on the CPU, in fp32; and the W8A8 layer at mar_huge's K = 5120 (the fc2
input) against JAX's ``w8a8_matmul``.

Sizes of the parity runs: head dimension 80 as 2 heads of d = 160, 2+2
blocks, a KL-16 VAE with ``ch`` 32, a 2-block denoiser of width 32, at 96 px
(6 x 6 latents a frame, 144 tokens) and at 256 px (16 x 16, 1024 tokens). On
the CPU the attention is the plain version; the kernels at D = 80 are held
on the card (tests/test_torch_attention_cuda.py, chip_smoke.py).

Tolerances: the MAR's outputs FP32_TOL (rtol = atol = 1e-5, the same
arithmetic in another order); actions as tests/test_torch_policy.py's, atol
1e-4 in normalized action units and rtol 1e-5 (the sampler's first steps
amplify float32 rounding differences of the denoiser by up to about 2e4
before x0 is clipped), also through the cached entry point in float; the
latent caches atol 1e-5, as tests/test_torch_policy.py holds them; the
deployed tier's int8 actions by the chunk parity of tests/_torch_parity.py
(its test says why with min_exact=0, as tests/test_torch_flagship.py); the
W8A8 layer bit-equal, as tests/test_torch_quant.py holds it.
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
    FP32_TOL,
    TINY_POLICY_KW,
    assert_int8_chunks,
    assert_same_run_config,
    policy_draws,
    random_params,
    to_numpy,
)
from unified_video_action_tpu.config import load_config
from unified_video_action_tpu.data.normalizer import LinearNormalizer as JaxNormalizer
from unified_video_action_tpu.models import mar as jm_
from unified_video_action_tpu.ops.int8_mm import w8a8_matmul
from unified_video_action_tpu.ops.quant import quantize_weight
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch import config, convert
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
from unified_video_action_tpu_torch.models.transformer import QuantLinear
from unified_video_action_tpu_torch.ops import attention as attention_ops
from unified_video_action_tpu_torch.ops import int8_mm as int8_ops
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMALIZER = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest", "normalizer.npz")
NORMALIZED_ATOL = 1e-4
HUGE = "model.policy.autoregressive_model_params.model_size=mar_huge"


def _jax_cfg(name):
    if name == "PUSHT_HUGE96":
        return load_config("uva_pusht_small",
                           ["model.policy.action_model_params.predict_action=true", HUGE]).to_dict()
    return load_config("uva_pusht", BENCH_PARITY_OVERRIDES + [HUGE]).to_dict()


def test_pusht_huge96_is_the_jax_config_at_mar_huge():
    # uva_pusht_small.yaml with the action head on (as PUSHT_SMALL96) and mar_huge
    assert_same_run_config(config.PUSHT_HUGE96, _jax_cfg("PUSHT_HUGE96"))


def test_pusht_huge256_is_the_jax_config_at_mar_huge():
    # uva_pusht.yaml with bench.py's parity overrides (as PUSHT_256) and mar_huge
    assert_same_run_config(config.PUSHT_HUGE256, _jax_cfg("PUSHT_HUGE256"),
                           as_str=("act_diff_testing_steps",))


@pytest.mark.parametrize("name,img,tokens,kernel,ch,vae_chunk", [
    ("PUSHT_HUGE96", 96, 144, "attention_wgmma", 64, 0),
    ("PUSHT_HUGE256", 256, 1024, "attention_wgmma_online", 128, 64),
])
def test_the_huge_configs_build_mar_huge_at_head_dim_80(name, img, tokens, kernel, ch, vae_chunk):
    policy = UnifiedVideoActionPolicy.from_cfg(getattr(config, name), device="meta")
    c = policy.mar_cfg
    assert (c.encoder_embed_dim, c.encoder_depth, c.encoder_num_heads) == (1280, 20, 16)
    assert (c.decoder_embed_dim, c.decoder_depth, c.decoder_num_heads) == (1280, 20, 16)
    assert c.encoder_embed_dim // c.encoder_num_heads == 80
    assert (c.img_size, c.total_tokens, c.attention_tokens) == (img, tokens, tokens)
    assert (c.diffloss_act_d, c.diffloss_act_w) == (6, 1024)
    assert policy.dtype == torch.bfloat16 and policy.mar.diffactloss.num_steps == 100
    assert policy.vae.encoder.conv_in.out_channels == ch and policy.vae_encode_chunk == vae_chunk
    # the action head's conditioning width is the decoder's
    assert policy.mar.diffactloss.pool.conv.in_channels == 1280
    # every ViT block at both serving batches goes to the D = 80 instance of one kernel
    for batch in (1, 128):
        plan = attention_ops.attention_plan(batch, tokens, 16, 80, policy.dtype)
        assert (plan.kernel, plan.head_dim) == (kernel, 80)


def _jax_shapes(name):
    cfg = _jax_cfg(name)
    kw = {k: v for k, v in cfg["model"]["policy"].items() if k != "_target_"}
    kw["vae_model_params"] = dict(kw["vae_model_params"], autoencoder_path=None)
    jp = JaxPolicy(**kw, task_name=cfg["task"]["name"])
    shapes = jax.eval_shape(jp.init_params, jax.random.PRNGKey(0))
    return {k: {p: tuple(s.shape) for p, s in convert.flatten_tree(shapes[k]).items()}
            for k in ("mar", "vae")}


@pytest.mark.parametrize("name", ["PUSHT_HUGE96", "PUSHT_HUGE256"])
def test_mar_huge_holds_the_jax_tree_leaf_by_leaf(name):
    want = _jax_shapes(name)
    policy = UnifiedVideoActionPolicy.from_cfg(getattr(config, name), device="meta")
    # the bridge maps every leaf, the VAE decoder's too, onto a port
    # parameter of its shape, and sets every port parameter
    mar_plan = convert.plan(want["mar"], convert.module_shapes(policy.mar))
    vae_plan = convert.plan(want["vae"], convert.module_shapes(policy.vae))
    assert len(mar_plan) == len(policy.mar.state_dict())
    assert len(vae_plan) == len(policy.vae.state_dict())
    # the port's flax layout is JAX's tree, leaf names and shapes, the video head's too
    assert convert.flax_layout_shapes(policy.mar) == want["mar"]
    n_jax = sum(int(np.prod(s)) for s in want["mar"].values())
    assert n_jax == sum(p.numel() for p in policy.mar.parameters())
    assert 910_000_000 < n_jax < 915_000_000  # MAR, action head and video head (36 M)


def test_mar_huge_int8_tier_maps_every_dense_kernel():
    want = _jax_shapes("PUSHT_HUGE96")["mar"]
    policy = UnifiedVideoActionPolicy.from_cfg(config.PUSHT_HUGE96, device="meta",
                                               serving_quant="int8", obs_codec="yuv420")
    mar_plan = convert.plan(want, convert.module_shapes(policy.mar))
    assert len(mar_plan) == len(policy.mar.state_dict())
    n_quant = sum(1 for _, change in mar_plan.values() if change == "quant")
    assert n_quant == 40 * 4 + 2 * (6 * 3 + 3)
    quant = [m for m in policy.mar.modules() if isinstance(m, QuantLinear)]
    # mar_huge's fc2 reads 5120 columns: the vector quantize kernel's widest instance
    widths = {m.weight_q.shape[1] for m in quant}
    assert 5120 in widths and int8_ops.quantize_plan(5120, torch.bfloat16).per_lane == 20


# ------------------------------------------------- parity at D = 80, narrow

def _d80_kwargs(img_size, steps):
    kw = copy.deepcopy(TINY_POLICY_KW)
    kw["vae_model_params"]["ddconfig"] = {"vae_embed_dim": 16, "ch_mult": [1, 1, 2, 2, 4], "ch": 32}
    kw["autoregressive_model_params"].update(
        img_size=img_size, vae_stride=16, vae_embed_dim=16, act_diff_testing_steps=steps,
        encoder_embed_dim=160, encoder_num_heads=2, decoder_embed_dim=160, decoder_num_heads=2)
    return kw


def _pair(img_size, steps, **deployed):
    kw = _d80_kwargs(img_size, steps)
    jp = JaxPolicy(**kw, **deployed)
    jp.set_normalizer(JaxNormalizer.load(NORMALIZER))
    params = random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=0)
    port = UnifiedVideoActionPolicy(**kw, **deployed, device="cpu")
    port.load_params(to_numpy(params["mar"]), to_numpy(params["vae"]))
    port.set_normalizer(LinearNormalizer.load(NORMALIZER))
    c = port.mar_cfg
    assert c.encoder_embed_dim // c.encoder_num_heads == 80
    return jp, params, port


@pytest.mark.parametrize("img_size,tokens", [(96, 144), (256, 1024)])
def test_policy_model_pass_matches_jax_at_head_dim_80(img_size, tokens):
    jp, params, port = _pair(img_size, "ddim10")
    c = port.mar_cfg
    assert c.total_tokens == tokens
    B, h = 2, c.seq_hw
    lat = np.random.default_rng(img_size).standard_normal((B, 4, 16, h, h)).astype(np.float32)
    tok = np.asarray(jm_.patchify(jnp.asarray(lat.reshape(B * 4, 16, h, h)), 1)).reshape(
        B, 4, h * h, 16)

    def jax_fwd(mdl, t):
        h_enc = mdl.forward_encoder(jnp.zeros_like(t), jnp.ones(t.shape[:3]), t, "policy_model")
        return mdl.forward_decoder(h_enc)

    want = jp.mar.apply({"params": params["mar"]}, jnp.asarray(tok), method=jax_fwd)
    with torch.no_grad():
        got = port.mar.policy_latents(torch.tensor(lat))
    assert got.shape == (B, tokens, 160)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("img_size,steps", [(96, "100"), (256, "ddim10")])
def test_predict_action_matches_jax_at_head_dim_80(img_size, steps):
    jp, params, port = _pair(img_size, steps)
    B = 2
    obs = {"image": np.random.default_rng(3).integers(0, 256, (B, 16, 3, 96, 96), dtype=np.uint8)}
    key = jax.random.PRNGKey(17)
    want = jp.predict_action(params, obs, key)
    got = port.predict_action(obs, noise=policy_draws(key, port.noise_shapes(B)))
    assert got["action_pred"].shape == want["action_pred"].shape == (B, 16, 2)
    np.testing.assert_array_equal(got["action"], got["action_pred"][:, :8])
    scale = float(port.normalizer["action"].scale.min())
    np.testing.assert_allclose(got["action_pred"], want["action_pred"], rtol=1e-5,
                               atol=NORMALIZED_ATOL / scale)


def _cached_windows(B, seed):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (B, 16, 3, 96, 96), dtype=np.uint8)} for _ in range(2)]


def test_predict_action_cached_matches_jax_at_head_dim_80():
    # the cached entry point in float (ddim10 + yuv420): a full call on a
    # 16-frame window, then a cached call (n_shift=8) that encodes 2 new
    # frames and reuses 2 latents, each held at the float tolerance
    jp, params, port = _pair(96, "ddim10", obs_codec="yuv420")
    B = 4
    scale = float(port.normalizer["action"].scale.min())
    j_cache = p_cache = None
    for obs, key in zip(_cached_windows(B, 19), (jax.random.PRNGKey(23), jax.random.PRNGKey(24))):
        want, j_new = jp.predict_action_cached(params, obs, key, cache=j_cache)
        _, new_positions = port.cache_plan(16, p_cache, 8)
        got, p_new = port.predict_action_cached(
            obs, cache=p_cache, noise=policy_draws(key, port.noise_shapes(B, len(new_positions))))
        assert got["action_pred"].shape == (B, 16, 2) and p_new.shape == (B, 4, 16, 6, 6)
        np.testing.assert_allclose(p_new.numpy(), np.asarray(j_new), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["action_pred"], want["action_pred"], rtol=1e-5,
                                   atol=NORMALIZED_ATOL / scale)
        j_cache, p_cache = j_new, p_new


def test_deployed_predict_action_cached_matches_jax_at_head_dim_80():
    # The deployed tier (ddim10 + W8A8 + yuv420) at 96 px, full then cached
    # call; JAX's float program on the same inputs gives the int8-vs-float
    # gap. The caches are held at atol 1e-5. The actions by the chunk parity
    # of tests/_torch_parity.py with min_exact=0, as tests/test_torch_flagship.py
    # holds them: over 144 tokens of d = 160 a float rounding difference
    # crosses an int8 step in every chunk (measured: 0 of 8 chunks within
    # 1e-4, each chunk's mean |d| 0.0026-0.0050 against int8-vs-float gaps
    # of 0.0037-0.013), so the mean over the chunks must stay below the mean
    # gap, which a float implementation, or another quantization, does not.
    jq, params, port = _pair(96, "ddim10", serving_quant="int8", obs_codec="yuv420")
    jf = JaxPolicy(**_d80_kwargs(96, "ddim10"), obs_codec="yuv420")
    jf.set_normalizer(JaxNormalizer.load(NORMALIZER))
    B = 8
    scale = float(port.normalizer["action"].scale.min())
    j_cache = f_cache = p_cache = None
    for obs, key in zip(_cached_windows(B, 19), (jax.random.PRNGKey(23), jax.random.PRNGKey(24))):
        want, j_new = jq.predict_action_cached(params, obs, key, cache=j_cache)
        want_float, f_cache = jf.predict_action_cached(params, obs, key, cache=f_cache)
        _, new_positions = port.cache_plan(16, p_cache, 8)
        noise = policy_draws(key, port.noise_shapes(B, len(new_positions)))
        got, p_new = port.predict_action_cached(obs, cache=p_cache, noise=noise)
        assert got["action_pred"].shape == (B, 16, 2) and p_new.shape == (B, 4, 16, 6, 6)
        np.testing.assert_allclose(p_new.numpy(), np.asarray(j_new), rtol=0, atol=1e-5)
        assert_int8_chunks(got["action_pred"] * scale, want["action_pred"] * scale,
                           want_float["action_pred"] * scale, min_exact=0)
        j_cache, p_cache = j_new, p_new


# ------------------------------------------------------ W8A8 at K = 5120

@pytest.mark.parametrize("K,N", [(1280, 5120), (5120, 1280)])
def test_quant_linear_at_mar_huge_width_is_bit_equal_to_jax(K, N):
    # mar_huge's mlp_fc1 (1280 -> 5120) and mlp_fc2 (5120 -> 1280, whose
    # input takes the vector quantize kernel's per_lane 20 instance on the
    # card): the port's QuantLinear, loaded through the bridge, against JAX's
    # w8a8_matmul by XLA and by the Pallas kernel in interpret mode, plus the
    # bias in one float32 add (in one jit XLA fuses the rescale and the add
    # into an FMA, which rounds once less); an outlier row and an all-zero row
    rng = np.random.default_rng(K)
    x = rng.standard_normal((6, K)).astype(np.float32)
    x[2] *= 50.0
    x[4] = 0.0
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(N)).astype(np.float32)
    jq = jax.jit(quantize_weight)(jnp.asarray(w))
    args = (jnp.asarray(x), jq["kernel_q"], jq["scale"])
    want_xla = np.asarray(jax.jit(w8a8_matmul)(*args)) + b
    want_pallas = np.asarray(jax.jit(
        lambda x, k, s: w8a8_matmul(x, k, s, backend="pallas", interpret=True))(*args)) + b
    layer = convert.load_into(QuantLinear(K, N), {"kernel": w, "bias": b})
    np.testing.assert_array_equal(layer.weight_q.numpy(), np.asarray(jq["kernel_q"]).T)
    np.testing.assert_array_equal(layer.w_scale.numpy(), np.asarray(jq["scale"]))
    if K == 5120:
        assert int8_ops.quantize_plan(K, torch.bfloat16) == int8_ops.QuantPlan("vector", 20)
    with torch.no_grad():
        got = layer(torch.tensor(x)).numpy()
    assert got.shape == (6, N)
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)
