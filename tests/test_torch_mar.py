"""Port of models/mar.py's policy path (patchify, forward_encoder and
forward_decoder in policy_model mode, sample_policy) against the JAX Mar on
the CPU, in fp32, at a small size: 2+2 blocks, d=64, 4 heads, 4x4 latents
per frame (64 tokens). On the CPU the attention takes its plain version,
which has no head-width limit.

Tolerance: FP32_TOL (rtol = atol = 1e-5), the same arithmetic in another
order; the sampled chunk runs under the JAX head's own draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests._torch_parity import (
    FP32_TOL,
    assert_int8_chunks,
    assert_int8_parity,
    head_draws,
    init_shapes,
    random_params,
    to_numpy,
)
from unified_video_action_tpu.models import mar as jm_
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.models import mar as pm_
from unified_video_action_tpu_torch.models.transformer import QuantLinear

SMALL = dict(
    img_size=32, vae_stride=8, vae_embed_dim=8,
    encoder_embed_dim=64, encoder_depth=2, encoder_num_heads=4,
    decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4,
    diffloss_d=1, diffloss_w=16,
    diffloss_act_d=2, diffloss_act_w=32, act_diff_testing_steps="ddim10",
)


@pytest.fixture(scope="module")
def mars():
    jcfg = jm_.MarConfig(**SMALL, attn_dropout=0.0, proj_dropout=0.0)
    jm = jm_.Mar(jcfg)
    lat = jnp.zeros((1, 4, 8, 4, 4))
    shapes = init_shapes(jm, lat, lat, jax.random.PRNGKey(0), jnp.zeros((1, 16, 2)),
                         method=jm_.Mar.init_forward)
    params = random_params(shapes, seed=0)
    pm = pm_.Mar(pm_.MarConfig(**SMALL))
    convert.load_into(pm, to_numpy(params))
    return jm, params, pm


def _latents(B=2, seed=1):
    return np.random.default_rng(seed).standard_normal((B, 4, 8, 4, 4)).astype(np.float32)


@pytest.mark.parametrize("p", [1, 2])
def test_patchify_matches(p):
    x = np.random.default_rng(p).standard_normal((3, 8, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        pm_.patchify(torch.tensor(x), p).numpy(), np.asarray(jm_.patchify(jnp.asarray(x), p))
    )


def test_model_sizes_and_config_match():
    assert pm_.MODEL_SIZES == jm_.MODEL_SIZES
    j = jm_.MarConfig(img_size=96)
    p = pm_.MarConfig(img_size=96)
    for name in ("seq_hw", "seq_len", "token_embed_dim", "total_tokens"):
        assert getattr(p, name) == getattr(j, name), name
    for name in (f.name for f in dataclasses.fields(pm_.MarConfig)):
        assert getattr(p, name) == getattr(j, name), name


def test_encoder_decoder_match_jax(mars):
    jm, params, pm = mars
    c = pm.cfg
    lat = _latents()
    B, T = lat.shape[:2]
    tokens = np.asarray(jm_.patchify(jnp.asarray(lat.reshape(B * T, 8, 4, 4)), 1)).reshape(B, T, 16, 8)

    def jax_fwd(mdl, tok):
        h = mdl.forward_encoder(jnp.zeros_like(tok), jnp.ones(tok.shape[:3]), tok, "policy_model")
        return h, mdl.forward_decoder(h)

    h_want, z_want = jm.apply({"params": params}, jnp.asarray(tokens), method=jax_fwd)
    with torch.no_grad():
        h = pm.forward_encoder(torch.tensor(tokens))
        z = pm.forward_decoder(h)
    assert z.shape == (B, c.total_tokens, c.decoder_embed_dim)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **FP32_TOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_want), **FP32_TOL)


def test_sample_policy_matches_jax(mars):
    jm, params, pm = mars
    lat = _latents(B=3, seed=2)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(lat), key, temperature=0.95,
                               method=jm_.Mar.sample_policy))
    init, per_step = head_draws(key, 3 * 16, 2, pm.diffactloss.num_steps)
    with torch.no_grad():
        got = pm.sample_policy(torch.tensor(lat), torch.tensor(init), torch.tensor(per_step),
                               temperature=0.95).numpy()
    assert got.shape == (3, 16, 2)
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_port_holds_every_policy_leaf_of_the_jax_tree(mars):
    _, params, pm = mars
    flat = convert.flatten_tree(to_numpy(params))
    # the video head (diffloss) too, since the training slice
    assert convert.flax_layout_shapes(pm) == {p: v.shape for p, v in flat.items()}


# W8A8 (MarConfig.quant): both stacks and the action denoiser int8, the
# decoder_embed, z_proj* layers and the pool float, as in JAX. The JAX model
# runs under jax.jit (as the serving program runs it); the int8 parity of
# tests/_torch_parity.py holds the port to JAX's int8 model against the gap
# between JAX's int8 and float models on the same latents and noise.


@pytest.fixture(scope="module")
def quant_mars(mars):
    jm, params, _ = mars
    jq = jm_.Mar(dataclasses.replace(jm.cfg, quant=True))
    pq = pm_.Mar(pm_.MarConfig(**SMALL, quant=True))
    convert.load_into(pq, to_numpy(params))
    return jm, jq, params, pq


def test_quant_encoder_decoder_match_jax(quant_mars):
    jm, jq, params, pq = quant_mars
    lat = _latents(B=3, seed=5)
    B, T = lat.shape[:2]
    tokens = np.asarray(jm_.patchify(jnp.asarray(lat.reshape(B * T, 8, 4, 4)), 1)).reshape(B, T, 16, 8)

    def jax_fwd(mdl, tok):
        return mdl.forward_decoder(
            mdl.forward_encoder(jnp.zeros_like(tok), jnp.ones(tok.shape[:3]), tok, "policy_model"))

    run = lambda m: np.asarray(jax.jit(lambda p, t: m.apply({"params": p}, t, method=jax_fwd))(
        params, jnp.asarray(tokens)))
    with torch.no_grad():
        z = pq.forward_decoder(pq.forward_encoder(torch.tensor(tokens))).numpy()
    assert_int8_parity(z, run(jq), run(jm))


def test_quant_sample_policy_matches_jax(quant_mars):
    # sampled chunks (normalized actions): tests/_torch_parity.py's chunk
    # parity; measured 4 of 8 chunks within 2e-6, the others 0.63e-3 to
    # 3.6e-3 apart, against int8-vs-float gaps of 3.8e-3 to 1.2e-2
    jm, jq, params, pq = quant_mars
    lat = _latents(B=8, seed=6)
    key = jax.random.PRNGKey(8)
    run = lambda m: np.asarray(jax.jit(lambda p, x, k: m.apply(
        {"params": p}, x, k, temperature=0.95, method=jm_.Mar.sample_policy))(
            params, jnp.asarray(lat), key))
    init, per_step = head_draws(key, 8 * 16, 2, pq.diffactloss.num_steps)
    with torch.no_grad():
        got = pq.sample_policy(torch.tensor(lat), torch.tensor(init), torch.tensor(per_step),
                               temperature=0.95).numpy()
    assert got.shape == (8, 16, 2)
    assert_int8_chunks(got, run(jq), run(jm), min_exact=2)


def test_quant_reaches_the_layers_jax_quantizes(quant_mars):
    *_, pq = quant_mars
    quant = {n for n, m in pq.named_modules() if isinstance(m, QuantLinear)}
    c = pq.cfg
    blocks = [f"{s}.block_{i}" for s, d in (("encoder_blocks", c.encoder_depth),
                                            ("decoder_blocks", c.decoder_depth)) for i in range(d)]
    want = {f"{b}.{l}" for b in blocks for l in ("attn.qkv", "attn.proj", "mlp_fc1", "mlp_fc2")}
    for net, depth in (("diffactloss.net", c.diffloss_act_d), ("diffloss.net", c.diffloss_d)):
        want |= {f"{net}.input_proj", f"{net}.cond_embed", f"{net}.final.ada_mod"}
        want |= {f"{net}.block_{i}.{l}" for i in range(depth) for l in ("ada_mod", "fc1", "fc2")}
    assert quant == want
    assert all(isinstance(getattr(pq, n), nn.Linear) for n in
               ("z_proj_cond", "z_proj", "decoder_embed", "proj_cond_x_layer"))
