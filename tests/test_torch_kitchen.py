"""mar_small on the port: the two single-chip configurations (``config.
PUSHT_SMALL96``, PushT at 96 px, and ``config.KITCHEN_SMALL128``, the
language-conditioned kitchen model at 128 px) against the JAX package's
``load_config``, the MAR's 64-token text buffer against JAX's
``forward_encoder``/``forward_decoder`` (``mar.py:449-495``) with a goal and
without one, and the kitchen policy's obs-dict ``predict_action`` and
``predict_action_cached`` with a goal string against JAX's, on the CPU in
fp32.

Sizes: mar_small's head dimension of 128 with 2 heads of d = 256 and 1+1 or
2+2 blocks, 4x4 latents per frame (64 frame tokens, 128 with the text
buffer), a 2-block denoiser of width 32. On the CPU the attention is the
plain version; the kernels at D = 128 are held on the card
(tests/test_torch_attention_cuda.py, chip_smoke.py).

Tolerances: the MAR's outputs FP32_TOL (rtol = atol = 1e-5, the same
arithmetic in another order); actions as tests/test_torch_policy.py's, atol
1e-4 in normalized action units and rtol 1e-5 (the sampler's first steps
amplify float32 rounding differences of the denoiser by up to about 2e4
before x0 is clipped); the returned latent caches atol 1e-5 (the fp32 VAE's
summation order).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (
    FP32_TOL,
    TINY_POLICY_KW,
    assert_same_run_config,
    init_shapes,
    policy_draws,
    random_params,
    to_numpy,
)
from unified_video_action_tpu.config import load_config
from unified_video_action_tpu.data.normalizer import LinearNormalizer as JaxNormalizer
from unified_video_action_tpu.models import mar as jm_
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch import config, convert
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
from unified_video_action_tpu_torch.models import mar as pm_
from unified_video_action_tpu_torch.ops import attention as attention_ops
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.utils.language import HashTextEncoder

NORMALIZED_ATOL = 1e-4
GOAL = "open the microwave"


def test_pusht_small96_is_the_jax_config_with_the_action_head_on():
    # the serving stage of scripts/training/train_pusht_small.sh turns the
    # action head on; everything else is uva_pusht_small.yaml as composed
    jax_cfg = load_config("uva_pusht_small",
                          ["model.policy.action_model_params.predict_action=true"]).to_dict()
    assert_same_run_config(config.PUSHT_SMALL96, jax_cfg)


def test_kitchen_small128_is_the_jax_config():
    assert_same_run_config(config.KITCHEN_SMALL128, load_config("uva_kitchen_small").to_dict())


@pytest.mark.parametrize("name,tokens,attended,kernel,action_dim,vae", [
    ("PUSHT_SMALL96", 144, 144, "attention_wgmma", 2, "pusht_vae96.npz"),
    ("KITCHEN_SMALL128", 256, 320, "attention_wgmma_online", 9, "kitchen_vae128.npz"),
])
def test_the_small_configs_build_mar_small_at_head_dim_128(name, tokens, attended, kernel,
                                                           action_dim, vae):
    policy = UnifiedVideoActionPolicy.from_cfg(getattr(config, name), device="meta")
    c = policy.mar_cfg
    assert (c.encoder_embed_dim, c.encoder_depth, c.encoder_num_heads) == (768, 6, 6)
    assert (c.decoder_embed_dim, c.decoder_depth, c.decoder_num_heads) == (768, 6, 6)
    assert c.encoder_embed_dim // c.encoder_num_heads == 128
    assert (c.total_tokens, c.attention_tokens) == (tokens, attended)
    assert (c.diffloss_act_d, c.diffloss_act_w) == (6, 1024)
    assert policy.action_dim == action_dim and policy.dtype == torch.bfloat16
    assert policy.vae_path.endswith(vae) and policy.vae.encoder.conv_in.out_channels == 64
    assert policy.mar.diffactloss.num_steps == 100
    # every ViT block at both serving batches goes to the D = 128 instance of one kernel
    for batch in (1, 128):
        plan = attention_ops.attention_plan(batch, c.attention_tokens, c.encoder_num_heads, 128,
                                            policy.dtype)
        assert (plan.kernel, plan.head_dim) == (kernel, 128)
    if name == "KITCHEN_SMALL128":
        assert isinstance(policy.text_encoder, HashTextEncoder) and policy.max_length == 30
        assert policy.mar.text_pos_embed.shape == (1, 64, 768)
    else:
        assert policy.text_encoder is None and not hasattr(policy.mar, "text_pos_embed")


# ------------------------------------------------------------- text buffer

SMALL = dict(
    img_size=32, vae_stride=8, vae_embed_dim=8,
    encoder_embed_dim=256, encoder_depth=1, encoder_num_heads=2,
    decoder_embed_dim=256, decoder_depth=1, decoder_num_heads=2,
    diffloss_d=1, diffloss_w=16,
    diffloss_act_d=2, diffloss_act_w=32, act_diff_testing_steps="ddim10",
    action_dim=9, language_emb_model="clip",
)


@pytest.fixture(scope="module")
def text_mars():
    jcfg = jm_.MarConfig(**SMALL, attn_dropout=0.0, proj_dropout=0.0,
                         task_name="kitchen")
    jm = jm_.Mar(jcfg)
    lat = jnp.zeros((1, 4, 8, 4, 4))
    shapes = init_shapes(jm, lat, lat, jax.random.PRNGKey(0), jnp.zeros((1, 16, 9)),
                         jnp.zeros((1, 512)), method=jm_.Mar.init_forward)
    params = random_params(shapes, seed=3)
    pm = pm_.Mar(pm_.MarConfig(**SMALL))
    convert.load_into(pm, to_numpy(params))
    return jm, params, pm


def test_the_bridge_maps_the_text_leaves_by_name(text_mars):
    _, params, pm = text_mars
    flat = convert.flatten_tree(to_numpy(params))
    for leaf in (("fake_latent",), ("text_proj_cond", "kernel"), ("text_proj_cond", "bias"),
                 ("text_pos_embed",), ("decoder_text_pos_embed",)):
        assert leaf in flat, leaf
    np.testing.assert_array_equal(pm.text_proj_cond.weight.detach().numpy(),
                                  flat[("text_proj_cond", "kernel")].T)
    np.testing.assert_array_equal(pm.fake_latent.detach().numpy(), flat[("fake_latent",)])
    # numpy-seeded weights draw the new leaves too, in the flax layout
    seeded = convert.flatten_tree(convert.seeded_tree(pm, 0))
    assert seeded[("text_proj_cond", "kernel")].shape == (512, 256)
    assert seeded[("decoder_text_pos_embed",)].shape == (1, 64, 256)
    assert convert.flax_layout_shapes(pm) == {p: v.shape for p, v in flat.items()}


@pytest.mark.parametrize("with_goal", [True, False])
def test_text_buffer_encoder_decoder_match_jax(text_mars, with_goal):
    jm, params, pm = text_mars
    rng = np.random.default_rng(5)
    B = 3
    lat = rng.standard_normal((B, 4, 8, 4, 4)).astype(np.float32)
    tokens = np.asarray(jm_.patchify(jnp.asarray(lat.reshape(B * 4, 8, 4, 4)), 1)).reshape(B, 4, 16, 8)
    goal = HashTextEncoder().encode(["open the microwave", "turn on the stove", "close the door"])

    def jax_fwd(mdl, tok, text):
        if text is not None:
            text = mdl.text_proj_cond(text)
        h = mdl.forward_encoder(jnp.zeros_like(tok), jnp.ones(tok.shape[:3]), tok, "policy_model",
                                text_latents=text)
        return h, mdl.forward_decoder(h)

    h_want, z_want = jm.apply({"params": params}, jnp.asarray(tokens),
                              jnp.asarray(goal) if with_goal else None, method=jax_fwd)
    with torch.no_grad():
        text = pm.text_proj_cond(torch.tensor(goal)) if with_goal else None
        h = pm.forward_encoder(torch.tensor(tokens), text)
        z = pm.forward_decoder(h)
        # policy_latents projects the raw goal itself
        z_policy = pm.policy_latents(torch.tensor(lat), torch.tensor(goal) if with_goal else None)
    assert h.shape == (B, 64 + 64, 256) and z.shape == (B, 64, 256)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **FP32_TOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_want), **FP32_TOL)
    np.testing.assert_array_equal(z_policy.numpy(), z.numpy())


# ------------------------------------------------------- the kitchen policy

def _kitchen_kwargs():
    kw = copy.deepcopy(TINY_POLICY_KW)
    kw["shape_meta"] = {"action": {"shape": [9]}}
    kw["task_name"] = "kitchen"
    kw["language_emb_model"] = "clip"
    amp = kw["autoregressive_model_params"]
    amp.update(encoder_embed_dim=256, encoder_num_heads=2, decoder_embed_dim=256,
               decoder_num_heads=2, act_diff_testing_steps="ddim10")
    return kw


def _normalizer_flat():
    rng = np.random.default_rng(9)
    return {"action.scale": (0.5 + rng.random(9)).astype(np.float32),
            "action.offset": (0.1 * rng.standard_normal(9)).astype(np.float32)}


@pytest.fixture(scope="module")
def kitchen_pair():
    kw = _kitchen_kwargs()
    jp = JaxPolicy(**kw)
    jp.set_normalizer(JaxNormalizer.from_flat_dict(_normalizer_flat()))
    params = random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=0)
    port = UnifiedVideoActionPolicy(**kw, device="cpu")
    port.load_params(to_numpy(params["mar"]), to_numpy(params["vae"]))
    port.set_normalizer(LinearNormalizer.from_flat_dict(_normalizer_flat()))
    assert port.mar_cfg.attention_tokens == 128
    assert port.mar_cfg.encoder_embed_dim // port.mar_cfg.encoder_num_heads == 128
    return jp, params, port


def _windows(B, n=1, seed=13):
    rng = np.random.default_rng(seed)
    return [{"agentview_rgb": rng.integers(0, 256, (B, 16, 3, 32, 32), dtype=np.uint8)}
            for _ in range(n)]


def _assert_actions(port, got, want, B):
    assert got["action_pred"].shape == want["action_pred"].shape == (B, 16, 9)
    np.testing.assert_array_equal(got["action"], got["action_pred"][:, :8])
    scale = float(port.normalizer["action"].scale.min())
    np.testing.assert_allclose(got["action_pred"], want["action_pred"], rtol=1e-5,
                               atol=NORMALIZED_ATOL / scale)


@pytest.mark.parametrize("goal", [GOAL, [GOAL, "turn on the stove", "slide the door"], None])
def test_kitchen_predict_action_matches_jax(kitchen_pair, goal):
    jp, params, port = kitchen_pair
    B = 3
    obs = _windows(B)[0]
    key = jax.random.PRNGKey(31)
    want = jp.predict_action(params, obs, key, language_goal=goal)
    got = port.predict_action(obs, noise=policy_draws(key, port.noise_shapes(B)), language_goal=goal)
    _assert_actions(port, got, want, B)


def test_the_goal_changes_the_action(kitchen_pair):
    _, _, port = kitchen_pair
    obs = _windows(2, seed=14)[0]
    noise = port.sample_noise(2, torch.Generator().manual_seed(3))
    a = port.predict_action(obs, noise=noise, language_goal=GOAL)["action_pred"]
    b = port.predict_action(obs, noise=noise, language_goal="turn on the stove")["action_pred"]
    c = port.predict_action(obs, noise=noise)["action_pred"]
    assert not np.allclose(a, b, atol=1e-4) and not np.allclose(a, c, atol=1e-4)


def test_kitchen_predict_action_cached_matches_jax(kitchen_pair):
    jp, params, port = kitchen_pair
    B = 2
    windows = _windows(B, n=2, seed=15)
    keys = [jax.random.PRNGKey(41), jax.random.PRNGKey(42)]
    j_cache = p_cache = None
    for obs, key in zip(windows, keys):
        want, j_new = jp.predict_action_cached(params, obs, key, cache=j_cache, language_goal=GOAL)
        _, new_positions = port.cache_plan(16, p_cache, 8)
        noise = policy_draws(key, port.noise_shapes(B, len(new_positions)))
        got, p_new = port.predict_action_cached(obs, cache=p_cache, noise=noise, language_goal=GOAL)
        _assert_actions(port, got, want, B)
        np.testing.assert_allclose(p_new.numpy(), np.asarray(j_new), rtol=0, atol=1e-5)
        j_cache, p_cache = j_new, p_new


def test_kitchen_async_halves_take_the_goal(kitchen_pair):
    _, _, port = kitchen_pair
    obs = _windows(2, seed=16)[0]
    noise = port.sample_noise(2, torch.Generator().manual_seed(4))
    sync = port.predict_action(obs, noise=noise, language_goal=GOAL)["action_pred"]
    np.testing.assert_array_equal(
        port.predict_action_async(obs, noise=noise, language_goal=GOAL).numpy(), sync)
    nact, _ = port.predict_action_cached_async(obs, noise=noise, language_goal=GOAL)
    np.testing.assert_array_equal(nact.numpy(), sync)


@pytest.mark.parametrize("task", ["libero10", "toolhang", "umi"])
def test_other_tasks_stay_refused(task):
    """libero stays refused; toolhang and umi are ported now and build with
    JAX's state and proprioception-head widths for their task."""
    kw = _kitchen_kwargs()
    kw["task_name"] = task
    if task == "libero10":
        with pytest.raises(NotImplementedError, match="not ported"):
            UnifiedVideoActionPolicy(**kw, device="cpu")
        return
    port = UnifiedVideoActionPolicy(**kw, use_proprioception=True, device="cpu")
    want = JaxPolicy(**kw, use_proprioception=True).mar_cfg
    got = port.mar_cfg
    assert (got.proprio_dim, got.proprio_pred_dim, got.proprio_use_image) == (
        want.proprio_dim, want.proprio_pred_dim, want.proprio_use_image)
