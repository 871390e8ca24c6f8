"""Port of the video generation path (models/mar.py's sample_video,
unpatchify and sample_orders' ranks, models/heads.py's
VideoDiffusionHead.sample, models/denoiser.py's cfg_denoise_fn) against the
JAX package on the CPU, in fp32, at a small size: 2+2 blocks, d=64, 4
heads, T = 4 frames of 4x4 latents (64 tokens), the video head respaced to 2
steps and the action head to 5. The JAX side runs under ``model.apply``,
as tests/test_mar.py runs it; its draws (the order and every round's head
noise, from JAX's key schedule) are handed to the port by
``tests._torch_parity.video_draws``.

Tolerance: FP32_TOL (rtol = atol = 1e-5), the action sampler's parity
tolerance, for the action chunks of one round; after more than one round
the action head is conditioned on the video head's sampled latents (below),
and the chunks are held to ROUNDS_ACTION_ATOL, tests/test_torch_policy.py's
NORMALIZED_ATOL for the action sampler (at num_iter 3 one element of 64
reads 2.2e-5). Every discrete choice of the MaskGIT loop
(the order, the mask schedule) is injected or static, so nothing but float32
rounding separates the two across rounds. The video head samples with
clip_denoised=False: under random weights nothing makes its epsilon cancel
x, so the first step's x0 = x/sqrt(ᾱ) - ... multiplies by about 1e4 and the
sampled latents reach 1e4-1e5, where one float32 rounding is 1e-3 to 1e-2.
The latents are held to FP32_TOL on the output's scale (``scaled_tol``:
rtol 1e-5, atol 1e-5 x max |JAX|): on the head alone the JAX run lies 2.2e-6
of that scale from a float64 run of the port, and the port's float32 run
4e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (
    FP32_TOL,
    head_draws,
    init_shapes,
    random_params,
    to_numpy,
    video_draws,
)
from unified_video_action_tpu.models import denoiser as jd
from unified_video_action_tpu.models import heads as jh
from unified_video_action_tpu.models import mar as jm_
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.models import denoiser as pd
from unified_video_action_tpu_torch.models import heads as ph
from unified_video_action_tpu_torch.models import mar as pm_

SMALL = dict(
    img_size=32, vae_stride=8, vae_embed_dim=8,
    encoder_embed_dim=64, encoder_depth=2, encoder_num_heads=4,
    decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4,
    diffloss_d=1, diffloss_w=16, num_sampling_steps="2",
    diffloss_act_d=1, diffloss_act_w=16, act_diff_testing_steps="5",
)
TEXT = dict(SMALL, language_emb_model="clip", buffer_size_text=8, action_dim=9)


def _mars(kw, seed=0):
    jm = jm_.Mar(jm_.MarConfig(**kw, attn_dropout=0.0, proj_dropout=0.0))
    lat = jnp.zeros((1, 4, 8, 4, 4))
    text = jnp.zeros((1, 512)) if kw.get("language_emb_model") else None
    shapes = init_shapes(jm, lat, lat, jax.random.PRNGKey(0),
                         jnp.zeros((1, 16, kw.get("action_dim", 2))), text_latents=text,
                         method=jm_.Mar.init_forward)
    params = random_params(shapes, seed=seed)
    pm = pm_.Mar(pm_.MarConfig(**kw)).eval()
    convert.load_into(pm, to_numpy(params))
    return jm, params, pm


@pytest.fixture(scope="module")
def mars():
    return _mars(SMALL)


@pytest.fixture(scope="module")
def text_mars():
    return _mars(TEXT, seed=1)


ROUNDS_ACTION_ATOL = 1e-4


def scaled_tol(want):
    return dict(rtol=FP32_TOL["rtol"], atol=FP32_TOL["atol"] * float(np.abs(want).max()))


def _latents(B=2, seed=1):
    return np.random.default_rng(seed).standard_normal((B, 4, 8, 4, 4)).astype(np.float32)


def _jax_sample_video(jm, params, cond, key, text_latents=None, **kw):
    """``Mar.sample_video`` under ``model.apply``, jitted (as tests/test_mar.py's
    ``test_jit_policy_path`` runs the policy path): a third of the op-by-op
    time on the CPU."""
    run = jax.jit(lambda p, c, k, t: jm.apply({"params": p}, c, k, text_latents=t,
                                              method=jm_.Mar.sample_video, **kw))
    frames, act = run(params, jnp.asarray(cond), key, text_latents)
    return np.asarray(frames), None if act is None else np.asarray(act)


@pytest.mark.parametrize("p", [1, 2])
def test_unpatchify_matches(p):
    x = np.random.default_rng(p).standard_normal((3, 16 // (p * p), 8 * p * p)).astype(np.float32)
    got = pm_.unpatchify(torch.tensor(x), p, 8, 4 // p)
    want = np.asarray(jm_.unpatchify(jnp.asarray(x), p, 8, 4 // p))
    np.testing.assert_array_equal(got.numpy(), want)
    # the inverse of patchify
    np.testing.assert_array_equal(pm_.patchify(got, p).numpy(), x)


def test_mask_schedule_is_jax_loop():
    # mar.py:781-788 inline, as JAX computes it
    for S, n in ((16, 1), (16, 3), (144, 4), (144, 8), (1024, 64)):
        want, prev = [], S
        for step in range(n):
            ml = int(np.floor(S * np.cos(np.pi / 2.0 * (step + 1) / n)))
            ml = max(1, min(prev - 1, ml)) if step < n - 1 else 0
            want.append(ml)
            prev = ml
        assert pm_.mask_schedule(S, n) == want
    assert pm_.mask_schedule(144, 1) == [0]


def test_sample_orders_are_ranks():
    g = torch.Generator().manual_seed(0)
    rank = pm_.sample_orders(3, 16, g, torch.device("cpu"))
    assert rank.dtype == torch.int64
    assert (rank.sort(dim=-1).values == torch.arange(16)).all()


def test_cfg_denoise_fn_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    t = rng.integers(0, 1000, 6)
    c = rng.standard_normal((6, 5)).astype(np.float32)
    w = rng.standard_normal((9, 8)).astype(np.float32)

    def apply_np(xx, tt, cc, lib):
        feats = lib.concatenate([xx, cc], axis=1) if lib is jnp else torch.cat([xx, cc], 1)
        return feats @ (jnp.asarray(w) if lib is jnp else torch.tensor(w)) + tt[:, None] * 1e-3

    want = jd.cfg_denoise_fn(lambda a, b, cc: apply_np(a, b, cc, jnp), 2.5, 4)(
        jnp.asarray(x), jnp.asarray(t, jnp.float32), jnp.asarray(c))
    got = pd.cfg_denoise_fn(lambda a, b, cc: apply_np(a, b, cc, torch), 2.5, 4)(
        torch.tensor(x), torch.tensor(t, dtype=torch.float32), torch.tensor(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    # both halves take the guided epsilon; the variance channels pass per half
    np.testing.assert_array_equal(got[:3, :4].numpy(), got[3:, :4].numpy())


@pytest.mark.parametrize("cfg", [1.0, 1.5])
def test_video_head_sample_matches_jax(cfg):
    kw = dict(target_channels=8, z_channels=32, width=16, depth=2)
    jm = jh.VideoDiffusionHead(**kw, num_sampling_steps="5")
    n = 12
    z = np.random.default_rng(3).standard_normal((n, 32)).astype(np.float32)
    shapes = init_shapes(jm, jnp.zeros((1, 1, 8)), jnp.zeros((1, 1, 32)), jnp.ones((1, 1)),
                         jax.random.PRNGKey(0))
    params = random_params(shapes, seed=2)
    pm = ph.VideoDiffusionHead(**kw, num_sampling_steps="5")
    convert.load_into(pm, to_numpy(params))
    key = jax.random.PRNGKey(7)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(z), key, temperature=0.95, cfg=cfg,
                               method=jh.VideoDiffusionHead.sample))
    draw = pm.draw_shapes(n, cfg)
    assert draw == {"init": (n // 2 if cfg != 1.0 else n, 8), "steps": (5, n, 8)}
    # the start for draw["init"] rows, the per-step noise for all n rows
    init, _ = head_draws(key, draw["init"][0], 8, 5)
    _, per_step = head_draws(key, n, 8, 5)
    with torch.no_grad():
        got = pm.sample(torch.tensor(z), torch.tensor(init), torch.tensor(per_step),
                        temperature=0.95, cfg=cfg).numpy()
    np.testing.assert_allclose(got, want, **scaled_tol(want))


@pytest.mark.parametrize("num_iter", [1, 3])
def test_sample_video_matches_jax(mars, num_iter):
    jm, params, pm = mars
    B = 2
    cond = _latents(B)
    key = jax.random.PRNGKey(11 + num_iter)
    want_frames, want_act = _jax_sample_video(jm, params, cond, key, num_iter=num_iter,
                                              temperature=0.95)
    draws = video_draws(key, pm.video_draw_shapes(B, num_iter))
    frames, act = pm.sample_video(torch.tensor(cond), draws, num_iter=num_iter, temperature=0.95)
    assert frames.shape == (B * 4, 8, 4, 4) and frames.dtype == torch.float32
    np.testing.assert_allclose(frames.numpy(), want_frames, **scaled_tol(want_frames))
    np.testing.assert_allclose(act.numpy(), want_act, **(
        FP32_TOL if num_iter == 1 else dict(FP32_TOL, atol=ROUNDS_ACTION_ATOL)))


def test_sample_video_video_model_has_no_action(mars):
    jm, params, pm = mars
    key = jax.random.PRNGKey(5)
    want, want_act = _jax_sample_video(jm, params, _latents(1), key, num_iter=2,
                                       task_mode="video_model")
    shapes = pm.video_draw_shapes(1, 2, "video_model")
    assert all("action_init" not in r for r in shapes["rounds"])
    frames, act = pm.sample_video(torch.tensor(_latents(1)), video_draws(key, shapes), num_iter=2,
                                  task_mode="video_model")
    assert act is None and want_act is None
    np.testing.assert_allclose(frames.numpy(), want, **scaled_tol(want))


def _goal(B, seed=4):
    return np.random.default_rng(seed).standard_normal((B, 512)).astype(np.float32)


def test_sample_video_cfg_matches_jax(text_mars):
    jm, params, pm = text_mars
    B, num_iter = 2, 2
    cond, text = _latents(B, seed=2), _goal(B)
    key = jax.random.PRNGKey(21)
    want, want_act = _jax_sample_video(jm, params, cond, key, num_iter=num_iter, cfg=1.5,
                                       temperature=0.95, text_latents=jnp.asarray(text))
    shapes = pm.video_draw_shapes(B, num_iter, cfg=1.5)
    # the doubled batch: 2B rows of T x revealed tokens, the start for half of them
    S = pm.cfg.seq_len
    n0 = 2 * B * 4 * (S - pm_.mask_schedule(S, num_iter)[0])
    assert shapes["rounds"][0]["video_init"] == (n0 // 2, 8)
    assert shapes["rounds"][0]["video_steps"] == (2, n0, 8)
    frames, act = pm.sample_video(torch.tensor(cond), video_draws(key, shapes), num_iter=num_iter,
                                  cfg=1.5, temperature=0.95, text_latents=torch.tensor(text))
    np.testing.assert_allclose(frames.numpy(), want, **scaled_tol(want))
    np.testing.assert_allclose(act.numpy(), want_act, **dict(FP32_TOL, atol=ROUNDS_ACTION_ATOL))


def test_cfg_is_a_no_op_when_the_goal_is_the_null_latent(text_mars):
    # text_proj_cond maps every goal onto fake_latent: the conditional and
    # unconditional halves are then the same rows, cond - uncond is exactly
    # 0, and the guidance scale cannot move a bit of the result
    _, _, pm = text_mars
    noop = pm_.Mar(pm.cfg).eval()
    noop.load_state_dict(pm.state_dict())
    with torch.no_grad():
        noop.text_proj_cond.weight.zero_()
        noop.text_proj_cond.bias.copy_(noop.fake_latent[0])
    B, cond, text = 2, torch.tensor(_latents(2, seed=3)), torch.tensor(_goal(2, seed=5))
    draws = noop.sample_video_draws(B, torch.Generator().manual_seed(0), torch.device("cpu"),
                                    num_iter=2, cfg=3.0)
    outs = [noop.sample_video(cond, draws, num_iter=2, cfg=s, text_latents=text)
            for s in (3.0, 7.0)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    # and it is a guided run: the real projection moves the result
    moved = pm.sample_video(cond, draws, num_iter=2, cfg=7.0, text_latents=text)[0]
    assert not torch.allclose(moved, outs[1][0])


def test_cfg_without_text_raises(mars, text_mars):
    _, _, pm = mars
    draws = pm.sample_video_draws(1, torch.Generator().manual_seed(0), torch.device("cpu"), cfg=1.5)
    with pytest.raises(ValueError, match="cfg"):
        pm.sample_video(torch.tensor(_latents(1)), draws, cfg=1.5)
    _, _, tm = text_mars
    draws = tm.sample_video_draws(1, torch.Generator().manual_seed(0), torch.device("cpu"), cfg=1.5)
    with pytest.raises(ValueError, match="cfg"):
        tm.sample_video(torch.tensor(_latents(1)), draws, cfg=1.5)


def test_sample_video_refuses_draws_of_another_shape(mars):
    _, _, pm = mars
    draws = pm.sample_video_draws(2, torch.Generator().manual_seed(0), torch.device("cpu"),
                                  num_iter=2)
    with pytest.raises(ValueError, match="rounds"):
        pm.sample_video(torch.tensor(_latents(2)), draws, num_iter=3)
    with pytest.raises(ValueError, match="order_rank"):
        pm.sample_video(torch.tensor(_latents(1)), draws, num_iter=2)


def test_config_carries_the_video_head_steps(mars):
    assert pm_.MarConfig().num_sampling_steps == jm_.MarConfig().num_sampling_steps == "100"
    assert mars[2].diffloss.num_steps == 2
