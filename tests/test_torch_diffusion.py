"""Port of models/diffusion/gaussian.py (schedules, respacing, the
LEARNED_RANGE posterior, p_sample_loop and ddim_sample_loop) against the
JAX package on the CPU.

Both samplers run one stand-in denoiser, written once in jnp and once in
torch, under the same noise: the JAX loops draw it from their key, and the
test draws the same numbers from that key and injects them. Tolerance:
FP32_TOL (rtol = atol = 1e-5) after every step of the loop, the same
arithmetic in another order; schedules in float64 must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import FP32_TOL
from unified_video_action_tpu.models.diffusion import gaussian as jg
from unified_video_action_tpu_torch.models.diffusion import gaussian as pg

C = 3
RESPACINGS = ["100", "ddim10", "25,25", ""]


@pytest.mark.parametrize("name", ["cosine", "linear"])
def test_beta_schedules_match(name):
    np.testing.assert_array_equal(
        pg.get_named_beta_schedule(name, 1000), jg.get_named_beta_schedule(name, 1000)
    )


@pytest.mark.parametrize("spec", ["100", "ddim10", "ddim50", "25,25", "7,3,2", 10, [4, 6]])
def test_space_timesteps_match(spec):
    assert pg.space_timesteps(1000, spec) == jg.space_timesteps(1000, spec)


def test_space_timesteps_refuses_the_same_specs():
    for bad in ("ddim999", "600,600"):
        with pytest.raises(ValueError):
            jg.space_timesteps(1000, bad)
        with pytest.raises(ValueError):
            pg.space_timesteps(1000, bad)


@pytest.mark.parametrize("respacing", RESPACINGS)
def test_create_diffusion_matches(respacing):
    j = jg.create_diffusion(respacing)
    p = pg.create_diffusion(respacing)
    np.testing.assert_array_equal(p.timestep_map, j.timestep_map)
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(p, name), getattr(j, name), err_msg=name)


def test_map_t_gives_original_timesteps():
    j = jg.create_diffusion("ddim10")
    p = pg.create_diffusion("ddim10")
    for t in range(p.num_timesteps):
        want = np.asarray(j._map_t(jnp.full((4,), t, dtype=jnp.int32)))
        np.testing.assert_array_equal(p._map_t(t, 4, torch.device("cpu")).numpy(), want)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("t", [0, 1, 57, 99])
def test_p_mean_variance_matches(t, clip):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((16, C)).astype(np.float32)
    out = np.concatenate(
        [rng.standard_normal((16, C)), rng.uniform(-1, 1, (16, C))], axis=1
    ).astype(np.float32)
    j = jg.create_diffusion("100").p_mean_variance(
        jnp.asarray(out), jnp.asarray(x), jnp.full((16,), t, dtype=jnp.int32), clip_denoised=clip
    )
    p = pg.create_diffusion("100").p_mean_variance(
        torch.tensor(out), torch.tensor(x), t, clip_denoised=clip
    )
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(p[k].numpy(), np.asarray(j[k]), err_msg=k, **FP32_TOL)


_W = np.random.default_rng(9).standard_normal((C, 2 * C)).astype(np.float32) * 0.5


def _jax_denoise(x, t):
    return jnp.tanh(x @ jnp.asarray(_W) + t[:, None].astype(jnp.float32) / 1000.0)


def _torch_denoise(x, t):
    return torch.tanh(x @ torch.tensor(_W) + t[:, None].float() / 1000.0)


def _draws(key, n, steps):
    noise_key, loop_key = jax.random.split(key)
    init = np.asarray(jax.random.normal(noise_key, (n, C)))
    per_step = np.stack(
        [np.asarray(jax.random.normal(k, (n, C))) for k in jax.random.split(loop_key, steps)]
    )
    return init, loop_key, per_step


@pytest.mark.parametrize("respacing", ["100", "ddim10"])
@pytest.mark.parametrize("clip,temperature", [(True, 0.95), (False, 1.0)])
def test_p_sample_loop_matches(respacing, clip, temperature):
    j = jg.create_diffusion(respacing)
    p = pg.create_diffusion(respacing)
    init, loop_key, per_step = _draws(jax.random.PRNGKey(3), 32, j.num_timesteps)
    want = np.asarray(j.p_sample_loop(_jax_denoise, jnp.asarray(init), loop_key,
                                      clip_denoised=clip, temperature=temperature))
    got = p.p_sample_loop(_torch_denoise, torch.tensor(init), torch.tensor(per_step),
                          clip_denoised=clip, temperature=temperature).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_matches(eta):
    j = jg.create_diffusion("ddim10")
    p = pg.create_diffusion("ddim10")
    init, loop_key, per_step = _draws(jax.random.PRNGKey(4), 32, j.num_timesteps)
    want = np.asarray(j.ddim_sample_loop(_jax_denoise, jnp.asarray(init), loop_key, eta=eta))
    got = p.ddim_sample_loop(_torch_denoise, torch.tensor(init), torch.tensor(per_step),
                             eta=eta).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_loops_check_the_noise_shape():
    p = pg.create_diffusion("ddim10")
    with pytest.raises(ValueError, match="step_noise"):
        p.p_sample_loop(_torch_denoise, torch.zeros(4, C), torch.zeros(9, 4, C))
    with pytest.raises(ValueError, match="step_noise"):
        p.ddim_sample_loop(_torch_denoise, torch.zeros(4, C), torch.zeros(10, 5, C))
