"""The port in bf16, the flagship's compute dtype (latest/meta.json), against
the JAX package on the CPU at the tiny config of tests/_torch_parity.py, one
seed: at the VAE mean, the MAR encoder+decoder output, the action
denoiser's output and the sampled (normalized) action chunk.

bf16 keeps 8 significant bits, and the two stacks round at other places:
the port casts its parameters to bf16 once (policy.py), flax keeps them in
fp32 and casts at each use, so sums of parameters (the position embeddings)
round differently. The port's bf16 result and JAX's bf16 result therefore
differ from each other about as much as each differs from fp32. What is
held is the port's distance to JAX's fp32 result, mean |port_bf16 -
jax_fp32|, against JAX's own, mean |jax_bf16 - jax_fp32|, on the same fp32
inputs for every stage: at most BF16_RATIO times it. A port that lost
precision somewhere (an fp32 island computed in bf16, a sum taken in bf16)
moves that ratio well past 1. Measured here, port vs JAX: VAE mean 0.0073
vs 0.0078, MAR output 0.0069 vs 0.0067, denoiser 0.0087 vs 0.0095, sampled
actions 0.0053 vs 0.0052 (ratios 0.92-1.03).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import TINY_POLICY_KW, head_draws, random_params, to_numpy
from unified_video_action_tpu.models import mar as jm_
from unified_video_action_tpu.models.vae import KLVae as JaxKLVae
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

BF16_RATIO = 1.5
B = 4


def _kwargs(dtype):
    kw = copy.deepcopy(TINY_POLICY_KW)
    kw["autoregressive_model_params"]["act_diff_testing_steps"] = "ddim10"
    kw["compute_dtype"] = dtype
    return kw


@pytest.fixture(scope="module")
def stacks():
    j32, j16 = JaxPolicy(**_kwargs("float32")), JaxPolicy(**_kwargs("bfloat16"))
    params = random_params(jax.eval_shape(j32.init_params, jax.random.PRNGKey(0)), seed=0)
    port = UnifiedVideoActionPolicy(**_kwargs("bfloat16"), device="cpu")
    port.load_params(to_numpy(params["mar"]), to_numpy(params["vae"]))
    assert port.dtype == torch.bfloat16
    return j32, j16, params, port


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _hold(name, port16, jax16, jax32):
    port_err = np.abs(_f32(port16) - _f32(jax32)).mean()
    jax_err = np.abs(_f32(jax16) - _f32(jax32)).mean()
    assert jax_err > 0, f"{name}: JAX's bf16 equals its fp32"
    assert port_err <= BF16_RATIO * jax_err, (
        f"{name}: port bf16 vs JAX fp32 {port_err:.3g} > {BF16_RATIO} x JAX bf16 vs fp32 "
        f"{jax_err:.3g}")


def test_bf16_vae_mean(stacks):
    j32, j16, params, port = stacks
    x = np.random.default_rng(1).uniform(-1, 1, (B, 3, 32, 32)).astype(np.float32)
    run = lambda jp: jp.vae.apply({"params": params["vae"]}, jnp.asarray(x), method=JaxKLVae.encode)[0]
    with torch.no_grad():
        got = port.vae.encode(torch.tensor(x).to(torch.bfloat16))[0]
    _hold("VAE mean", got, run(j16), run(j32))


def _latents(seed):
    return np.random.default_rng(seed).standard_normal((B, 4, 8, 4, 4)).astype(np.float32)


def test_bf16_mar_output(stacks):
    j32, j16, params, port = stacks
    lat = _latents(2)
    tokens = np.asarray(jm_.patchify(jnp.asarray(lat.reshape(B * 4, 8, 4, 4)), 1)).reshape(B, 4, 16, 8)

    def fwd(mdl, tok):
        h = mdl.forward_encoder(jnp.zeros_like(tok), jnp.ones(tok.shape[:3]), tok, "policy_model")
        return mdl.forward_decoder(h)

    run = lambda jp: jp.mar.apply({"params": params["mar"]}, jnp.asarray(tokens), method=fwd)
    with torch.no_grad():
        got = port.mar.policy_latents(torch.tensor(lat))
    _hold("MAR output", got, run(j16), run(j32))


def test_bf16_denoiser_output(stacks):
    j32, j16, params, port = stacks
    rng = np.random.default_rng(3)
    n = B * 16
    x = rng.standard_normal((n, 2)).astype(np.float32)
    t = rng.integers(0, 1000, n).astype(np.int32)
    c = rng.standard_normal((n, 64)).astype(np.float32)
    run = lambda jp: jp.mar.apply(
        {"params": params["mar"]}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c),
        method=lambda m, x, t, c: m.diffactloss.net(x, t, c))
    with torch.no_grad():
        got = port.mar.diffactloss.net(torch.tensor(x), torch.tensor(t).long(),
                                       torch.tensor(c).to(torch.bfloat16))
    _hold("denoiser", got, run(j16), run(j32))


def test_bf16_sampled_actions(stacks):
    j32, j16, params, port = stacks
    lat = _latents(4)
    key = jax.random.PRNGKey(5)
    run = lambda jp: jp.mar.apply({"params": params["mar"]}, jnp.asarray(lat), key,
                                  temperature=0.95, method=jm_.Mar.sample_policy)
    init, per_step = head_draws(key, B * 16, 2, port.mar.diffactloss.num_steps)
    with torch.no_grad():
        got = port.mar.sample_policy(torch.tensor(lat), torch.tensor(init), torch.tensor(per_step),
                                     temperature=0.95)
    _hold("sampled actions", got, run(j16), run(j32))
