"""Port of models/denoiser.py against the JAX modules on the CPU, in fp32.

Tolerances: FP32_TOL (rtol = atol = 1e-5) for the denoiser, the same
arithmetic in another order. The sinusoidal embedding takes atol 1e-4: XLA's
and torch's float32 exp may round a frequency 1 ulp apart, and at t = 999
one ulp (2^-24 relative) moves the cos/sin argument by up to 6e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests._torch_parity import FP32_TOL, assert_int8_parity, init_shapes, random_params, to_numpy
from unified_video_action_tpu.models import denoiser as jd
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.models import denoiser as pd
from unified_video_action_tpu_torch.models.transformer import QuantLinear


@pytest.mark.parametrize("dim", [256, 7])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 1, 17, 500, 999], dtype=np.int32)
    want = np.asarray(jd.timestep_embedding(jnp.asarray(t), dim))
    got = pd.timestep_embedding(torch.tensor(t), dim).numpy()
    assert got.shape == (5, dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _inputs(n=24, c=2, z=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c)).astype(np.float32)
    t = rng.integers(0, 1000, n).astype(np.int32)
    cond = rng.standard_normal((n, z)).astype(np.float32)
    return x, t, cond


@pytest.mark.parametrize("depth", [1, 3])
def test_mlp_denoiser_matches_jax(depth):
    x, t, c = _inputs()
    jm = jd.MlpDenoiser(in_channels=2, model_channels=32, out_channels=4, z_channels=48, depth=depth)
    params = random_params(init_shapes(jm, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c)), seed=depth)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c)))
    pm = convert.load_into(pd.MlpDenoiser(2, 32, 4, 48, depth), to_numpy(params))
    with torch.no_grad():
        got = pm(torch.tensor(x), torch.tensor(t), torch.tensor(c))
    assert got.dtype == torch.float32 and got.shape == (24, 4)
    np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)


def test_adaln_final_has_no_norm_parameters():
    # flax's final LayerNorm has neither scale nor bias; neither has the port's
    final = pd.AdaLNFinal(16, 4)
    assert sorted(final.state_dict()) == [
        "ada_mod.bias", "ada_mod.weight", "proj.bias", "proj.weight"
    ]


def test_bf16_denoiser_returns_fp32():
    x, t, c = _inputs(n=8, seed=1)
    pm = pd.MlpDenoiser(2, 32, 4, 48, 2).to(torch.bfloat16)
    with torch.no_grad():
        out = pm(torch.tensor(x), torch.tensor(t), torch.tensor(c))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


# W8A8 (quant=True), against the JAX module under jax.jit (as the serving
# program runs it), with the int8 parity of tests/_torch_parity.py: most
# rows within FP32_TOL, the mean difference under a tenth of the gap between
# JAX's int8 and float denoisers on the same inputs.


def _jit_apply(module, params, *args):
    return np.asarray(jax.jit(lambda p, *a: module.apply({"params": p}, *a))(params, *args))


@pytest.mark.parametrize("depth", [1, 3])
def test_quant_mlp_denoiser_matches_jax(depth):
    x, t, c = _inputs(n=32, seed=depth + 10)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(c))
    jm = jd.MlpDenoiser(2, 32, 4, 48, depth, quant=True)
    params = random_params(init_shapes(jm, *args), seed=depth + 10)
    want = _jit_apply(jm, params, *args)
    want_float = _jit_apply(jd.MlpDenoiser(2, 32, 4, 48, depth), params, *args)
    pm = convert.load_into(pd.MlpDenoiser(2, 32, 4, 48, depth, quant=True), to_numpy(params))
    with torch.no_grad():
        got = pm(torch.tensor(x), torch.tensor(t), torch.tensor(c)).numpy()
    assert_int8_parity(got, want, want_float)


def test_quant_reaches_the_layers_jax_quantizes():
    # models/denoiser.py:65-189: _dense_cls(quant) builds input_proj,
    # cond_embed, every block's ada_mod, fc1, fc2 and the final ada_mod;
    # the timestep MLP and the final proj stay nn.Dense
    pm = pd.MlpDenoiser(2, 32, 4, 48, 2, quant=True)
    quant = {n for n, m in pm.named_modules() if isinstance(m, QuantLinear)}
    assert quant == {"input_proj", "cond_embed", "block_0.ada_mod", "block_0.fc1", "block_0.fc2",
                     "block_1.ada_mod", "block_1.fc1", "block_1.fc2", "final.ada_mod"}
    assert {n for n, m in pm.named_modules() if isinstance(m, nn.Linear)} == {
        "time_embed.fc1", "time_embed.fc2", "final.proj"}


def test_bf16_quant_denoiser_keeps_an_fp32_residual_stream():
    # the int8 input_proj keeps the sampler's fp32 x, as JAX's QuantDense does,
    # so the blocks' residual adds run in fp32 while their layers run in bf16
    x, t, c = _inputs(n=8, seed=2)
    pm = pd.MlpDenoiser(2, 32, 4, 48, 2, quant=True).to(torch.bfloat16)
    seen = []
    pm.block_1.register_forward_hook(lambda m, a, out: seen.append((a[0].dtype, a[1].dtype, out.dtype)))
    with torch.no_grad():
        out = pm(torch.tensor(x), torch.tensor(t), torch.tensor(c))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert seen == [(torch.float32, torch.bfloat16, torch.float32)]
