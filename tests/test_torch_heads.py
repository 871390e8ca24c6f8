"""Port of models/heads.py (the adaptive pool matrix, ConvFcPool and
ActionDiffusionHead.sample) against the JAX package on the CPU, in fp32.

The head's sampler runs with the JAX head's own draws, reproduced from its
key (heads.py:283-297, gaussian.py:322-330) and injected into the port.
Tolerance: FP32_TOL (rtol = atol = 1e-5), the same arithmetic in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import FP32_TOL, head_draws, init_shapes, random_params, to_numpy
from unified_video_action_tpu.models import heads as jh
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.models import heads as ph

D = 32


@pytest.mark.parametrize("W", [4, 6, 7, 16])
def test_adaptive_pool_matrix_matches(W):
    np.testing.assert_array_equal(ph._adaptive_pool_matrix(W, 4), jh._adaptive_pool_matrix(W, 4))


def test_adaptive_pool_matrix_is_torch_adaptive_avg_pool():
    x = torch.randn(2, 3, 6, 6, generator=torch.Generator().manual_seed(0))
    P = torch.tensor(ph._adaptive_pool_matrix(6, 4))
    got = torch.einsum("iw,bcwh,jh->bcij", P, x, P)
    torch.testing.assert_close(got, torch.nn.functional.adaptive_avg_pool2d(x, 4))


@pytest.mark.parametrize("W", [6, 4])
def test_conv_fc_pool_matches_jax(W):
    z = np.random.default_rng(W).standard_normal((2, 4 * W * W, D)).astype(np.float32)
    jm = jh.ConvFcPool(D)
    params = random_params(init_shapes(jm, jnp.asarray(z)), seed=W)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(z)))
    pm = convert.load_into(ph.ConvFcPool(D), to_numpy(params))
    with torch.no_grad():
        got = pm(torch.tensor(z)).numpy()
    assert got.shape == (2, 16, D)
    np.testing.assert_allclose(got, want, **FP32_TOL)


@pytest.mark.parametrize("steps", ["100", "ddim10"])
def test_action_head_sample_matches_jax(steps):
    B, A = 2, 2
    z = np.random.default_rng(1).standard_normal((B, 4 * 36, D)).astype(np.float32)
    jm = jh.ActionDiffusionHead(target_channels=A, z_channels=D, width=24, depth=2,
                                act_diff_testing_steps=steps)
    shapes = init_shapes(jm, jnp.zeros((B, 16, A)), jnp.asarray(z), jax.random.PRNGKey(0))
    params = random_params(shapes, seed=2)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(z), key, temperature=0.95,
                               method=jh.ActionDiffusionHead.sample))

    pm = ph.ActionDiffusionHead(A, D, 24, 2, act_diff_testing_steps=steps)
    convert.load_into(pm, to_numpy(params))
    init, per_step = head_draws(key, B * 16, A, pm.num_steps)
    with torch.no_grad():
        got = pm.sample(torch.tensor(z), torch.tensor(init), torch.tensor(per_step),
                        temperature=0.95).numpy()
    assert got.shape == (B, 16, A)
    # x0 is clipped to [-1, 1]: make sure the chunk is not all at the clip
    assert (np.abs(want) < 0.999).mean() > 0.5
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_only_conv_fc_is_ported():
    with pytest.raises(NotImplementedError):
        ph.ActionDiffusionHead(2, D, 24, 1, act_model_type="fc2")
