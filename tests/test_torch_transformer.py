"""Port of models/transformer.py (ViTBlock, TransformerStack, fused-qkv
attention) against the JAX modules on the CPU, in fp32.

Tolerance: FP32_TOL (rtol = atol = 1e-5), the same arithmetic in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import FP32_TOL, init_shapes, random_params, to_numpy
from unified_video_action_tpu.models import transformer as jt
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.models import transformer as pt

DIM, HEADS = 128, 2  # head width 64, the kernel's


def _x(B=2, N=36, seed=0):
    return np.random.default_rng(seed).standard_normal((B, N, DIM)).astype(np.float32)


def _with_attn(module, attn_impl):
    pt.set_attn_impl(module, attn_impl)
    return module


def _pair(jax_module, port_module, x, seed):
    params = random_params(init_shapes(jax_module, jnp.asarray(x)), seed)
    want = np.asarray(jax_module.apply({"params": params}, jnp.asarray(x)))
    convert.load_into(port_module, to_numpy(params))
    with torch.no_grad():
        got = port_module(torch.tensor(x)).numpy()
    return got, want


def test_vit_block_matches_jax():
    x = _x()
    got, want = _pair(jt.ViTBlock(DIM, HEADS), pt.ViTBlock(DIM, HEADS), x, seed=1)
    np.testing.assert_allclose(got, want, **FP32_TOL)


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_transformer_stack_matches_jax(attn_impl):
    x = _x(B=3, N=20, seed=2)
    got, want = _pair(
        jt.TransformerStack(depth=2, dim=DIM, num_heads=HEADS),
        _with_attn(pt.TransformerStack(2, DIM, HEADS), attn_impl),
        x, seed=3,
    )
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_attention_matches_jax_pallas_route():
    # the JAX layer with its Pallas kernel (interpret mode) against the port's
    x = _x(B=2, N=24, seed=4)
    jm = jt.MultiHeadAttention(DIM, HEADS)
    params = random_params(init_shapes(jm, jnp.asarray(x)), seed=5)
    from unified_video_action_tpu.ops.attention import flash_attention

    qkv = np.asarray(jnp.asarray(x) @ params["qkv"]["kernel"] + params["qkv"]["bias"])
    qkv = qkv.reshape(2, 24, 3, HEADS, DIM // HEADS)
    o = flash_attention(*(jnp.asarray(qkv[:, :, i]) for i in range(3)), interpret=True)
    want = np.asarray(o).reshape(2, 24, DIM) @ params["proj"]["kernel"] + params["proj"]["bias"]
    pm = convert.load_into(pt.MultiHeadAttention(DIM, HEADS), to_numpy(params))
    with torch.no_grad():
        got = pm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_set_attn_impl_switches_every_layer():
    stack = pt.TransformerStack(3, DIM, HEADS)
    assert {m.attn_impl for m in stack.modules() if isinstance(m, pt.MultiHeadAttention)} == {"kernel"}
    pt.set_attn_impl(stack, "plain")
    assert {m.attn_impl for m in stack.modules() if isinstance(m, pt.MultiHeadAttention)} == {"plain"}
    with pytest.raises(ValueError):
        pt.set_attn_impl(stack, "sdpa")
