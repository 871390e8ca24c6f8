"""Port of models/transformer.py (ViTBlock, TransformerStack, fused-qkv
attention) against the JAX modules on the CPU, in fp32.

Tolerance: FP32_TOL (rtol = atol = 1e-5), the same arithmetic in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import FP32_TOL, assert_int8_parity, init_shapes, random_params, to_numpy
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


# W8A8 (quant=True). The JAX modules run under jax.jit, as the serving program
# runs them (XLA folds their `/ 127.0` into the multiplication the port
# makes). Tolerances: one layer is bit-equal in bf16 and within 1 ulp in fp32,
# where XLA fuses the last rescale product and the bias add into one FMA and
# the port rounds them apart; a block holds the int8 parity of
# tests/_torch_parity.py (most rows to FP32_TOL, the mean difference under a
# tenth of the int8-vs-float gap).


def _jit_apply(module, params, *args):
    return np.asarray(jax.jit(lambda p, *a: module.apply({"params": p}, *a))(params, *args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_linear_matches_quant_dense(dtype):
    x = _x(B=3, N=10, seed=6)
    jm = jt.QuantDense(96)
    params = random_params(init_shapes(jm, jnp.asarray(x)), seed=7)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jx).astype(jnp.float32))
    pm = convert.load_into(pt.QuantLinear(DIM, 96), to_numpy(params)).to(dtype)
    assert pm.weight_q.dtype == torch.int8
    assert pm.w_scale.dtype == pm.bias.dtype == torch.float32  # kept through .to(dtype)
    with torch.no_grad():
        got = pm(torch.tensor(x).to(dtype))
    assert got.dtype == dtype
    got = got.float().numpy()
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got, want)
    else:  # the rounding of the rescaled product that XLA's FMA skips, and the sum's
        product = np.abs(got - params["bias"]).astype(np.float32)
        assert (np.abs(got - want) <= np.spacing(product) + np.spacing(np.abs(want))).all()
        assert (got != want).any()  # (so the FMA is real, and this bound is needed)


def test_quant_vit_block_matches_jax():
    x = _x(B=2, N=36, seed=8)
    jm = jt.ViTBlock(DIM, HEADS, quant=True)
    params = random_params(init_shapes(jm, jnp.asarray(x)), seed=9)
    want = _jit_apply(jm, params, jnp.asarray(x))
    pm = convert.load_into(pt.ViTBlock(DIM, HEADS, quant=True), to_numpy(params))
    with torch.no_grad():
        got = pm(torch.tensor(x)).numpy()
    want_float = _jit_apply(jt.ViTBlock(DIM, HEADS), params, jnp.asarray(x))
    assert_int8_parity(got, want, want_float)


def test_set_int8_impl_switches_every_quant_layer():
    stack = pt.TransformerStack(2, DIM, HEADS, quant=True)
    layers = [m for m in stack.modules() if isinstance(m, pt.QuantLinear)]
    assert len(layers) == 2 * 4 and {m.int8_impl for m in layers} == {"kernel"}
    pt.set_int8_impl(stack, "plain")
    assert {m.int8_impl for m in layers} == {"plain"}
    with pytest.raises(ValueError):
        pt.set_int8_impl(stack, "xla")
    x = torch.tensor(_x(B=1, N=12, seed=10))
    with torch.no_grad():
        a = stack(x)
        pt.set_int8_impl(stack, "kernel")
        b = stack(x)  # CPU tensors: the kernel route is the plain version
    assert torch.equal(a, b)
