"""Port of the W8A8 arithmetic (ops/quant.py, ops/int8_mm.py) against the JAX
package on the CPU.

The JAX functions run under ``jax.jit``, as the serving program runs them:
XLA then folds ``amax / 127.0`` into a multiplication by fl32(1/127), which
the port does too, while JAX's eager dispatch divides (one ulp apart for
about 5 % of scales). The Pallas kernel runs in interpret mode.

Tolerance: none. Quantization is elementwise fp32 arithmetic in the same
order, the s8 product is exact in int32 on both sides, and the rescale is
two fp32 products, so weights, scales, x_q, the s32 product and the fp32
layer output are bit-equal. Shapes: the Pallas kernel's tests
(tests/test_int8_mm.py), a middle one, and the denoiser's K = 2 input
projection; each with an outlier row and an all-zero row (the 1e-12 floor).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu.ops import int8_mm as jint8
from unified_video_action_tpu.ops import quant as jquant
from unified_video_action_tpu_torch.ops import int8_mm, quant

SHAPES = [(256, 768, 256), (100, 128, 130), (384, 768, 512), (16, 2, 1024)]

_jit_int8_matmul = jax.jit(jquant.int8_matmul)
_jit_pallas_w8a8 = jax.jit(functools.partial(jint8.w8a8_matmul, backend="pallas", interpret=True))


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[3] *= 50.0
    x[5] = 0.0
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    w[:, 7] = 0.0  # an all-zero output channel
    return x, w


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_quantize_weight_is_bit_equal(M, K, N):
    _, w = _inputs(M, K, N)
    want = jax.jit(jquant.quantize_weight)(jnp.asarray(w))
    w_q, scale = quant.quantize_weight(torch.tensor(w))
    assert w_q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(want["kernel_q"]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want["scale"]))


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_w8a8_is_bit_equal_to_jax(M, K, N):
    x, w = _inputs(M, K, N, seed=M)
    jq = jax.jit(jquant.quantize_weight)(jnp.asarray(w))
    kernel_q, w_scale = np.asarray(jq["kernel_q"]), np.asarray(jq["scale"])
    weight_q = torch.tensor(kernel_q.T.copy())  # the port keeps the (N, K) layout

    x_q, x_scale = quant.quantize_rows_plain(torch.tensor(x))
    # x_q and x_scale through JAX's own layer: against the identity its
    # output is fl(x_q · x_scale) per element
    eye = jnp.eye(K, dtype=jnp.int8)
    want_qs = np.asarray(_jit_int8_matmul(jnp.asarray(x), eye, jnp.ones((K,), jnp.float32)))
    np.testing.assert_array_equal((x_q.float() * x_scale[:, None]).numpy(), want_qs)
    assert (x_q[5] == 0).all() and x_scale[5].item() == np.float32(1e-12)

    # the s32 product against the Pallas kernel on the same operands
    y = quant.int8_gemm_plain(x_q, weight_q)
    want_y = jint8.int8_matmul_pallas(jnp.asarray(x_q.numpy()), jnp.asarray(kernel_q),
                                      bm=128, bn=128, interpret=True)
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))

    got = quant.w8a8_linear_plain(torch.tensor(x), weight_q, torch.tensor(w_scale)).numpy()
    want_xla = np.asarray(_jit_int8_matmul(jnp.asarray(x), jnp.asarray(kernel_q), jnp.asarray(w_scale)))
    want_pallas = np.asarray(_jit_pallas_w8a8(jnp.asarray(x), jnp.asarray(kernel_q), jnp.asarray(w_scale)))
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)


def test_bf16_layer_casts_then_adds_the_bias_in_bf16():
    # models/transformer.py:78-79: y = int8_matmul(x) in x's dtype, then
    # y + bias.astype(y.dtype)
    x, w = _inputs(32, 64, 48, seed=3)
    bias = np.random.default_rng(4).standard_normal(48).astype(np.float32)
    jq = jax.jit(jquant.quantize_weight)(jnp.asarray(w))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax.jit(lambda x, k, s, b: (y := jquant.int8_matmul(x, k, s)) + b.astype(y.dtype))(
        xb, jq["kernel_q"], jq["scale"], jnp.asarray(bias))
    weight_q = torch.tensor(np.asarray(jq["kernel_q"]).T.copy())
    got = quant.w8a8_linear_plain(torch.tensor(x).bfloat16(), weight_q,
                                  torch.tensor(np.asarray(jq["scale"])), torch.tensor(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    x, w = _inputs(40, 64, 24, seed=5)
    w_q, w_scale = quant.quantize_weight(torch.tensor(w))
    weight_q = w_q.T.contiguous()
    before = dict(int8_mm.launch_count)
    xq, xs = int8_mm.quantize_rows(torch.tensor(x))
    y = int8_mm.int8_gemm(xq, weight_q)
    out = int8_mm.w8a8_linear(torch.tensor(x).reshape(2, 20, 64), weight_q, w_scale)
    assert int8_mm.launch_count == before
    want_q, want_s = quant.quantize_rows_plain(torch.tensor(x))
    assert torch.equal(xq, want_q) and torch.equal(xs, want_s)
    assert torch.equal(y, quant.int8_gemm_plain(want_q, weight_q))
    rescaled = int8_mm.int8_gemm(xq, weight_q, xs, w_scale, None, torch.float32)
    assert torch.equal(rescaled, quant.rescale_plain(y, xs, w_scale, None, torch.float32))
    assert out.shape == (2, 20, 24)
    assert torch.equal(out.reshape(40, 24), quant.w8a8_linear_plain(torch.tensor(x), weight_q, w_scale))


def test_int32_product_is_exact_where_float32_is_not():
    # 127² · 3072 > 2²⁴: every partial sum must stay exact
    x_q = torch.full((2, 3072), 127, dtype=torch.int8)
    x_q[1, 0] = -126
    w_q = torch.full((3, 3072), 127, dtype=torch.int8)
    y = quant.int8_gemm_plain(x_q, w_q)
    assert y[0, 0].item() == 127 * 127 * 3072
    assert y[1, 0].item() == 127 * 127 * 3071 - 126 * 127


# The CPU route of the s8 product (torch._int_mm, int32 accumulation) against
# the float64 product that stays the card's oracle, at the flagship's W8A8
# shapes at B=2 of a runner stream of 25 envs (MAR: 144 tokens a sample; the
# denoiser: 16 action tokens a sample), with rows and columns at +-127 so
# that the partial sums reach 127² · K.
PATH_SHAPES = [(25 * 144, 768, 2304), (25 * 144, 768, 768), (25 * 144, 768, 3072),
               (25 * 144, 3072, 768), (25 * 16, 1024, 1024), (25 * 16, 1024, 3072),
               (25 * 16, 768, 1024), (25 * 16, 2, 1024), (16, 1024, 1024), (1, 768, 768)]


@pytest.mark.parametrize("M,K,N", PATH_SHAPES)
def test_cpu_int8_product_equals_the_float64_product(M, K, N):
    gen = torch.Generator().manual_seed(M + K + N)
    x_q = torch.randint(-127, 128, (M, K), dtype=torch.int8, generator=gen)
    w_q = torch.randint(-127, 128, (N, K), dtype=torch.int8, generator=gen)
    x_q[0], w_q[0], w_q[1] = 127, 127, -127
    y = quant.int8_gemm_plain(x_q, w_q)
    want = (x_q.double() @ w_q.double().T).to(torch.int32)
    assert y.dtype == torch.int32 and torch.equal(y, want)
    assert y[0, 0] == 127 * 127 * K and y[0, 1] == -127 * 127 * K
