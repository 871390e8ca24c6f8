"""The CUDA int8 kernels (csrc/int8_mm.cu) against their plain versions, on
the card, at the shapes of the deployed serving tier.

Needs an NVIDIA GPU and nvcc; skips without a GPU. The machine with the card
has no JAX, so this file imports only torch and the port, and runs there
without the suite's conftest (which sets up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_int8_cuda.py

Tolerance: none. The kernels repeat the plain version's arithmetic operation
for operation (IEEE division, round half to even, the s8 product exact in
int32, the rescale and the bias add each rounded once), so x_q, x_scale, the
s32 product and the layer output must be bit-equal.

Shapes (M, K, N): those of chip_smoke.py's kernel phase, the deployed
tier's W8A8 layers at mar_base width: the MAR's qkv, proj, mlp_fc1 and
mlp_fc2 (M = 144 tokens per sample) and the action denoiser's ada_mod,
fc1/fc2, final.ada_mod, cond_embed and the K = 2 input_proj (M = 16 slots
per sample), at B=128 and B=1, and the ragged (100, 128, 130). Each runs
with bf16 and with fp32 activations, with an outlier row and an all-zero
row.
"""

import pytest
import torch

from unified_video_action_tpu_torch.ops import int8_mm
from unified_video_action_tpu_torch.ops import quant


def _path_shapes(B):
    mar, den = 144 * B, 16 * B
    return [(mar, 768, 2304), (mar, 768, 768), (mar, 768, 3072), (mar, 3072, 768),
            (den, 1024, 3072), (den, 1024, 1024), (den, 1024, 2048), (den, 768, 1024),
            (den, 2, 1024)]


SHAPES = _path_shapes(128) + _path_shapes(1) + [(100, 128, 130)]


def _inputs(M, K, N, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, generator=g, device="cuda")
    x[0] *= 100.0  # an outlier row
    x[1] = 0.0  # an all-zero row: the 1e-12 scale floor
    w = torch.randn(K, N, generator=g, device="cuda") / K ** 0.5
    w_q, w_scale = quant.quantize_weight(w)
    bias = 0.1 * torch.randn(N, generator=g, device="cuda")
    return x.to(dtype), w_q.T.contiguous(), w_scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_kernels_match_plain_on_the_card(M, K, N, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    x, w_q, w_scale, bias = _inputs(M, K, N, dtype, seed=M + K + N)
    before = dict(int8_mm.launch_count)
    x_q, x_scale = int8_mm.quantize_rows(x)
    y = int8_mm.int8_gemm(x_q, w_q)
    out = int8_mm.w8a8_linear(x, w_q, w_scale, bias)
    torch.cuda.synchronize()
    assert int8_mm.launch_count["quantize_rows"] == before["quantize_rows"] + 2
    assert int8_mm.launch_count["int8_gemm"] == before["int8_gemm"] + 2
    want_q, want_scale = quant.quantize_rows_plain(x)
    assert torch.equal(x_q, want_q) and torch.equal(x_scale, want_scale)
    assert torch.equal(y, quant.int8_gemm_plain(want_q, w_q))
    want = quant.w8a8_linear_plain(x, w_q, w_scale, bias)
    assert out.dtype == dtype and torch.equal(out, want)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    x = torch.randn(8, 32, device="cuda")
    w_q = torch.zeros(16, 32, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="float32 or"):
        int8_mm.quantize_rows(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        int8_mm.quantize_rows(x.T)
    with pytest.raises(ValueError, match="weight_q"):
        int8_mm.int8_gemm(torch.zeros(8, 32, dtype=torch.int8, device="cuda"), w_q[:, :16])
    with pytest.raises(ValueError, match="w_scale"):
        int8_mm.w8a8_linear(x, w_q, torch.ones(15, device="cuda"))
    with pytest.raises(ValueError, match="is on"):
        int8_mm.w8a8_linear(x, w_q.cpu(), torch.ones(16, device="cuda"))
