"""The CUDA int8 kernels (csrc/int8_mm.cu) against their plain versions, on
the card, at the shapes of the deployed serving tier and at ragged ones.

Needs an NVIDIA GPU and nvcc; skips without a GPU. The machine with the card
has no JAX, so this file imports only torch and the port, and runs there
without the suite's conftest (which sets up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_int8_cuda.py

Tolerance: none. The kernels repeat the plain version's arithmetic operation
for operation (IEEE division, round half to even, the s8 product exact in
int32 in any order, the rescale and the bias add each rounded once), so x_q,
x_scale, the s32 product and the layer output must be bit-equal.

Shapes (M, K, N): those of chip_smoke.py's kernel phase, the deployed
tier's W8A8 layers at mar_base width: the MAR's qkv, proj, mlp_fc1 and
mlp_fc2 (M = 144 tokens per sample) and the action denoiser's ada_mod,
fc1/fc2, final.ada_mod, cond_embed and the K = 2 input_proj (M = 16 slots
per sample), at B=128 and B=1, and the ragged (100, 128, 130). Each runs
with bf16 and with fp32 activations, with an outlier row and an all-zero
row, through the wrapper's dispatch (gemm_plan). Then the wgmma kernel at
ragged M and N with a K that ends inside a 128-byte tile, in each output
type, and an operand that is not 16-byte aligned, which only the mma.sync
kernel takes.
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
RAGGED = [(M, 784, N) for M in (1, 16, 63, 64, 65, 144, 2048) for N in (130, 1000)]
OUT_DTYPES = [torch.int32, torch.bfloat16, torch.float32]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _inputs(M, K, N, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, generator=g, device="cuda")
    x[0] *= 100.0  # an outlier row
    if M > 1:
        x[1] = 0.0  # an all-zero row: the 1e-12 scale floor
    w = torch.randn(K, N, generator=g, device="cuda") / K ** 0.5
    w_q, w_scale = quant.quantize_weight(w)
    bias = 0.1 * torch.randn(N, generator=g, device="cuda")
    return x.to(dtype), w_q.T.contiguous(), w_scale, bias


def _gemm_launches():
    return sum(int8_mm.launch_count[k] for k in int8_mm.GEMM_KERNELS)


def _gemm_matches_plain(x_q, x_scale, w_q, w_scale, bias, out_dtype):
    """The GEMM against the plain version: one launch, of the kernel the
    dispatch plans, and a bit-equal result."""
    M, K = x_q.shape
    aligned = x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0
    kernel = int8_mm.gemm_plan(M, w_q.shape[0], K, aligned).kernel
    before = dict(int8_mm.launch_count)
    if out_dtype == torch.int32:
        got = int8_mm.int8_gemm(x_q, w_q)
    else:
        got = int8_mm.int8_gemm(x_q, w_q, x_scale, w_scale, bias, out_dtype)
    torch.cuda.synchronize()
    assert {k: int8_mm.launch_count[k] - before[k] for k in int8_mm.GEMM_KERNELS} == {
        k: int(k == kernel) for k in int8_mm.GEMM_KERNELS}
    want = quant.int8_gemm_plain(x_q, w_q)
    if out_dtype != torch.int32:
        want = quant.rescale_plain(want, x_scale, w_scale, bias, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_kernels_match_plain_on_the_card(card, M, K, N, dtype):
    x, w_q, w_scale, bias = _inputs(M, K, N, dtype, seed=M + K + N)
    before = dict(int8_mm.launch_count)
    gemms = _gemm_launches()
    x_q, x_scale = int8_mm.quantize_rows(x)
    y = int8_mm.int8_gemm(x_q, w_q)
    out = int8_mm.w8a8_linear(x, w_q, w_scale, bias)
    torch.cuda.synchronize()
    assert int8_mm.launch_count["quantize_rows"] == before["quantize_rows"] + 2
    assert _gemm_launches() == gemms + 2
    want_q, want_scale = quant.quantize_rows_plain(x)
    assert torch.equal(x_q, want_q) and torch.equal(x_scale, want_scale)
    assert torch.equal(y, quant.int8_gemm_plain(want_q, w_q))
    want = quant.w8a8_linear_plain(x, w_q, w_scale, bias)
    assert out.dtype == dtype and torch.equal(out, want)
    _gemm_matches_plain(want_q, want_scale, w_q, w_scale, bias, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("M,K,N", RAGGED)
def test_wgmma_kernel_at_ragged_shapes(card, M, K, N, out_dtype):
    x, w_q, w_scale, bias = _inputs(M, K, N, torch.bfloat16, seed=M + N)
    x_q, x_scale = quant.quantize_rows_plain(x)
    assert int8_mm.gemm_plan(M, N, K).variant == "wgmma"
    _gemm_matches_plain(x_q, x_scale, w_q, w_scale, bias, out_dtype)


def _off_boundary(t):
    """A contiguous copy of ``t`` that starts one byte past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    off = buf[1:].view(t.shape)
    off.copy_(t)
    return off


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["x_q", "weight"])
def test_a_misaligned_operand_takes_the_mma_sync_kernel(card, which):
    M, K, N = 144, 768, 768
    x, w_q, w_scale, bias = _inputs(M, K, N, torch.bfloat16, seed=3)
    x_q, x_scale = quant.quantize_rows_plain(x)
    if which == "x_q":
        x_q = _off_boundary(x_q)
    else:
        w_q = _off_boundary(w_q)
    assert int8_mm.gemm_plan(M, N, K, aligned=False) == int8_mm.MMA_SYNC
    for out_dtype in OUT_DTYPES:
        _gemm_matches_plain(x_q, x_scale, w_q, w_scale, bias, out_dtype)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
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
    # the wgmma entry point itself refuses what TMA cannot read, and a tile
    # it has no kernel for (cudaErrorInvalidValue)
    x_q = torch.zeros(8, 32, dtype=torch.int8, device="cuda")
    out = torch.empty(8, 16, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    wgmma = int8_mm._lib().uva_int8_gemm_wgmma
    for x_ptr, K, bm, bn in ((x_q.data_ptr() + 1, 32, 64, 64), (x_q.data_ptr(), 24, 64, 64),
                             (x_q.data_ptr(), 32, 64, 128)):
        assert wgmma(x_ptr, 0, w_q.data_ptr(), 0, 0, out.data_ptr(), 8, 16, K, 2, 0, bm, bn,
                     stream) == 1
