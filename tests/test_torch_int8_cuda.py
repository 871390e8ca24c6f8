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
per sample), at B=128 and B=1, mar_huge's MAR layers at B=128 (d = 1280:
K = 1280 and the fc2 input's K = 5120), and the ragged (100, 128, 130). Each runs
with bf16 and with fp32 activations, with an outlier row and an all-zero
row, through the wrappers' dispatch (quantize_plan, gemm_plan). Then the
wgmma kernel at ragged M and N with a K that ends inside a 128-byte tile, in
each output type, and an operand that is not 16-byte aligned, which only the
mma.sync kernel takes; and quantize_rows at K % 8 != 0, past the vector
kernel's widest row, and on rows off a 16-byte boundary, which only the
scalar kernel takes.
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


# mar_huge's qkv, proj, mlp_fc1 and mlp_fc2 at B=128 (144 tokens a sample)
HUGE_SHAPES = [(18432, 1280, 3840), (18432, 1280, 1280), (18432, 1280, 5120), (18432, 5120, 1280)]
SHAPES = _path_shapes(128) + _path_shapes(1) + HUGE_SHAPES + [(100, 128, 130)]
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


def _quantize_matches_plain(x):
    """quantize_rows against the plain version: one launch, of the kernel
    the plan names, and bit-equal x_q and x_scale."""
    plan = int8_mm.quantize_plan(x.shape[1], x.dtype, x.data_ptr() % 16 == 0)
    before = dict(int8_mm.launch_count)
    x_q, x_scale = int8_mm.quantize_rows(x)
    torch.cuda.synchronize()
    assert {k: int8_mm.launch_count[k] - before[k] for k in int8_mm.QUANT_KERNELS} == {
        k: int(k == plan.kernel) for k in int8_mm.QUANT_KERNELS}
    want_q, want_scale = quant.quantize_rows_plain(x)
    assert torch.equal(x_q, want_q) and torch.equal(x_scale, want_scale)
    return plan


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
    quantize_kernel = int8_mm.quantize_plan(K, dtype).kernel
    before = dict(int8_mm.launch_count)
    gemms = _gemm_launches()
    x_q, x_scale = int8_mm.quantize_rows(x)
    y = int8_mm.int8_gemm(x_q, w_q)
    out = int8_mm.w8a8_linear(x, w_q, w_scale, bias)
    torch.cuda.synchronize()
    assert {k: int8_mm.launch_count[k] - before[k] for k in int8_mm.QUANT_KERNELS} == {
        k: 2 * (k == quantize_kernel) for k in int8_mm.QUANT_KERNELS}
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K", [(18432, 768), (2048, 3072), (16, 1024), (1, 768), (100, 136),
                                 (63, 1000), (64, 1028), (33, 4096), (5, 2), (1, 3),
                                 (18432, 5120), (144, 5120), (7, 5128)])
def test_quantize_rows_at_every_kind_of_row(card, M, K, dtype):
    """The vector kernel where a row fits one (K % 8 == 0, K <= 5120 in bf16,
    mar_huge's fc2 input, and 1024 in fp32), the scalar one elsewhere: both
    bit-equal."""
    x = _inputs(M, K, 8, dtype, seed=M + K)[0]
    plan = _quantize_matches_plain(x)
    assert plan.variant == ("vector" if K % 8 == 0 and K <= {torch.bfloat16: 5120,
                                                             torch.float32: 1024}[dtype]
                            else "scalar")
    if plan.variant == "vector" and dtype == torch.bfloat16 and K > 3072:
        assert plan.per_lane == 20


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_rows_on_rows_off_a_16_byte_boundary(card, dtype):
    x = _off_boundary(_inputs(144, 768, 8, dtype, seed=5)[0])
    assert x.data_ptr() % 16 != 0
    assert _quantize_matches_plain(x) == int8_mm.QUANT_SCALAR


@pytest.mark.cuda
def test_quantize_rows_ties_round_half_to_even(card):
    """Rows whose scale is a power of two put many quotients exactly on
    k + 0.5: the vector kernel's rounding must take the even neighbour."""
    amax = 127.0 / 64  # scale fl(amax * fl(1/127)) = 2^-6 exactly
    x = torch.arange(-254, 258, dtype=torch.float32, device="cuda").repeat(4, 1) / 128
    x[:, 0] = amax
    x = x.clamp(-amax, amax)
    for dtype in (torch.bfloat16, torch.float32):
        assert _quantize_matches_plain(x.to(dtype)).variant == "vector"
