"""The CUDA attention kernels against their plain version, on the card.

Needs an NVIDIA GPU and nvcc; skips without a GPU. The machine with the card
has no JAX, so this file imports only torch and the port, and runs there
without the suite's conftest (which sets up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_attention_cuda.py

Tolerances are those of tests/test_ops.py: atol 2e-5 in fp32 and 3e-2 in
bf16; in bf16 also ||kernel - plain|| / ||plain|| <= 6e-3, chip_smoke.py's
limit that scales with the output (the bf16 roundings give about 2.5e-3, a
ragged KV edge left unmasked at N = 1000 1.4e-2). The shapes are the serving path's (N=144 at B=128 and B=1), the 256 px
path's (N=1024), ragged N, the single-pass kernel's limit (144) and past
it, and N beyond the TPU's single-pass limit of 2048, at head dimension 64
(12 heads); and at head dimension 128 (6 heads, mar_small) the 96 px
mar_small path's N = 144 and the kitchen path's N = 320 (a 64-row last KV
tile), for every kernel; at head dimension 80 (16 heads, mar_huge) its N =
144 and N = 1024, for every kernel, the online kernel's exact-width tiles
(a 64-column and a 16-column slab, each with its own TMA box and wgmma
descriptor) at ragged N (137, 500, 1000) in both work-item sizes, and the
head-width control: D = 80 views whose next 48 columns in memory hold NaN,
which every kernel must leave unread, and which a kernel reading 128
columns must fail. bf16 views off a 16-byte boundary go through the staging
copy (bit-equal to torch.stack) and then the TMA kernels. Each launch must
land on the kernel, and the instance, that attention_plan names. The fp32
kernel (3xTF32 on the tensor cores) is held at every head dimension at N =
1088, ragged N and N = 2304, on aligned and unaligned views, and at every
tile its sweep entry builds.
"""

import pytest
import torch

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu_torch.ops import attention as port

BF16_REL_RMS = 6e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _launch_matches_plain(q, k, v, atol):
    """One launch, of the kernel the plan names (after one launch of the
    staging copy where the plan is staged), within atol of the plain version."""
    B, N, H, D = q.shape
    plan = port.attention_plan(B, N, H, D, q.dtype, port._check(q, k, v))
    before = dict(port.launch_count)
    before_instances = dict(port.instance_count)
    got = port.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in port.launch_count.items()} == {
        n: int(n == plan.kernel or (n == port.STAGE and plan.staged)) for n in port.launch_count}
    assert {n: c - before_instances[n] for n, c in port.instance_count.items()} == {
        n: int(n == plan.instance) for n in port.INSTANCES}
    want = port.attention_plain(q, k, v)
    assert got.is_contiguous() and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    if q.dtype == torch.bfloat16:
        rel = (got.float() - want.float()).norm() / want.float().norm()
        assert rel <= BF16_REL_RMS, f"||kernel - plain|| / ||plain|| = {rel}"
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,N,H,dtype,atol",
    [
        (128, 144, 12, torch.bfloat16, 3e-2),
        (128, 144, 12, torch.float32, 2e-5),
        (4, 100, 12, torch.bfloat16, 3e-2),
        (4, 100, 12, torch.float32, 2e-5),
        (2, 1088, 12, torch.bfloat16, 3e-2),
        (1, 2304, 12, torch.float32, 2e-5),
        (1, 144, 12, torch.bfloat16, 3e-2),
        (8, 137, 12, torch.bfloat16, 3e-2),
        (8, 256, 12, torch.bfloat16, 3e-2),
        (8, 257, 12, torch.bfloat16, 3e-2),
        (1, 256, 12, torch.bfloat16, 3e-2),
        (3, 1, 12, torch.bfloat16, 3e-2),
    ],
)
def test_kernel_matches_plain_on_the_card(card, B, N, H, dtype, atol):
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(B, N, 3, H, 64, generator=g, device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    _launch_matches_plain(q, k, v, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,split", [(1, True), (4, True), (16, False)])
def test_the_single_pass_kernel_split_and_whole(card, B, split):
    g = torch.Generator(device="cuda").manual_seed(B)
    q, k, v = (torch.randn(B, 144, 12, 64, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    plan = _launch_matches_plain(q, k, v, 3e-2)
    assert plan == port.AttentionPlan("attention_wgmma", 64, split)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,split", [(1, 1024, True), (2, 1088, True), (8, 257, True),
                                       (1, 2304, True), (1, 1000, True), (8, 1000, False),
                                       (8, 1024, False), (8, 1088, False)])
def test_the_online_kernel_past_the_single_pass_limit(card, B, N, split):
    g = torch.Generator(device="cuda").manual_seed(N)
    qkv = torch.randn(B, N, 3, 12, 64, generator=g, device="cuda").to(torch.bfloat16)
    plan = _launch_matches_plain(*qkv.unbind(2), 3e-2)
    assert plan == port.AttentionPlan("attention_wgmma_online", 64, split)


@pytest.mark.cuda
def test_rows_off_a_16_byte_boundary_are_staged(card):
    B, N, H = 4, 144, 12
    g = torch.Generator(device="cuda").manual_seed(1)
    buf = torch.randn(B * N * 3 * H * 64 + 1, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = buf[1:].view(B, N, 3, H, 64).unbind(2)
    assert not port._check(q, k, v)
    assert _launch_matches_plain(q, k, v, 3e-2) == port.AttentionPlan("attention_wgmma", 64, True, True)


@pytest.mark.cuda
@pytest.mark.parametrize("D,H", [(64, 12), (80, 16), (128, 6)])
@pytest.mark.parametrize("offset_bytes", [2, 4, 8, 16])
def test_the_staging_copy_is_bit_equal_to_stack(card, D, H, offset_bytes):
    # views whose base lies 2, 4, 8 or 16 bytes past a 16-byte boundary (the
    # copy's 2-, 4-, 8- and 16-byte loads), and a q with rows of a wider
    # tensor: one launch, bit-equal to torch.stack, into views TMA can read
    B, N = 3, 201
    g = torch.Generator(device="cuda").manual_seed(D + offset_bytes)
    buf = torch.randn(B * N * 3 * H * D + 8, generator=g, device="cuda").to(torch.bfloat16)
    qkv = buf[offset_bytes // 2:][:B * N * 3 * H * D].view(B, N, 3, H, D)
    _, k, v = qkv.unbind(2)
    q = torch.randn(B, N, H, D + 8, generator=g, device="cuda").to(torch.bfloat16)[..., 4:4 + D]
    before = port.launch_count[port.STAGE]
    staged = port.stage_qkv(q, k, v)
    torch.cuda.synchronize()
    assert port.launch_count[port.STAGE] == before + 1
    assert port._check(*staged)
    for got, want in zip(staged, (q, k, v)):
        assert torch.equal(got, want)


# head dimension 128 (mar_small: 768 over 6 heads): the 96 px path's N = 144
# (the single-pass kernel, split at B = 1), the kitchen path's N = 320 (the
# online kernel, KV tiles of 128, 128 and 64 rows), ragged N, unaligned views
# (staged, then the TMA kernel of the aligned call) and fp32 (3xTF32)
@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,N,dtype,aligned,kernel,atol",
    [
        (1, 144, torch.bfloat16, True, "attention_wgmma", 3e-2),
        (128, 144, torch.bfloat16, True, "attention_wgmma", 3e-2),
        (8, 137, torch.bfloat16, True, "attention_wgmma", 3e-2),
        (1, 320, torch.bfloat16, True, "attention_wgmma_online", 3e-2),
        (16, 320, torch.bfloat16, True, "attention_wgmma_online", 3e-2),
        (128, 320, torch.bfloat16, True, "attention_wgmma_online", 3e-2),
        (8, 1000, torch.bfloat16, True, "attention_wgmma_online", 3e-2),
        (8, 320, torch.bfloat16, False, "attention_wgmma_online", 3e-2),
        (4, 137, torch.bfloat16, False, "attention_wgmma", 3e-2),
        (128, 144, torch.float32, True, "attention_f32", 2e-5),
        (4, 320, torch.float32, True, "attention_f32", 2e-5),
        (4, 100, torch.float32, False, "attention_f32", 2e-5),
    ],
)
def test_head_dim_128_on_the_card(card, B, N, dtype, aligned, kernel, atol):
    H, D = 6, 128
    g = torch.Generator(device="cuda").manual_seed(N + B)
    shape = (B, N, 3, H, D)
    flat = torch.randn(B * N * 3 * H * D + (not aligned), generator=g, device="cuda").to(dtype)
    q, k, v = flat[int(not aligned):].view(shape).unbind(2)
    assert port._check(q, k, v) == aligned
    plan = _launch_matches_plain(q, k, v, atol)
    assert (plan.kernel, plan.head_dim, plan.staged) == (kernel, D, not aligned and dtype == torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,split", [(1, 144, True), (64, 144, True), (1, 320, True),
                                       (1, 320, False), (128, 320, True), (128, 320, False)])
def test_head_dim_128_both_work_item_sizes(card, B, N, split):
    # each instance of each TMA kernel at D = 128 (the single pass has only
    # its split one), whatever the plan would pick, against the plain version
    g = torch.Generator(device="cuda").manual_seed(7 * N + B)
    q, k, v = torch.randn(B, N, 3, 6, 128, generator=g, device="cuda").to(torch.bfloat16).unbind(2)
    out = torch.empty(B, N, 6, 128, dtype=torch.bfloat16, device="cuda")
    lib = port._lib()
    fn = lib.uva_flash_attention_wgmma if N <= port.SINGLE_PASS_MAX_N else lib.uva_flash_attention_online
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, 6, 128,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(split),
            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want = port.attention_plain(q, k, v).float()
    torch.testing.assert_close(out.float(), want, rtol=0, atol=3e-2)
    assert (out.float() - want).norm() / want.norm() <= BF16_REL_RMS


@pytest.mark.cuda
def test_head_dim_128_has_no_whole_head_single_pass(card):
    q, k, v = torch.zeros(4, 144, 3, 6, 128, dtype=torch.bfloat16, device="cuda").unbind(2)
    out = torch.empty(4, 144, 6, 128, dtype=torch.bfloat16, device="cuda")
    rc = port._lib().uva_flash_attention_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 4, 144, 6, 128,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 0, torch.cuda.current_stream().cuda_stream)
    assert rc != 0


@pytest.mark.cuda
def test_a_head_dim_without_an_instance_raises(card):
    q = torch.zeros(1, 16, 16, 48, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="D=48"):
        port.flash_attention(q, q, q)


# head dimension 80 (mar_huge: 1280 over 16 heads): the 96 px path's N = 144
# (the single pass, always split, in D = 128's layout with columns 80-127
# from TMA's zero fill), the 256 px path's N = 1024 (the online kernel at
# exact width), ragged N, unaligned views (staged, then the TMA kernel of the
# aligned call) and fp32 (exact width: ten k-steps and n-tiles of 8)
@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,N,dtype,aligned,kernel,atol",
    [
        (1, 144, torch.bfloat16, True, "attention_wgmma", 3e-2),
        (128, 144, torch.bfloat16, True, "attention_wgmma", 3e-2),
        (8, 137, torch.bfloat16, True, "attention_wgmma", 3e-2),
        (3, 1, torch.bfloat16, True, "attention_wgmma", 3e-2),
        (1, 1024, torch.bfloat16, True, "attention_wgmma_online", 3e-2),
        (8, 1024, torch.bfloat16, True, "attention_wgmma_online", 3e-2),
        (4, 1000, torch.bfloat16, True, "attention_wgmma_online", 3e-2),
        (8, 1024, torch.bfloat16, False, "attention_wgmma_online", 3e-2),
        (4, 137, torch.bfloat16, False, "attention_wgmma", 3e-2),
        (128, 144, torch.float32, True, "attention_f32", 2e-5),
        (2, 1024, torch.float32, True, "attention_f32", 2e-5),
        (4, 100, torch.float32, False, "attention_f32", 2e-5),
    ],
)
def test_head_dim_80_on_the_card(card, B, N, dtype, aligned, kernel, atol):
    H, D = 16, 80
    g = torch.Generator(device="cuda").manual_seed(N + B + 80)
    shape = (B, N, 3, H, D)
    flat = torch.randn(B * N * 3 * H * D + (not aligned), generator=g, device="cuda").to(dtype)
    q, k, v = flat[int(not aligned):].view(shape).unbind(2)
    assert port._check(q, k, v) == aligned
    plan = _launch_matches_plain(q, k, v, atol)
    assert (plan.kernel, plan.head_dim, plan.staged) == (kernel, D, not aligned and dtype == torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,split", [(1, 144, True), (64, 144, True), (1, 1024, True),
                                       (1, 1024, False), (8, 1024, True), (8, 1000, False)])
def test_head_dim_80_both_work_item_sizes(card, B, N, split):
    # each instance of each TMA kernel at D = 80 (the single pass has only
    # its split one), whatever the plan would pick, against the plain version
    g = torch.Generator(device="cuda").manual_seed(5 * N + B)
    q, k, v = torch.randn(B, N, 3, 16, 80, generator=g, device="cuda").to(torch.bfloat16).unbind(2)
    out = torch.empty(B, N, 16, 80, dtype=torch.bfloat16, device="cuda")
    lib = port._lib()
    fn = lib.uva_flash_attention_wgmma if N <= port.SINGLE_PASS_MAX_N else lib.uva_flash_attention_online
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, 16, 80,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(split),
            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want = port.attention_plain(q, k, v).float()
    torch.testing.assert_close(out.float(), want, rtol=0, atol=3e-2)
    assert (out.float() - want).norm() / want.norm() <= BF16_REL_RMS


@pytest.mark.cuda
@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("N", [137, 500, 1000])
def test_head_dim_80_online_tiles_at_ragged_n(card, N, B, split):
    # the online kernel's exact-width D = 80 tiles (a wrong 32-byte-swizzle
    # descriptor or barrier count gives finite, wrong numbers) at ragged N:
    # one KV tile of 137 rows, a last one of 116 (500) or 104 (1000), in
    # both work-item sizes, whatever the plan would pick
    g = torch.Generator(device="cuda").manual_seed(11 * N + B)
    q, k, v = torch.randn(B, N, 3, 16, 80, generator=g, device="cuda").to(torch.bfloat16).unbind(2)
    out = torch.full((B, N, 16, 80), float("nan"), dtype=torch.bfloat16, device="cuda")
    rc = port._lib().uva_flash_attention_online(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, 16, 80,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(split), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want = port.attention_plain(q, k, v).float()
    torch.testing.assert_close(out.float(), want, rtol=0, atol=3e-2)
    assert (out.float() - want).norm() / want.norm() <= BF16_REL_RMS


@pytest.mark.cuda
def test_head_dim_80_has_no_whole_head_single_pass(card):
    q, k, v = torch.zeros(4, 144, 3, 16, 80, dtype=torch.bfloat16, device="cuda").unbind(2)
    out = torch.empty(4, 144, 16, 80, dtype=torch.bfloat16, device="cuda")
    rc = port._lib().uva_flash_attention_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 4, 144, 16, 80,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 0, torch.cuda.current_stream().cuda_stream)
    assert rc != 0


def _nan_neighbours(B, N, H, dtype, seed):
    """q, k, v: (B, N, H, 80) views of one (B, N, 3, H, 128) buffer whose
    columns 80-127 hold NaN, and the buffer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn(B, N, 3, H, 128, generator=g, device="cuda").to(dtype)
    buf[..., 80:] = float("nan")
    q, k, v = buf[..., :80].unbind(2)
    return q, k, v, buf


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,dtype", [(1, 144, torch.bfloat16), (128, 144, torch.bfloat16),
                                       (1, 1024, torch.bfloat16), (8, 1000, torch.bfloat16),
                                       (4, 144, torch.float32)])
def test_head_dim_80_reads_no_column_past_80(card, B, N, dtype):
    q, k, v, _ = _nan_neighbours(B, N, 16, dtype, seed=N + B)
    assert port._check(q, k, v)  # aligned: the TMA kernels take these views
    got = port.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _launch_matches_plain(q, k, v, 3e-2 if dtype == torch.bfloat16 else 2e-5)


def _reads_128_columns(buf):
    """The planted fault: the D = 128 instance on the whole (B, N, H, 128)
    rows (q scaled by sqrt(128 / 80), so that with zeros past column 79 it
    computes the D = 80 function), cut back to 80 columns."""
    q, k, v = buf.unbind(2)
    return port.flash_attention(q * (128 / 80) ** 0.5, k, v)[..., :80]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(1, 144), (2, 1024)])
def test_the_head_width_control_rejects_a_kernel_reading_128_columns(card, B, N):
    q, k, v, buf = _nan_neighbours(B, N, 16, torch.bfloat16, seed=3 * N + B)
    want = port.attention_plain(q, k, v).float()
    assert not bool(torch.isfinite(_reads_128_columns(buf)).all())
    zeros = buf.clone()
    zeros[..., 80:] = 0
    fine = _reads_128_columns(zeros).float()
    torch.testing.assert_close(fine, want, rtol=0, atol=3e-2)


# the fp32 kernel (3xTF32 on the tensor cores) at every head dimension:
# N = 1088 (17 KV tiles of 64), ragged N (a last KV tile short of the tile,
# and a last q-tile of a few rows), N = 2304 (the accumulator's longest
# chain in these tests), on aligned views of one qkv tensor and on views an
# element off a 16-byte boundary (4-byte copies)
@pytest.mark.cuda
@pytest.mark.parametrize("D,H", [(64, 12), (80, 16), (128, 6)])
@pytest.mark.parametrize("B,N,aligned", [(2, 1088, True), (2, 1088, False), (3, 201, True),
                                         (3, 201, False), (2, 77, True), (2, 77, False),
                                         (1, 2304, True)])
def test_fp32_kernel_at_every_head_dim(card, D, H, B, N, aligned):
    g = torch.Generator(device="cuda").manual_seed(N + D + B)
    flat = torch.randn(B * N * 3 * H * D + (not aligned), generator=g, device="cuda")
    q, k, v = flat[int(not aligned):].view(B, N, 3, H, D).unbind(2)
    assert port._check(q, k, v) == aligned
    plan = _launch_matches_plain(q, k, v, 2e-5)
    assert plan == port.AttentionPlan("attention_f32", D)


@pytest.mark.cuda
@pytest.mark.parametrize("D,H", [(64, 12), (80, 16), (128, 6)])
@pytest.mark.parametrize("m_tiles,kv_rows", [(1, 32), (1, 48), (1, 64), (2, 32), (2, 64)])
@pytest.mark.parametrize("B,N", [(2, 144), (1, 1000)])
def test_every_fp32_tile(card, D, H, m_tiles, kv_rows, B, N):
    # each tile the fp32 kernel's sweep entry builds (two m16 tiles a warp at
    # D = 64 only: the entry refuses them elsewhere), whatever the wrapper
    # would pick, against the plain version
    g = torch.Generator(device="cuda").manual_seed(N + D + kv_rows)
    q, k, v = torch.randn(B, N, 3, H, D, generator=g, device="cuda").unbind(2)
    out = torch.full((B, N, H, D), float("nan"), device="cuda")
    rc = port._lib().uva_flash_attention_tf32_tile(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], m_tiles, kv_rows,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if m_tiles == 2 and D != 64:
        assert rc != 0
        return
    assert rc == 0
    torch.testing.assert_close(out, port.attention_plain(q, k, v), rtol=0, atol=2e-5)
