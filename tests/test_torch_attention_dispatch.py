"""The attention wrapper's dispatch (ops/attention.py:attention_plan) on the
CPU: which kernel the serving shapes get (the single-pass wgmma kernel at
(B, 144, 12, 64) bf16, split into one CTA per q-tile at small B; the
online-softmax wgmma kernel at the 256 px path's (B, 1024, 12, 64), in
64-row work items at small B), where the single-pass kernel stops (N = 144)
and the online kernel takes over, that an operand off a 16-byte boundary
takes the plan of the aligned call, staged (copied by the staging kernel
into one buffer TMA can read; its plain version on CPU tensors returns
views the check calls aligned, equal to the inputs), that fp32 takes the
3xTF32 kernel, and that plans are cached and name the launch counters. At head dimension 128 (mar_small,
6 heads) the same kernels at the 96 px mar_small path's N = 144 and the
kitchen path's N = 320, with their own split thresholds; at head dimension
80 (mar_huge, 16 heads) the same kernels at its N = 144 and N = 1024; a
head dimension with no instance raises. The kernels themselves run only on
the card (tests/test_torch_attention_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from unified_video_action_tpu_torch.ops import attention
from unified_video_action_tpu_torch.ops.attention import AttentionPlan, attention_plan

BF16 = torch.bfloat16


@pytest.mark.parametrize("B,split", [(1, True), (2, True), (7, True), (8, False), (128, False)])
def test_the_serving_shape_takes_the_single_pass_kernel(B, split):
    assert attention_plan(B, 144, 12, 64, BF16) == AttentionPlan("attention_wgmma", 64, split)


@pytest.mark.parametrize("N,kernel", [(1, "attention_wgmma"), (100, "attention_wgmma"),
                                      (137, "attention_wgmma"), (144, "attention_wgmma"),
                                      (145, "attention_wgmma_online"), (200, "attention_wgmma_online"),
                                      (256, "attention_wgmma_online")])
def test_the_smallest_instance_that_holds_n(N, kernel):
    # the single-pass kernel holds 144 rows; past it the online kernel is the
    # faster (the single-pass kernel's 256-row instance was dropped)
    assert attention_plan(64, N, 12, 64, BF16).kernel == kernel


def _staged(plan: AttentionPlan) -> AttentionPlan:
    return dataclasses.replace(plan, staged=True)


@pytest.mark.parametrize("N", [257, 1088, 2304])
def test_past_the_single_pass_limit_unaligned_views_are_staged(N):
    # views TMA cannot read take the online kernel too, after the staging copy
    assert N > attention.SINGLE_PASS_MAX_N
    aligned = attention_plan(1, N, 12, 64, BF16)
    assert aligned.kernel == "attention_wgmma_online" and not aligned.staged
    assert attention_plan(1, N, 12, 64, BF16, aligned=False) == _staged(aligned)


@pytest.mark.parametrize("N", [257, 1000, 1024, 1088, 2304])
@pytest.mark.parametrize("B", [1, 8, 128])
def test_past_the_single_pass_limit_takes_the_online_kernel(B, N):
    assert attention_plan(B, N, 12, 64, BF16).kernel == "attention_wgmma_online"


@pytest.mark.parametrize("B,N,split", [
    (1, 1024, True), (4, 1024, True), (5, 1024, False), (128, 1024, False),  # the 256 px path
    (2, 1088, True), (8, 1088, False), (1, 1000, True), (8, 1000, False), (128, 1000, False),
    (1, 2304, True), (8, 257, True), (128, 257, False), (32, 512, False),
    (8, 384, True), (128, 384, False), (8, 145, True), (128, 145, False), (128, 256, False),
])
def test_the_online_kernel_splits_for_few_items(B, N, split):
    # 64-row work items where B·H·⌈N/128⌉ <= ONLINE_SPLIT_MAX_ITEMS[64]
    # (three waves of 132 SMs), else 128-row items
    assert attention_plan(B, N, 12, 64, BF16).split == split
    assert split == (B * 12 * -(-N // 128) <= attention.ONLINE_SPLIT_MAX_ITEMS[64])


def test_an_unaligned_operand_takes_the_staged_plan():
    for B in (1, 128):
        for D in attention.HEAD_DIMS:
            plan = attention_plan(B, 144, 12, D, BF16, aligned=False)
            assert plan == _staged(attention_plan(B, 144, 12, D, BF16))
            assert plan.kernel == "attention_wgmma" and plan.instance == f"attention_wgmma_d{D}"


@pytest.mark.parametrize("N,aligned", [(144, True), (2304, True), (144, False)])
def test_fp32_takes_the_tf32_kernel(N, aligned):
    for D in attention.HEAD_DIMS:
        assert attention_plan(2, N, 12, D, torch.float32, aligned) == AttentionPlan("attention_f32", D)


def test_the_split_follows_the_q_tiles_per_sm():
    # B·H·⌈N/64⌉ q-tiles: split up to SPLIT_MAX_TILES[64], whole heads above;
    # at D = 128 always (no whole-head instance is built)
    limit = attention.SPLIT_MAX_TILES[64]
    assert attention_plan(1, 64, limit, 64, BF16).split
    assert not attention_plan(1, 64, limit + 1, 64, BF16).split
    assert attention_plan(1, 128, limit // 2, 64, BF16).split
    assert not attention_plan(1, 129, limit // 2, 64, BF16).split
    assert attention.SPLIT_MAX_TILES[128] is None
    for B in (1, 16, 128, 4096):
        assert attention_plan(B, 144, 6, 128, BF16).split


def test_plans_refuse_what_no_kernel_takes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attention_plan(1, 144, 12, 64, torch.float16)
    with pytest.raises(ValueError, match="empty"):
        attention_plan(0, 144, 12, 64, BF16)


def test_plans_are_cached():
    assert attention_plan(128, 144, 12, 64, BF16) is attention_plan(128, 144, 12, 64, BF16)
    assert attention_plan(128, 1024, 12, 64, BF16) is attention_plan(128, 1024, 12, 64, BF16)
    assert attention_plan(1, 320, 6, 128, BF16) is attention_plan(1, 320, 6, 128, BF16)
    assert attention_plan(1, 2304, 12, 64, BF16, aligned=False) is \
        attention_plan(1, 2304, 12, 64, BF16, aligned=False)


def test_plans_name_the_launch_counters():
    assert set(attention.KERNELS) | {attention.STAGE} == set(attention.launch_count)
    assert set(attention.KERNELS) == {"attention_wgmma", "attention_wgmma_online", "attention_f32"}
    assert attention.STAGE == "attention_stage"
    assert set(attention.INSTANCES) == set(attention.instance_count)
    plans = [attention_plan(B, N, 12, D, dtype, aligned)
             for B in (1, 128) for N in (144, 256, 257, 1024) for D in attention.HEAD_DIMS
             for dtype in (BF16, torch.float32) for aligned in (True, False)]
    assert {p.kernel for p in plans} == set(attention.KERNELS)
    assert {p.instance for p in plans} == set(attention.INSTANCES)
    assert {p.staged for p in plans if p.kernel != "attention_f32"} == {True, False}
    assert not any(p.staged for p in plans if p.kernel == "attention_f32")
    assert attention_plan(1, 320, 6, 128, BF16).instance == "attention_wgmma_online_d128"


def test_the_aligned_check_reads_base_and_strides():
    qkv = torch.zeros(2, 10, 3, 4, 64, dtype=BF16)
    q, k, v = qkv.unbind(2)
    assert attention._check(q, k, v)
    odd = torch.zeros(2 * 10 * 3 * 4 * 64 + 1, dtype=BF16)[1:].view(2, 10, 3, 4, 64)
    assert not attention._check(*odd.unbind(2))
    narrow = torch.zeros(2, 10, 4, 68, dtype=BF16)[..., :64]  # rows of 136 bytes
    assert not attention._check(narrow, narrow, narrow)
    q, k, v = torch.zeros(2, 10, 3, 6, 128, dtype=BF16).unbind(2)
    assert attention._check(q, k, v)


# head dimension 128: mar_small's 6 heads of 128 at the 96 px path's N = 144
# and the kitchen path's N = 320 (256 frame tokens and the 64-token text buffer)
@pytest.mark.parametrize("B,N,kernel,split", [
    (1, 144, "attention_wgmma", True), (128, 144, "attention_wgmma", True),
    (1, 320, "attention_wgmma_online", True), (16, 320, "attention_wgmma_online", True),
    (22, 320, "attention_wgmma_online", False), (128, 320, "attention_wgmma_online", False),
])
def test_head_dim_128_serving_shapes(B, N, kernel, split):
    assert attention_plan(B, N, 6, 128, BF16) == AttentionPlan(kernel, 128, split)


@pytest.mark.parametrize("B,N", [(1, 144), (128, 144), (8, 320), (128, 320)])
def test_head_dim_128_unaligned_and_fp32(B, N):
    assert attention_plan(B, N, 6, 128, BF16, aligned=False) == _staged(attention_plan(B, N, 6, 128, BF16))
    assert attention_plan(B, N, 6, 128, torch.float32) == AttentionPlan("attention_f32", 128)


@pytest.mark.parametrize("B,N", [(1, 144), (32, 144), (1, 320), (16, 320), (17, 320), (64, 320),
                                 (128, 320), (8, 257), (8, 1000)])
def test_head_dim_128_split_thresholds(B, N):
    # the thresholds of D = 128 are its own (tools/kernels_ab.py's sweep at
    # D = 128): the single pass always split, the online kernel's 64-row
    # items up to 288 of 128 rows (B = 16 at N = 320)
    plan = attention_plan(B, N, 6, 128, BF16)
    if plan.kernel == "attention_wgmma":
        assert plan.split
    else:
        assert plan.split == (B * 6 * -(-N // 128) <= attention.ONLINE_SPLIT_MAX_ITEMS[128] == 288)


@pytest.mark.parametrize("D", [32, 48, 96, 256])
def test_a_head_dim_without_an_instance_raises(D):
    # every head dimension of the JAX package's MODEL_SIZES has an instance
    # (64, 80, 128); these have none
    with pytest.raises(ValueError, match=f"D={D}"):
        attention_plan(1, 144, 16, D, BF16)
    q = torch.zeros(1, 8, 2, D)
    with pytest.raises(ValueError, match=f"D={D}"):
        attention._check(q, q, q)


# head dimension 80: mar_huge's 16 heads of 80 at the 96 px path's N = 144
# (the single pass, always split: D = 80 is held in D = 128's layout, whose
# whole-head stage leaves no room for a second) and the 256 px path's N =
# 1024 (the online kernel, 64-row items up to ONLINE_SPLIT_MAX_ITEMS[80]
# 128-row ones)
@pytest.mark.parametrize("B,N,kernel,split", [
    (1, 144, "attention_wgmma", True), (8, 144, "attention_wgmma", True),
    (128, 144, "attention_wgmma", True), (1, 137, "attention_wgmma", True),
    (1, 145, "attention_wgmma_online", True), (128, 145, "attention_wgmma_online", False),
    (1, 500, "attention_wgmma_online", True), (1, 1024, "attention_wgmma_online", False),
    (2, 1024, "attention_wgmma_online", False), (128, 1024, "attention_wgmma_online", False),
])
def test_head_dim_80_serving_shapes(B, N, kernel, split):
    assert attention_plan(B, N, 16, 80, BF16) == AttentionPlan(kernel, 80, split)
    assert attention_plan(B, N, 16, 80, BF16).instance == f"{kernel}_d80"


@pytest.mark.parametrize("B,N", [(1, 144), (128, 144), (8, 1024), (128, 1024)])
def test_head_dim_80_unaligned_and_fp32(B, N):
    assert attention_plan(B, N, 16, 80, BF16, aligned=False) == _staged(attention_plan(B, N, 16, 80, BF16))
    assert attention_plan(B, N, 16, 80, torch.float32) == AttentionPlan("attention_f32", 80)


@pytest.mark.parametrize("B,N", [(1, 144), (4096, 144), (1, 1024), (2, 1024), (3, 1024),
                                 (4, 1024), (16, 1024), (128, 1024), (8, 1000), (8, 257)])
def test_head_dim_80_split_thresholds(B, N):
    # the thresholds of D = 80 are its own (tools/kernels_ab.py's sweep at
    # D = 80, rerun on the online kernel's exact-width tiles: 64-row items
    # up to 64 of 128 rows, 128-row ones from 80)
    plan = attention_plan(B, N, 16, 80, BF16)
    assert attention.SPLIT_MAX_TILES[80] is None
    if plan.kernel == "attention_wgmma":
        assert plan.split
    else:
        assert plan.split == (B * 16 * -(-N // 128) <= attention.ONLINE_SPLIT_MAX_ITEMS[80] == 66)


def test_head_dim_80_views_of_a_fused_qkv_are_aligned():
    # 80 bf16 columns are 160 bytes, a multiple of 16: mar_huge's qkv views
    # and views of wider rows both meet TMA's rules
    q, k, v = torch.zeros(2, 10, 3, 16, 80, dtype=BF16).unbind(2)
    assert attention._check(q, k, v)
    wide = torch.zeros(2, 10, 16, 128, dtype=BF16)[..., :80]
    assert attention._check(wide, wide, wide)


def _off_boundary(B, N, H, D, offset_bytes, seed):
    """q, k, v: (B, N, H, D) bf16 views of one (B, N, 3, H, D) buffer whose
    base lies ``offset_bytes`` past a 16-byte boundary, from a numpy seed."""
    shift = offset_bytes // 2
    values = np.random.default_rng(seed).standard_normal(B * N * 3 * H * D + 8).astype(np.float32)
    flat = torch.from_numpy(values).to(BF16)
    start = (-flat.data_ptr() // 2) % 8 + shift  # 16-byte boundary, then the offset
    return flat[start:start + B * N * 3 * H * D].view(B, N, 3, H, D).unbind(2)


@pytest.mark.parametrize("D", attention.HEAD_DIMS)
@pytest.mark.parametrize("offset_bytes", [2, 4, 8])
def test_the_staging_plain_version_makes_aligned_views(D, offset_bytes):
    # views off a 16-byte boundary by 2, 4 and 8 bytes (the widths of the
    # copy kernel's 2-, 4- and 8-byte loads) come back as views TMA can read,
    # equal to the inputs; attention on them equals attention on the inputs
    B, N, H = 2, 37, {64: 12, 80: 16, 128: 6}[D]
    q, k, v = _off_boundary(B, N, H, D, offset_bytes, seed=D + offset_bytes)
    assert q.data_ptr() % 16 == offset_bytes
    assert not attention._check(q, k, v)
    assert attention_plan(B, N, H, D, BF16, aligned=False).staged
    staged = attention.stage_qkv(q, k, v)
    assert attention._check(*staged)
    for got, want in zip(staged, (q, k, v)):
        assert got.shape == want.shape and got.dtype == BF16
        assert torch.equal(got, want)
    torch.testing.assert_close(attention.flash_attention(*staged), attention.attention_plain(q, k, v),
                               rtol=0, atol=0)
