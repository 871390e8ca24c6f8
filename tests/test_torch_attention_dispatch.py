"""The attention wrapper's dispatch (ops/attention.py:attention_plan) on the
CPU: which kernel the serving shapes get (the single-pass wgmma kernel at
(B, 144, 12, 64) bf16, split into one CTA per q-tile at small B; the
online-softmax wgmma kernel at the 256 px path's (B, 1024, 12, 64), in
64-row work items at small B), where the single-pass kernel stops (N = 144)
and the online kernel takes over, that an operand off a 16-byte boundary
takes the mma.sync kernel, that fp32 takes the scalar kernel, and that plans
are cached and name the launch counters. The kernels themselves run only on
the card (tests/test_torch_attention_cuda.py).
"""

import pytest
import torch

from unified_video_action_tpu_torch.ops import attention
from unified_video_action_tpu_torch.ops.attention import AttentionPlan, attention_plan

BF16 = torch.bfloat16


@pytest.mark.parametrize("B,split", [(1, True), (2, True), (7, True), (8, False), (128, False)])
def test_the_serving_shape_takes_the_single_pass_kernel(B, split):
    assert attention_plan(B, 144, 12, BF16) == AttentionPlan("attention_wgmma", split)


@pytest.mark.parametrize("N,kernel", [(1, "attention_wgmma"), (100, "attention_wgmma"),
                                      (137, "attention_wgmma"), (144, "attention_wgmma"),
                                      (145, "attention_wgmma_online"), (200, "attention_wgmma_online"),
                                      (256, "attention_wgmma_online")])
def test_the_smallest_instance_that_holds_n(N, kernel):
    # the single-pass kernel holds 144 rows; past it the online kernel is the
    # faster (the single-pass kernel's 256-row instance was dropped)
    assert attention_plan(64, N, 12, BF16).kernel == kernel


@pytest.mark.parametrize("N", [257, 1088, 2304])
def test_past_the_single_pass_limit_takes_the_mma_sync_kernel(N):
    # past the limit the mma.sync kernel now takes only views TMA cannot read
    assert N > attention.SINGLE_PASS_MAX_N
    assert attention_plan(1, N, 12, BF16, aligned=False) == attention.MMA_SYNC
    assert attention_plan(1, N, 12, BF16).kernel == "attention_wgmma_online"


@pytest.mark.parametrize("N", [257, 1000, 1024, 1088, 2304])
@pytest.mark.parametrize("B", [1, 8, 128])
def test_past_the_single_pass_limit_takes_the_online_kernel(B, N):
    assert attention_plan(B, N, 12, BF16).kernel == "attention_wgmma_online"


@pytest.mark.parametrize("B,N,split", [
    (1, 1024, True), (4, 1024, True), (5, 1024, False), (128, 1024, False),  # the 256 px path
    (2, 1088, True), (8, 1088, False), (1, 1000, True), (8, 1000, False), (128, 1000, False),
    (1, 2304, True), (8, 257, True), (128, 257, False), (32, 512, False),
    (8, 384, True), (128, 384, False), (8, 145, True), (128, 145, False), (128, 256, False),
])
def test_the_online_kernel_splits_for_few_items(B, N, split):
    # 64-row work items where B·H·⌈N/128⌉ <= ONLINE_SPLIT_MAX_ITEMS (three
    # waves of 132 SMs), else 128-row items
    assert attention_plan(B, N, 12, BF16).split == split
    assert split == (B * 12 * -(-N // 128) <= attention.ONLINE_SPLIT_MAX_ITEMS)


def test_an_unaligned_operand_takes_the_mma_sync_kernel():
    assert attention_plan(1, 144, 12, BF16, aligned=False) == attention.MMA_SYNC
    assert attention_plan(128, 144, 12, BF16, aligned=False) == attention.MMA_SYNC


@pytest.mark.parametrize("N,aligned", [(144, True), (2304, True), (144, False)])
def test_fp32_takes_the_scalar_kernel(N, aligned):
    assert attention_plan(2, N, 12, torch.float32, aligned) == attention.F32


def test_the_split_follows_the_q_tiles_per_sm():
    # B·H·⌈N/64⌉ q-tiles: split up to SPLIT_MAX_TILES, whole heads above
    limit = attention.SPLIT_MAX_TILES
    assert attention_plan(1, 64, limit, BF16).split
    assert not attention_plan(1, 64, limit + 1, BF16).split
    assert attention_plan(1, 128, limit // 2, BF16).split
    assert not attention_plan(1, 129, limit // 2, BF16).split


def test_plans_refuse_what_no_kernel_takes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attention_plan(1, 144, 12, torch.float16)
    with pytest.raises(ValueError, match="empty"):
        attention_plan(0, 144, 12, BF16)


def test_plans_are_cached():
    assert attention_plan(128, 144, 12, BF16) is attention_plan(128, 144, 12, BF16)
    assert attention_plan(128, 1024, 12, BF16) is attention_plan(128, 1024, 12, BF16)
    assert attention_plan(1, 2304, 12, BF16, aligned=False) is attention.MMA_SYNC


def test_plans_name_the_launch_counters():
    assert set(attention.KERNELS) == set(attention.launch_count)
    assert set(attention.KERNELS) == {"attention_wgmma", "attention_wgmma_online",
                                      "attention_mma_sync", "attention_f32"}
    plans = [attention_plan(B, N, 12, dtype, aligned)
             for B in (1, 128) for N in (144, 256, 257, 1024) for dtype in (BF16, torch.float32)
             for aligned in (True, False)]
    assert {p.kernel for p in plans} == set(attention.KERNELS)


def test_the_aligned_check_reads_base_and_strides():
    qkv = torch.zeros(2, 10, 3, 4, 64, dtype=BF16)
    q, k, v = qkv.unbind(2)
    assert attention._check(q, k, v)
    odd = torch.zeros(2 * 10 * 3 * 4 * 64 + 1, dtype=BF16)[1:].view(2, 10, 3, 4, 64)
    assert not attention._check(*odd.unbind(2))
    narrow = torch.zeros(2, 10, 4, 68, dtype=BF16)[..., :64]  # rows of 136 bytes
    assert not attention._check(narrow, narrow, narrow)
