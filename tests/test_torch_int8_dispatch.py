"""The int8 wrappers' dispatch (ops/int8_mm.py:gemm_plan, quantize_plan) on
the CPU: which kernel and tile every W8A8 shape of the deployed serving path
gets, that the shapes TMA cannot read (the denoiser's K = 2 input
projection, an operand off a 16-byte boundary, K % 16 != 0) go to the
mma.sync kernel, which rows the vector quantize kernel takes, and that plans
are cached and name the launch counters. The kernels themselves run only on
the card (tests/test_torch_int8_cuda.py).
"""

import pytest
import torch

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu_torch.ops import int8_mm
from unified_video_action_tpu_torch.ops.int8_mm import GemmPlan, QuantPlan, gemm_plan, quantize_plan

# (K, N) of the deployed tier at mar_base width: the MAR's qkv, proj,
# mlp_fc1, mlp_fc2 (M = 144 tokens a sample) and the denoiser's ada_mod,
# fc1/fc2, final.ada_mod, cond_embed (M = 16 slots a sample)
MAR = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
DENOISER = [(1024, 3072), (1024, 1024), (1024, 2048), (768, 1024)]
PATH = [(144, K, N) for K, N in MAR] + [(16, K, N) for K, N in DENOISER]


@pytest.mark.parametrize("B,tile", [(128, 128), (1, 64)])
@pytest.mark.parametrize("rows,K,N", PATH)
def test_every_path_shape_takes_the_wgmma_kernel(B, tile, rows, K, N):
    assert gemm_plan(rows * B, N, K) == GemmPlan("wgmma", tile, tile)


@pytest.mark.parametrize("M", [16, 2048])
def test_what_tma_cannot_read_takes_the_mma_sync_kernel(M):
    assert gemm_plan(M, 1024, 2) == int8_mm.MMA_SYNC  # the denoiser's input_proj
    assert gemm_plan(M, 1024, 1024, aligned=False) == int8_mm.MMA_SYNC
    assert gemm_plan(M, 1024, 1000) == int8_mm.MMA_SYNC  # K % 16 != 0
    assert gemm_plan(M, 1024, 1008).variant == "wgmma"


@pytest.mark.parametrize("M,tile", [(1, 64), (256, 64), (257, 128), (18432, 128)])
def test_the_tile_follows_m(M, tile):
    for K, N in ((16, 130), (784, 1000), (3072, 768)):
        assert gemm_plan(M, N, K) == GemmPlan("wgmma", tile, tile)


def test_plans_are_cached():
    assert gemm_plan(144, 2304, 768) is gemm_plan(144, 2304, 768)
    assert gemm_plan(16, 1024, 2) is int8_mm.MMA_SYNC


def test_plans_name_the_launch_counters():
    assert set(int8_mm.GEMM_KERNELS) | set(int8_mm.QUANT_KERNELS) == set(int8_mm.launch_count)
    for plan in (int8_mm.MMA_SYNC, GemmPlan("wgmma", 64, 64), GemmPlan("wgmma", 128, 128)):
        assert plan.kernel in int8_mm.GEMM_KERNELS
    for plan in (int8_mm.QUANT_SCALAR, QuantPlan("vector", 4), QuantPlan("vector", 12)):
        assert plan.kernel in int8_mm.QUANT_KERNELS


# K and activation type of the deployed path's W8A8 layers, and the vector
# instance (units of 8 a lane) each takes: 296 of a request's 306 calls
PATH_ROWS = [(768, 4), (3072, 12), (1024, 4)]


@pytest.mark.parametrize("K,per_lane", PATH_ROWS)
def test_the_path_rows_take_the_vector_quantize_kernel(K, per_lane):
    assert quantize_plan(K, torch.bfloat16) == QuantPlan("vector", per_lane)


def test_the_input_projection_takes_the_scalar_quantize_kernel():
    assert quantize_plan(2, torch.float32) is int8_mm.QUANT_SCALAR


@pytest.mark.parametrize("K", [8, 256, 1024, 3072])
def test_quantize_plan_by_k_and_alignment(K):
    bf16, fp32 = torch.bfloat16, torch.float32
    assert quantize_plan(K, bf16).variant == "vector"
    assert quantize_plan(K, bf16, aligned=False) is int8_mm.QUANT_SCALAR
    assert quantize_plan(K + 4, bf16) is int8_mm.QUANT_SCALAR  # K % 8 != 0
    assert quantize_plan(K, fp32).variant == ("vector" if K <= 1024 else "scalar")
    assert quantize_plan(K, bf16).per_lane * 256 >= K


def test_rows_past_the_widest_instance_take_the_scalar_quantize_kernel():
    # the widest bf16 instance holds 5120 (per_lane 20); fp32's 1024
    assert quantize_plan(5128, torch.bfloat16) is int8_mm.QUANT_SCALAR
    assert quantize_plan(1032, torch.float32) is int8_mm.QUANT_SCALAR


def test_quantize_plans_are_cached():
    assert quantize_plan(768, torch.bfloat16) is quantize_plan(768, torch.bfloat16)


# mar_large's and mar_huge's fc2 inputs (4 x 1024 and 4 x 1280 columns) and
# mar_huge's other W8A8 inputs (d = 1280): the per_lane 20 instance takes the
# rows past 3072, so no MAR layer of any size falls to the scalar kernel
@pytest.mark.parametrize("K,per_lane", [(4096, 20), (5120, 20), (3080, 20), (1280, 12),
                                        (1024, 4), (3072, 12)])
def test_wide_rows_take_the_per_lane_20_instance(K, per_lane):
    assert quantize_plan(K, torch.bfloat16) == QuantPlan("vector", per_lane)
    assert quantize_plan(K, torch.bfloat16, aligned=False) is int8_mm.QUANT_SCALAR


@pytest.mark.parametrize("rows,K,N", [(144, 1280, 3840), (144, 1280, 1280), (144, 1280, 5120),
                                      (144, 5120, 1280)])
def test_mar_huge_shapes_take_the_wgmma_kernel(rows, K, N):
    # K = 1280 and 5120 are multiples of 16: gemm_plan needs no change
    for B, tile in ((128, 128), (1, 64)):
        assert gemm_plan(rows * B, N, K) == GemmPlan("wgmma", tile, tile)
