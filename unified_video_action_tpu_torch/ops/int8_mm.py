"""W8A8 int8 matrix multiply: the CUDA kernels' wrappers and their plain versions.

Port of ``unified_video_action_tpu/ops/int8_mm.py`` (the Pallas kernel
``_mm_kernel`` behind ``int8_matmul_pallas`` at :32-80 and its wrapper
``w8a8_matmul`` at :83-107). The kernels are ``csrc/int8_mm.cu``; its source
says what bounds them on an H100 and how they are laid out. The plain
versions are ``ops/quant.py``'s, which the kernels reproduce bit for bit.

* :func:`quantize_rows` (M, K) float -> x_q (M, K) int8, x_scale (M,) fp32,
                        by the kernel :func:`quantize_plan` names
* :func:`int8_gemm`     x_q (M, K) int8, weight (N, K) int8 -> (M, N) int32,
                        or rescaled to float with the bias in its epilogue
* :func:`w8a8_linear`   the layer: :func:`quantize_rows`, then
                        :func:`int8_gemm` with the epilogue

On a CUDA tensor each launches its kernel (or raises); on a CPU tensor it
runs the plain version.

:func:`int8_gemm` has two kernels, chosen by shape and alignment
(:func:`gemm_plan`, no fallback between them): the Hopper design (TMA +
wgmma) wherever TMA can read the operands, and an mma.sync kernel with byte
loads where it cannot: K % 16 != 0, as the denoiser's K = 2 input
projection, or an operand that is not 16-byte aligned. :func:`quantize_rows`
has two, likewise (:func:`quantize_plan`): a vector kernel that reads x
once, wherever K % 8 == 0, x is 16-byte aligned and K <= 5120 (bf16) or
1024 (fp32), and a scalar kernel for the rest (the K = 2 input projection).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from unified_video_action_tpu_torch.ops import _build
from unified_video_action_tpu_torch.ops.quant import (
    int8_gemm_plain,
    quantize_rows_plain,
    rescale_plain,
    w8a8_linear_plain,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_S32 = 2
# 127² · K must stay below 2³¹ for the int32 accumulator to be exact
MAX_K = (2**31 - 1) // (127 * 127)

QUANT_KERNELS = ("quantize_rows_vector", "quantize_rows_scalar")
GEMM_KERNELS = ("int8_gemm_wgmma", "int8_gemm_mma_sync")
# Incremented once for every launch of each CUDA kernel, and nowhere else:
# each QuantPlan.kernel of quantize_rows and each GemmPlan.kernel of int8_gemm.
launch_count = {k: 0 for k in QUANT_KERNELS + GEMM_KERNELS}

SMALL_M = 256  # up to here one 64-row consumer warpgroup per CTA

# Known errors the kernels can be built to make (bit flags of csrc/int8_mm.cu's
# ``faults``), for the controls of chip_smoke.py's serve check. 0 in use.
FAULTS = {"round_half_away": 1, "reciprocal_scale": 2,
          "per_tensor_w_scale": 4, "bias_before_cast": 8}
planted_faults = 0


@dataclass(frozen=True)
class GemmPlan:
    """Which kernel :func:`int8_gemm` launches: ``variant`` "wgmma" (output
    tile ``bm`` x ``bn``, one of those csrc/int8_mm.cu instantiates) or
    "mma_sync" (128 x 128 tiles; ``bm`` and ``bn`` unused)."""
    variant: str
    bm: int = 128
    bn: int = 128

    @property
    def kernel(self) -> str:
        """The key of :data:`launch_count` that a launch of this plan counts in."""
        return f"int8_gemm_{self.variant}"


MMA_SYNC = GemmPlan("mma_sync")


@functools.lru_cache(maxsize=1024)
def gemm_plan(M: int, N: int, K: int, aligned: bool = True) -> GemmPlan:
    """The kernel and tile of an (M, K) x (N, K) product; ``aligned`` says
    both operands start on a 16-byte boundary. Cached: the serving path asks
    for the same few shapes on every call.

    * mma_sync where TMA cannot read the operands: K % 16 != 0 or not aligned.
    * wgmma otherwise: 64 x 64 tiles up to M = SMALL_M (one consumer
      warpgroup; the time is the weight's read, so narrow tiles give more
      CTAs to read it), else 128 x 128 (two consumer warpgroups).
    """
    if K % 16 or not aligned:
        return MMA_SYNC
    tile = 64 if M <= SMALL_M else 128
    return GemmPlan("wgmma", tile, tile)


# the vector quantize kernel's instances: units of 8 elements a lane holds
# (one warp per row, so a row of K <= 256 per_lane: 1024, 3072 and 5120, the
# last for mar_large's and mar_huge's fc2 inputs, K = 4096 and 5120); fp32
# only the first
QUANT_PER_LANE = {torch.bfloat16: (4, 12, 20), torch.float32: (4,)}


@dataclass(frozen=True)
class QuantPlan:
    """Which kernel :func:`quantize_rows` launches: ``variant`` "vector" (an
    instance holding ``per_lane`` units of 8 elements a lane) or "scalar"."""
    variant: str
    per_lane: int = 0

    @property
    def kernel(self) -> str:
        """The key of :data:`launch_count` that a launch of this plan counts in."""
        return f"quantize_rows_{self.variant}"


QUANT_SCALAR = QuantPlan("scalar")


@functools.lru_cache(maxsize=1024)
def quantize_plan(K: int, dtype: torch.dtype, aligned: bool = True) -> QuantPlan:
    """The kernel that quantizes rows of K elements of ``dtype``; ``aligned``
    says x starts on a 16-byte boundary. Cached.

    * vector where K % 8 == 0 and aligned (then every row is aligned too)
      and an instance holds the row (K <= 5120 in bf16, 1024 in fp32): the
      smallest such instance;
    * scalar otherwise (the denoiser's K = 2 input projection).
    """
    fits = [n for n in QUANT_PER_LANE[dtype] if K <= 32 * 8 * n]
    if K % 8 or not aligned or not fits:
        return QUANT_SCALAR
    return QuantPlan("vector", fits[0])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("int8_mm")
    lib.uva_quantize_rows.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.uva_quantize_rows.restype = ctypes.c_int
    lib.uva_quantize_rows_vector.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.uva_quantize_rows_vector.restype = ctypes.c_int
    lib.uva_int8_gemm.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.uva_int8_gemm.restype = ctypes.c_int
    lib.uva_int8_gemm_wgmma.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    lib.uva_int8_gemm_wgmma.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


ENCODE_ERROR = 10000  # csrc/hopper.cuh kEncodeError


def _raise_on(rc: int, name: str) -> None:
    if rc >= ENCODE_ERROR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed: CUresult {rc - ENCODE_ERROR}")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _check_2d(name: str, t: torch.Tensor, dtypes, device: torch.device) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_vector(name: str, t: torch.Tensor, n: int, device: torch.device) -> None:
    if t.shape != (n,) or t.dtype != torch.float32 or t.device != device:
        raise ValueError(
            f"{name} must be float32 ({n},) on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_k(K: int) -> None:
    if not 0 < K <= MAX_K:
        raise ValueError(f"K={K} outside (0, {MAX_K}]: the int32 sum would not be exact")


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float32 or bfloat16 -> ``(x_q, x_scale)``: int8 (M, K) and
    float32 (M,). The kernel is :func:`quantize_plan`'s."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    _check_2d("x", x, tuple(_DTYPE_CODES), x.device)
    M, K = x.shape
    _check_k(K)
    x_q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    x_scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    if M == 0:
        return x_q, x_scale
    plan = quantize_plan(K, x.dtype, x.data_ptr() % 16 == 0)
    args = (x.data_ptr(), x_q.data_ptr(), x_scale.data_ptr(), M, K, _DTYPE_CODES[x.dtype],
            planted_faults)
    if plan.variant == "vector":
        rc = _lib().uva_quantize_rows_vector(*args, plan.per_lane, _stream(x))
    else:
        rc = _lib().uva_quantize_rows(*args, _stream(x))
    _raise_on(rc, f"quantize_rows ({plan.kernel})")
    launch_count[plan.kernel] += 1
    return x_q, x_scale


def int8_gemm(x_q: torch.Tensor, weight_q: torch.Tensor, x_scale: Optional[torch.Tensor] = None,
              w_scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """x_q (M, K) int8 times ``weight_q`` (N, K) int8. With ``out_dtype``
    int32 (the default) the exact product; with float32 or bfloat16,
    ``((y · x_scale) · w_scale)`` cast to ``out_dtype``, then ``bias`` (N,)
    cast to it and added, all in the kernel's epilogue. The kernel is
    :func:`gemm_plan`'s."""
    if out_dtype != torch.int32 and out_dtype not in _DTYPE_CODES:
        raise ValueError(f"out_dtype must be int32, float32 or bfloat16, got {out_dtype}")
    if out_dtype != torch.int32 and (x_scale is None or w_scale is None):
        raise ValueError("a float output needs x_scale and w_scale")
    if x_q.device.type == "cpu":
        y = int8_gemm_plain(x_q, weight_q)
        return y if out_dtype == torch.int32 else rescale_plain(y, x_scale, w_scale, bias, out_dtype)
    _check_2d("x_q", x_q, (torch.int8,), x_q.device)
    _check_2d("weight_q", weight_q, (torch.int8,), x_q.device)
    M, K = x_q.shape
    N = weight_q.shape[0]
    if weight_q.shape[1] != K:
        raise ValueError(f"x_q is (M, {K}) but weight_q is {tuple(weight_q.shape)}, not (N, {K})")
    _check_k(K)
    ptrs = [0, 0, 0]
    if out_dtype != torch.int32:
        for i, (name, v, n) in enumerate((("x_scale", x_scale, M), ("w_scale", w_scale, N),
                                          ("bias", bias, N))):
            if v is not None:
                _check_vector(name, v, n, x_q.device)
                ptrs[i] = v.data_ptr()
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    x_ptr, w_ptr = x_q.data_ptr(), weight_q.data_ptr()
    plan = gemm_plan(M, N, K, x_ptr % 16 == 0 and w_ptr % 16 == 0)
    kind = _OUT_S32 if out_dtype == torch.int32 else _DTYPE_CODES[out_dtype]
    args = (x_ptr, ptrs[0], w_ptr, ptrs[1], ptrs[2], out.data_ptr(), M, N, K, kind, planted_faults)
    if plan.variant == "mma_sync":
        rc = _lib().uva_int8_gemm(*args, _stream(x_q))
    else:
        rc = _lib().uva_int8_gemm_wgmma(*args, plan.bm, plan.bn, _stream(x_q))
    _raise_on(rc, f"int8_gemm ({plan.kernel})")
    launch_count[plan.kernel] += 1
    return out


def w8a8_linear(x: torch.Tensor, weight_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The W8A8 layer: x (..., K) float32 or bfloat16, ``weight_q`` (N, K)
    int8, ``w_scale`` (N,) float32 and ``bias`` (N,) float32 -> (..., N) in
    x's dtype. Two launches: :func:`quantize_rows`, then :func:`int8_gemm`
    with the rescale, the cast and the bias in its epilogue."""
    if x.device.type == "cpu":
        return w8a8_linear_plain(x, weight_q, w_scale, bias)
    lead = x.shape[:-1]
    x_q, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())
    return int8_gemm(x_q, weight_q, x_scale, w_scale, bias, x.dtype).reshape(*lead, -1)
