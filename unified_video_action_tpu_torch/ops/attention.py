"""Non-causal flash attention: the CUDA kernel's wrapper and its plain version.

Port of ``unified_video_action_tpu/ops/attention.py:33-191`` (the Pallas
kernels ``_attn_kernel_single_pass`` and ``_attn_kernel`` behind
``flash_attention``). The kernel is ``csrc/attention.cu``; its source says
what bounds it on an H100 and how it is laid out.

Layout: q, k, v are (B, N, H, D), as the fused qkv projection leaves them;
the kernel reads them through their strides, so the views that
``MultiHeadAttention`` slices out of one qkv tensor go in without a copy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from unified_video_action_tpu_torch.ops import _build

HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Incremented once for every launch of the CUDA kernel, and nowhere else.
launch_count = 0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain version: fp32 einsum, softmax, einsum (the JAX package's
    einsum path, ``models/transformer.py:146-152``), cast back to q's dtype."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("attention").uva_flash_attention
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one (B, N, H, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the kernel is built for D={HEAD_DIM}, got D={q.shape[-1]}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k, v must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
        item = x.element_size()
        if x.data_ptr() % 16 or any((s * item) % 16 for s in x.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned (strides {x.stride()})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(Q·Kᵀ·D^-½)·V over (B, N, H, D) tensors -> contiguous (B, N, H, D).

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor it
    runs the plain version.
    """
    global launch_count
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    _check(q, k, v)
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, N, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return out
