"""Int8 W8A8 serving arithmetic, plain PyTorch (port of ``ops/quant.py``:
``quantize_weight`` at :29-35 and ``int8_matmul`` at :38-55).

Symmetric per-output-channel int8 weights, per-row dynamic int8
activations, an s8·s8 product exact in int32, and an fp32 rescale. This is
the plain version that the CUDA kernels of ``csrc/int8_mm.cu`` are held
against, and the one that runs on CPU tensors.

The scale of a row (or of a weight column) is ``max(amax * fl(1/127),
1e-12)``: a multiplication by the float32 value of 1/127, not a division by
127. The JAX package writes ``amax / 127.0``, but XLA rewrites a division
by a constant into a multiplication by the constant's reciprocal, so that
is what its compiled serving program computes (``jax.jit`` of either
function shows ``multiply(..., 0.00787401572)`` in its HLO); the two differ
by one ulp for about 5 % of values. The quotient ``x / scale`` stays a true
division, as it does in the compiled program, and rounds half to even.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

INV_127 = float(np.float32(1.0 / 127.0))  # fl32(1/127), as XLA folds it
SCALE_FLOOR = 1e-12


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return (amax * INV_127).clamp_min(SCALE_FLOOR)


def _round_clip(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in, out) float kernel -> ``(w_q, scale)``: int8 (in, out) and the fp32
    per-output-channel scale (out,), computed in fp32."""
    w = w.float()
    scale = _scale(w.abs().amax(dim=0))
    return _round_clip(w, scale), scale


def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float -> ``(x_q, x_scale)``: int8 (M, K) and fp32 (M,), one
    scale per row from the row's fp32 amax."""
    xf = x.float()
    x_scale = _scale(xf.abs().amax(dim=-1))
    return _round_clip(xf, x_scale[:, None]), x_scale


def int8_gemm_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 times the (N, K) int8 weight -> (M, N) int32, exact: the
    product runs in float64, whose 53-bit mantissa holds every partial sum
    (at most 127² · K; float32 would not: 127² · 3072 > 2²⁴). This is the
    card's oracle for the GEMM kernels. CPU tensors take ``torch._int_mm``,
    which accumulates in int32 and so gives the same integers (every partial
    sum fits: 127² · 3072 < 2³¹), several times faster."""
    if x_q.device.type == "cpu":
        return torch._int_mm(x_q, w_q.T)
    return (x_q.double() @ w_q.double().T).to(torch.int32)


def rescale_plain(y: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """int32 (M, N) -> ``((y · x_scale) · w_scale)`` cast to ``dtype``, then the
    bias cast to ``dtype`` added in ``dtype`` (``models/transformer.py:78-79``)."""
    out = ((y.float() * x_scale[:, None]) * w_scale).to(dtype)
    if bias is not None:
        out = out + bias.to(dtype)
    return out


def w8a8_linear_plain(x: torch.Tensor, weight_q: torch.Tensor, w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The W8A8 layer: x (..., K) float, ``weight_q`` (N, K) int8, ``w_scale``
    (N,) fp32, ``bias`` (N,) -> (..., N) in x's dtype."""
    lead = x.shape[:-1]
    x_q, x_scale = quantize_rows_plain(x.reshape(-1, x.shape[-1]))
    y = int8_gemm_plain(x_q, weight_q)
    return rescale_plain(y, x_scale, w_scale, bias, x.dtype).reshape(*lead, -1)
