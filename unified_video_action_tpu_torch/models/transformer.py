"""ViT blocks of the MAR encoder and decoder (port of
``models/transformer.py:82-204``), for serving: eval mode, no dropout.

Pre-LN blocks (LayerNorm eps 1e-6), multi-head attention with one fused qkv
projection, a 4x exact-GELU MLP and residual adds. Submodules carry the flax
names (``qkv``, ``proj``, ``norm1``, ``mlp_fc1``, ``block_<i>``, ...) so that
``convert.py`` maps the JAX parameter tree by name.

Every attention layer starts on ``"kernel"``: ``ops.attention.flash_attention``
(the CUDA kernel on the card, its plain version on the CPU).
``set_attn_impl(module, "plain")`` switches a model to the plain version
everywhere, which is what the kernel is held against on the card.

With ``quant=True`` the dense projections (``qkv``, ``proj``, ``mlp_fc1``,
``mlp_fc2``) are :class:`QuantLinear`, the W8A8 serving layer of JAX's
``QuantDense`` (``models/transformer.py:50-79``), and ``set_int8_impl``
switches them between ``ops.int8_mm.w8a8_linear`` (``"kernel"``) and its
plain version in the same way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from unified_video_action_tpu_torch.ops.attention import attention_plain, flash_attention
from unified_video_action_tpu_torch.ops.int8_mm import w8a8_linear
from unified_video_action_tpu_torch.ops.quant import w8a8_linear_plain

ATTN_IMPLS = {"kernel": flash_attention, "plain": attention_plain}
INT8_IMPLS = {"kernel": w8a8_linear, "plain": w8a8_linear_plain}


class QuantLinear(nn.Module):
    """W8A8 dense layer for serving: ``weight_q`` (out, in) int8 with its fp32
    per-output-channel ``w_scale`` and an fp32 ``bias``. Rows of x are
    quantized per call; the output has x's dtype, plus the bias cast to it.

    The scales and the bias stay fp32 when the model is cast to another
    dtype, as JAX's ``QuantDense`` keeps its parameters fp32. The weight bridge
    fills ``weight_q`` and ``w_scale`` from the float kernel
    (``convert.load_into``).
    """

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.int8_impl = "kernel"
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features))

    def _apply(self, fn, recurse=True):
        def keep_dtype(t):
            moved = fn(t)
            return moved if moved.dtype == t.dtype else t.to(moved.device)

        return super()._apply(keep_dtype, recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return INT8_IMPLS[self.int8_impl](x, self.weight_q, self.w_scale, self.bias)


def dense(in_features: int, out_features: int, quant: bool) -> nn.Module:
    """``QuantLinear`` under ``quant``, else ``nn.Linear`` (JAX's ``_dense_cls``)."""
    return QuantLinear(in_features, out_features) if quant else nn.Linear(in_features, out_features)


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, quant: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = "kernel"
        self.qkv = dense(dim, 3 * dim, quant)
        self.proj = dense(dim, dim, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        qkv = self.qkv(x).view(B, N, 3, H, D // H)
        q, k, v = qkv.unbind(2)  # (B, N, H, hd) strided views
        out = ATTN_IMPLS[self.attn_impl](q, k, v)
        return self.proj(out.reshape(B, N, D))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, quant: bool = False):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiHeadAttention(dim, num_heads, quant)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = dense(dim, hidden, quant)
        self.mlp_fc2 = dense(hidden, dim, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        h = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none")
        return x + self.mlp_fc2(h)


class TransformerStack(nn.Module):
    def __init__(self, depth: int, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 quant: bool = False):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", ViTBlock(dim, num_heads, mlp_ratio, quant))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        return x


def set_attn_impl(module: nn.Module, attn_impl: str) -> None:
    """Switch every attention layer under ``module`` to ``attn_impl``."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {sorted(ATTN_IMPLS)}, got {attn_impl!r}")
    for m in module.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_impl = attn_impl


def set_int8_impl(module: nn.Module, int8_impl: str) -> None:
    """Switch every ``QuantLinear`` under ``module`` to ``int8_impl``."""
    if int8_impl not in INT8_IMPLS:
        raise ValueError(f"int8_impl must be one of {sorted(INT8_IMPLS)}, got {int8_impl!r}")
    for m in module.modules():
        if isinstance(m, QuantLinear):
            m.int8_impl = int8_impl
