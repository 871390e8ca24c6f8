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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from unified_video_action_tpu_torch.ops.attention import attention_plain, flash_attention

ATTN_IMPLS = {"kernel": flash_attention, "plain": attention_plain}


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = "kernel"
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        qkv = self.qkv(x).view(B, N, 3, H, D // H)
        q, k, v = qkv.unbind(2)  # (B, N, H, hd) strided views
        out = ATTN_IMPLS[self.attn_impl](q, k, v)
        return self.proj(out.reshape(B, N, D))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiHeadAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        h = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none")
        return x + self.mlp_fc2(h)


class TransformerStack(nn.Module):
    def __init__(self, depth: int, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", ViTBlock(dim, num_heads, mlp_ratio))

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
