"""ViT blocks of the MAR encoder and decoder (port of
``models/transformer.py:25-204``).

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

In training mode (``module.train()``) attention is ``attention_plain`` with
its products in the compute dtype, JAX's ``attn_impl="xla"`` (``:128-134``),
under autograd, with JAX's dropouts: the attention weights, the projection
and the MLP output each go through ``ops.attention.dropout``,
``where(keep, x / (1 - rate), 0)``, the semantics
of ``tied_dropout`` (``:25-47``). The keep masks are passed in, or drawn from
a ``torch.Generator`` just before each block (outside a gradient checkpoint,
so its recompute sees the same masks). ``TransformerStack(remat=True)`` is
``nn.remat``'s ``torch.utils.checkpoint`` per block. No CUDA kernel is on the
training path: ``flash_attention`` refuses inputs that require grad.

The dense layers carry flax's initializer names in ``kernel_init`` where the
JAX module names one other than flax's default ``lecun_normal``
(``models/initializers.py`` reads them).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.func import functional_call

from unified_video_action_tpu_torch.ops.attention import attention_plain, dropout, flash_attention
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


def dense(in_features: int, out_features: int, quant: bool,
          kernel_init: Optional[str] = None) -> nn.Module:
    """``QuantLinear`` under ``quant``, else ``nn.Linear`` (JAX's ``_dense_cls``),
    tagged with the flax initializer of its kernel where JAX names one."""
    layer = QuantLinear(in_features, out_features) if quant else nn.Linear(in_features, out_features)
    if kernel_init is not None:
        layer.kernel_init = kernel_init
    return layer


def draw_keep(shape: Sequence[int], rate: float, generator: torch.Generator,
              device: torch.device) -> Optional[torch.Tensor]:
    """A bool keep mask, each element kept with probability 1 - rate (JAX's
    ``bernoulli(key, 1 - rate)``: uniform < 1 - rate); None at rate 0."""
    if rate == 0.0:
        return None
    return torch.rand(tuple(shape), generator=generator, device=device) < (1.0 - rate)


# A block's keep masks: (attention weights (B, H, N, N), projection (B, N, D),
# MLP output (B, N, D)); None where the rate is 0.
BlockMasks = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]
# A stack's dropout: None (no dropout), a generator to draw each block's masks
# from, or every block's masks
StackDropout = Union[None, torch.Generator, Sequence[BlockMasks]]


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, quant: bool = False,
                 attn_dropout: float = 0.0, proj_dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = "kernel"
        self.attn_dropout = attn_dropout
        self.proj_dropout = proj_dropout
        self.qkv = dense(dim, 3 * dim, quant)
        self.proj = dense(dim, dim, quant)

    def forward(self, x: torch.Tensor, attn_keep: Optional[torch.Tensor] = None,
                proj_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        qkv = self.qkv(x).view(B, N, 3, H, D // H)
        q, k, v = qkv.unbind(2)  # (B, N, H, hd) strided views
        if self.training:
            # JAX's xla path: products in the compute dtype, softmax in fp32
            out = attention_plain(q, k, v, attn_keep, self.attn_dropout, fp32_products=False)
        else:
            out = ATTN_IMPLS[self.attn_impl](q, k, v)
        return dropout(self.proj(out.reshape(B, N, D)), proj_keep, self.proj_dropout)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, quant: bool = False,
                 attn_dropout: float = 0.0, proj_dropout: float = 0.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiHeadAttention(dim, num_heads, quant, attn_dropout, proj_dropout)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = dense(dim, hidden, quant)
        self.mlp_fc2 = dense(hidden, dim, quant)

    def draw_masks(self, batch: int, tokens: int, generator: torch.Generator,
                   device: torch.device) -> BlockMasks:
        """This block's keep masks for a (batch, tokens, D) input, in the order
        the JAX block draws them."""
        a, D = self.attn, self.norm1.normalized_shape[0]
        return (draw_keep((batch, a.num_heads, tokens, tokens), a.attn_dropout, generator, device),
                draw_keep((batch, tokens, D), a.proj_dropout, generator, device),
                draw_keep((batch, tokens, D), a.proj_dropout, generator, device))

    def forward(self, x: torch.Tensor, masks: Optional[BlockMasks] = None) -> torch.Tensor:
        attn_keep, proj_keep, mlp_keep = masks or (None, None, None)
        x = x + self.attn(self.norm1(x), attn_keep, proj_keep)
        h = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none")
        return x + dropout(self.mlp_fc2(h), mlp_keep, self.attn.proj_dropout)


def _run_block(block: nn.Module, names: Sequence[str], x: torch.Tensor,
               masks: Optional[BlockMasks], *params: torch.Tensor) -> torch.Tensor:
    return functional_call(block, dict(zip(names, params)), (x, masks))


class TransformerStack(nn.Module):
    def __init__(self, depth: int, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 quant: bool = False, attn_dropout: float = 0.0, proj_dropout: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.depth = depth
        self.remat = remat
        for i in range(depth):
            self.add_module(f"block_{i}", ViTBlock(dim, num_heads, mlp_ratio, quant,
                                                   attn_dropout, proj_dropout))

    def blocks(self) -> List[ViTBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.depth)]

    def forward(self, x: torch.Tensor, drop: StackDropout = None) -> torch.Tensor:
        """``drop`` applies in training mode only: a generator draws each
        block's masks before the block runs, or a sequence gives them."""
        for i, block in enumerate(self.blocks()):
            masks = None
            if self.training and isinstance(drop, torch.Generator):
                masks = block.draw_masks(x.shape[0], x.shape[1], drop, x.device)
            elif self.training and drop is not None:
                masks = drop[i]
            if self.training and self.remat and torch.is_grad_enabled():
                # the block's parameters go in as inputs, so that the backward's
                # recompute uses the tensors of this forward: under the
                # policy's functional_call (bf16 casts of the fp32
                # parameters) the module holds the casts only while it runs
                names, params = zip(*block.named_parameters())
                x = torch.utils.checkpoint.checkpoint(_run_block, block, names, x, masks, *params,
                                                      use_reentrant=False)
            else:
                x = block(x, masks)
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
