"""The CLIP text tower (the port's counterpart of the JAX package's
``models/clip.py``: ``ClipTextConfig``, ``quick_gelu``, ``ClipAttention``,
``ClipLayer`` and ``ClipTextModel``).

The reference encodes language goals with the frozen HF
``openai/clip-vit-base-patch32`` text model (utils/language_model.py:7-33).
Architecture (public CLIP): token + position embeddings -> pre-LN causal
transformer (quick-GELU MLP) -> final LN -> pooling at the first end-of-text
token -> linear projection to the 512-d joint space.

The modules carry the flax module names, so ``convert.load_into`` loads the
JAX tower's parameter tree as it loads the MAR's (Dense kernels transposed,
LayerNorm ``scale`` as ``weight``; the embeddings and ``text_projection``,
(hidden, projection), keep their shapes). The attention is causal and stays
plain attention, as in JAX: the non-causal attention kernel does not serve
it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_layers: int = 12
    num_heads: int = 8
    max_position_embeddings: int = 77
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        d = cfg.hidden_size
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(d, d) for _ in range(4))

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        hd = D // H
        q = self.q_proj(x).reshape(B, N, H, hd)
        k = self.k_proj(x).reshape(B, N, H, hd)
        v = self.v_proj(x).reshape(B, N, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
        # masked in fp32 (float32's lowest overflows bf16), as JAX's softmax
        # takes the logits in fp32
        logits = torch.where(causal_mask, logits.float(), torch.finfo(torch.float32).min)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, D)
        return self.out_proj(out)


class ClipLayer(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.self_attn = ClipAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, d)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class ClipTextModel(nn.Module):
    """input_ids (B, N) integer -> text_embeds (B, projection_dim)."""

    def __init__(self, cfg: ClipTextConfig = ClipTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", ClipLayer(cfg))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.text_projection = nn.Parameter(torch.zeros(cfg.hidden_size, cfg.projection_dim))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, N = input_ids.shape
        input_ids = input_ids.to(self.token_embedding.device, torch.int64)
        x = self.token_embedding[input_ids] + self.position_embedding[None, :N]
        causal = torch.ones(N, N, dtype=torch.bool, device=x.device).tril()[None, None]
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x, causal)
        x = self.final_layer_norm(x)
        # pooling at the FIRST end-of-text token (HF semantics; the released
        # vocabulary's eos is its highest id, so this is also its argmax)
        pos = torch.arange(N, device=x.device).expand(B, N)
        eot = torch.where(input_ids == c.eos_token_id, pos, N).amin(dim=-1)
        eot = torch.where(eot == N, 0, eot)  # no eos: position 0, as JAX's argmax
        pooled = x[torch.arange(B, device=x.device), eot]
        return pooled @ self.text_projection
