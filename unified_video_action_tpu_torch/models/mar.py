"""MAR unified video-action transformer, policy serving path (port of
``models/mar.py``: ``MarConfig``, ``MODEL_SIZES`` and ``patchify``, then
``forward_encoder`` and ``forward_decoder`` for ``policy_model`` at
:339-500 and ``sample_policy`` at :632-684).

One encoder+decoder pass over the conditioning frames' latent tokens, then
the action head's diffusion sampler. Parameters carry the flax names so
``convert.py`` maps the JAX tree by name. With ``language_emb_model="clip"``
(the kitchen model) a 64-token text buffer goes before the frame tokens
(``mar.py:449-475``, ``:489-495``): the projected goal latent repeated, or
the learned ``fake_latent`` when no goal is given, plus its own position
embeddings; the decoder drops it again. The video head (``diffloss``), the
other task modes, proprioception, wrist images and history actions wait for
later slices; the config refuses what is not ported.
``MarConfig.quant`` makes the stacks' and the action denoiser's dense layers
W8A8 (``mar.py:104``); ``decoder_embed`` and the ``z_proj*`` layers stay
float, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from unified_video_action_tpu_torch.models.heads import ActionDiffusionHead
from unified_video_action_tpu_torch.models.transformer import TransformerStack
from unified_video_action_tpu_torch.utils.language import CLIP_DIM


@dataclasses.dataclass(frozen=True)
class MarConfig:
    # geometry
    img_size: int = 256
    vae_stride: int = 16
    patch_size: int = 1
    vae_embed_dim: int = 16
    n_frames: int = 4
    # transformer
    encoder_embed_dim: int = 768
    encoder_depth: int = 12
    encoder_num_heads: int = 12
    decoder_embed_dim: int = 768
    decoder_depth: int = 12
    decoder_num_heads: int = 12
    mlp_ratio: float = 4.0
    # action head
    diffloss_act_d: int = 6
    diffloss_act_w: int = 1024
    act_diff_testing_steps: str = "100"
    act_model_type: str = "conv_fc"
    action_dim: int = 2
    num_action_tokens: int = 16
    # language conditioning: "clip" prepends a text buffer of this many tokens
    language_emb_model: Optional[str] = None
    buffer_size_text: int = 64
    # int8 W8A8 dense layers in both stacks and the action denoiser (serving)
    quant: bool = False

    @property
    def seq_hw(self) -> int:
        return self.img_size // self.vae_stride // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.seq_hw * self.seq_hw

    @property
    def token_embed_dim(self) -> int:
        return self.vae_embed_dim * self.patch_size**2

    @property
    def total_tokens(self) -> int:
        return self.n_frames * self.seq_len

    @property
    def has_text(self) -> bool:
        return self.language_emb_model == "clip"

    @property
    def attention_tokens(self) -> int:
        """The tokens every ViT block attends over: the frames' and, with
        language, the text buffer's."""
        return self.total_tokens + (self.buffer_size_text if self.has_text else 0)


MODEL_SIZES = {
    "mar_tiny": dict(encoder_embed_dim=768, encoder_depth=3, encoder_num_heads=6,
                     decoder_embed_dim=768, decoder_depth=3, decoder_num_heads=6),
    "mar_small": dict(encoder_embed_dim=768, encoder_depth=6, encoder_num_heads=6,
                      decoder_embed_dim=768, decoder_depth=6, decoder_num_heads=6),
    "mar_base": dict(encoder_embed_dim=768, encoder_depth=12, encoder_num_heads=12,
                     decoder_embed_dim=768, decoder_depth=12, decoder_num_heads=12),
    "mar_large": dict(encoder_embed_dim=1024, encoder_depth=16, encoder_num_heads=16,
                      decoder_embed_dim=1024, decoder_depth=16, decoder_num_heads=16),
    "mar_huge": dict(encoder_embed_dim=1280, encoder_depth=20, encoder_num_heads=16,
                     decoder_embed_dim=1280, decoder_depth=20, decoder_num_heads=16),
}


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, L, C·p²), the reference layout (mar_con_unified.py:393-401)."""
    B, C, H, W = x.shape
    p = patch_size
    if p == 1:
        return x.permute(0, 2, 3, 1).reshape(B, H * W, C)
    h, w = H // p, W // p
    x = x.reshape(B, C, h, p, w, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, h * w, C * p * p)


class Mar(nn.Module):
    def __init__(self, cfg: MarConfig):
        super().__init__()
        self.cfg = c = cfg
        D, Dd = c.encoder_embed_dim, c.decoder_embed_dim
        self.z_proj_cond = nn.Linear(c.token_embed_dim, D)
        self.z_proj = nn.Linear(c.token_embed_dim, D)
        self.action_proj_cond = nn.Linear(c.action_dim, D)
        # channel concat of (target stream, cond stream, action stream)
        self.proj_cond_x_layer = nn.Linear(3 * D, D)
        self.z_proj_ln = nn.LayerNorm(D, eps=1e-6)
        self.fake_latent_x = nn.Parameter(torch.zeros(1, D))
        self.fake_action_latent = nn.Parameter(torch.zeros(1, D))
        if c.has_text:
            self.fake_latent = nn.Parameter(torch.zeros(1, D))
            self.text_proj_cond = nn.Linear(CLIP_DIM, D)
            self.text_pos_embed = nn.Parameter(torch.zeros(1, c.buffer_size_text, D))
            self.decoder_text_pos_embed = nn.Parameter(torch.zeros(1, c.buffer_size_text, Dd))
        self.temporal_pos_embed = nn.Parameter(torch.zeros(1, c.n_frames, D))
        self.spatial_pos_embed = nn.Parameter(torch.zeros(1, c.seq_len, D))
        self.decoder_temporal_pos_embed = nn.Parameter(torch.zeros(1, c.n_frames, Dd))
        self.decoder_spatial_pos_embed = nn.Parameter(torch.zeros(1, c.seq_len, Dd))
        self.diffusion_temporal_embed = nn.Parameter(torch.zeros(1, c.n_frames, Dd))
        self.diffusion_spatial_embed = nn.Parameter(torch.zeros(1, c.seq_len, Dd))
        self.encoder_blocks = TransformerStack(
            c.encoder_depth, D, c.encoder_num_heads, c.mlp_ratio, c.quant
        )
        self.encoder_norm = nn.LayerNorm(D, eps=1e-6)
        self.decoder_embed = nn.Linear(D, Dd)
        self.decoder_blocks = TransformerStack(
            c.decoder_depth, Dd, c.decoder_num_heads, c.mlp_ratio, c.quant
        )
        self.decoder_norm = nn.LayerNorm(Dd, eps=1e-6)
        self.diffactloss = ActionDiffusionHead(
            target_channels=c.action_dim,
            z_channels=Dd,
            width=c.diffloss_act_w,
            depth=c.diffloss_act_d,
            n_frames=c.n_frames,
            num_actions=c.num_action_tokens,
            act_diff_testing_steps=c.act_diff_testing_steps,
            act_model_type=c.act_model_type,
            quant=c.quant,
        )

    @staticmethod
    def _factorized(temporal: torch.Tensor, spatial: torch.Tensor) -> torch.Tensor:
        """(1, T, D) + (1, S, D) -> (1, T·S, D) position embedding."""
        return (temporal[:, :, None, :] + spatial[:, None, :, :]).flatten(1, 2)

    def forward_encoder(self, cond_tokens: torch.Tensor,
                        text_latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``policy_model`` encoder: (B, T, S, C_tok) conditioning tokens ->
        (B, T·S, D), or with language (B, 64 + T·S, D). The target stream is
        the learned fake latent, and the action stream the fake action
        latent repeated over the tokens. ``text_latents``: the projected
        goal (B, D) (:meth:`policy_latents` projects it), or None for the
        learned null latent ``fake_latent``."""
        c = self.cfg
        B, T, S, _ = cond_tokens.shape
        L = T * S
        dtype = self.z_proj_cond.weight.dtype
        cond = self.z_proj_cond(cond_tokens.to(dtype)).reshape(B, L, -1)
        x = self.fake_latent_x[None].expand(B, L, -1)
        if L % c.num_action_tokens:
            raise ValueError(f"{L} tokens do not split into {c.num_action_tokens} action slots")
        act = self.fake_action_latent[None].expand(B, c.num_action_tokens, -1)
        act = act.repeat_interleave(L // c.num_action_tokens, dim=1)
        h = self.proj_cond_x_layer(torch.cat([x, cond, act], dim=-1))
        h = h + self._factorized(self.temporal_pos_embed, self.spatial_pos_embed)
        if c.has_text:
            if text_latents is None:
                txt = self.fake_latent[None].expand(B, c.buffer_size_text, -1).to(h.dtype)
            else:
                txt = text_latents[:, None, :].expand(B, c.buffer_size_text, -1)
            txt = txt + self.text_pos_embed.to(txt.dtype)
            h = torch.cat([txt.to(h.dtype), h], dim=1)
        h = self.encoder_blocks(self.z_proj_ln(h))
        return self.encoder_norm(h)

    def forward_decoder(self, h: torch.Tensor) -> torch.Tensor:
        """(B, [64 +] T·S, D) encoder output -> (B, T·S, Dd): the text
        buffer, where there is one, is dropped after the decoder's norm."""
        c = self.cfg
        z = self.decoder_embed(h)
        pos = self._factorized(self.decoder_temporal_pos_embed, self.decoder_spatial_pos_embed)
        if c.has_text:
            pos = torch.cat([self.decoder_text_pos_embed, pos], dim=1)
        z = z + pos
        z = self.decoder_norm(self.decoder_blocks(z))
        if c.has_text:
            z = z[:, c.buffer_size_text:]
        return z + self._factorized(self.diffusion_temporal_embed, self.diffusion_spatial_embed)

    def policy_latents(self, cond_frames: torch.Tensor,
                       text_latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, C, h, w) conditioning latents -> (B, T·S, D) decoder output
        that conditions the action head: one encoder+decoder pass.
        ``text_latents``: the raw (B, 512) goal latents, projected here by
        ``text_proj_cond`` (``mar.py:670-671``); ignored without language."""
        c = self.cfg
        B, T = cond_frames.shape[:2]
        cond_tokens = patchify(cond_frames.reshape(B * T, *cond_frames.shape[2:]), c.patch_size)
        cond_tokens = cond_tokens.reshape(B, T, c.seq_len, c.token_embed_dim)
        if text_latents is not None and c.has_text:
            text_latents = self.text_proj_cond(text_latents.to(self.text_proj_cond.weight.dtype))
        else:
            text_latents = None
        return self.forward_decoder(self.forward_encoder(cond_tokens, text_latents))

    def sample_policy(self, cond_frames: torch.Tensor, noise: torch.Tensor,
                      step_noise: torch.Tensor, temperature: float = 1.0,
                      text_latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, C, h, w) conditioning latents -> (B, 16, action_dim): the
        decoder output, then the action sampler from injected noise."""
        z = self.policy_latents(cond_frames, text_latents)
        return self.diffactloss.sample(z, noise, step_noise, temperature=temperature)
