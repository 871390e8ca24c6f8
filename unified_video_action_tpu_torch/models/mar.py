"""MAR unified video-action transformer (port of ``models/mar.py``:
``MarConfig``, ``MODEL_SIZES``, ``patchify`` and ``unpatchify`` (:143-162),
``sample_mask_rate`` and ``random_spatial_mask`` (:165-182),
``sample_orders`` (:184-188), ``forward_encoder`` and ``forward_decoder`` in
all five task modes (:339-500), the training ``__call__`` (:506-595, here
``forward``), ``sample_policy`` (:632-684) and ``sample_video``
(:686-852)).

Serving is one encoder+decoder pass over the conditioning frames' latent
tokens in ``policy_model`` mode, then the action head's diffusion sampler.
Training runs one task mode of ``TASK_MODES`` per call: the target stream is
the target frames' tokens (masked to ``fake_latent_x`` where the spatial
mask is 1), the conditioning frames' tokens, or the fake latent, by mode;
the action stream is the projected actions in ``dynamic_model`` and the fake
action latent otherwise; the video head's loss covers the masked tokens of
the video modes and the action head's loss the action modes. The draws (the
spatial mask, each head's steps and noise, the history keep mask and the
label drop) are passed in. Parameters carry the flax names so ``convert.py``
maps the JAX tree by name.

The streams are fused channel by channel (``mar.py:357-440``): the target
stream, the wrist camera's target stream (``predict_wrist_img``: its
tokens, masked as the target's, or ``fake_latent_wrist_x``), the
conditioning stream, the history actions (``use_history_action``: the
projected past actions, each kept with probability ``action_mask_ratio`` in
training, else ``fake_latent_history_action``), the action stream and the
proprioception (``use_proprioception``: the projected state and, with
``proprio_use_image``, the second camera's conditioning tokens). Each
low-rate stream is repeated over the frame tokens. With
``language_emb_model="clip"`` a 64-token text buffer goes before the frame
tokens (``mar.py:449-475``, ``:489-495``): the projected goal latent
repeated, or the learned ``fake_latent`` when no goal is given (and in
training where the label drop of classifier-free guidance falls), plus its
own position embeddings; the decoder drops it again. Training adds the
wrist video head's loss (``diffloss_wrist``) to the video loss and the
proprioception head's (``diffproploss``, an action head over
``proprio_pred_dim`` channels) to the total.

``sample_video`` generates the target frames' latents MaskGIT-style: each of
``num_iter`` rounds runs the encoder and decoder over every token, then the
video head samples the tokens of the positions the round reveals (a cosine
schedule over a random order) and writes them into the target stream (the
wrist head likewise into the wrist stream, whose frames are then returned).
Under classifier-free guidance the batch is doubled, the second half
conditioned on ``fake_latent`` in place of the projected goal. Its draws
(the order and each round's head noise) are injected or drawn from a
generator, as the action sampler's are.
``MarConfig.quant`` makes the stacks' and the heads' dense layers W8A8
(``mar.py:104``); ``decoder_embed``, the stream projections and the wrist
video head stay float, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from unified_video_action_tpu_torch.models.heads import ActionDiffusionHead, VideoDiffusionHead
from unified_video_action_tpu_torch.models.transformer import TransformerStack, dense
from unified_video_action_tpu_torch.utils.language import CLIP_DIM

TASK_MODES = (
    "video_model",
    "dynamic_model",
    "policy_model",
    "inverse_model",
    "full_dynamic_model",
)
VIDEO_MODES = ("video_model", "dynamic_model", "full_dynamic_model")
ACTION_MODES = ("policy_model", "inverse_model", "full_dynamic_model")
# a forward's dropout: None, a generator that draws each block's masks, or
# {"encoder_blocks": [...], "decoder_blocks": [...]} of every block's masks
MarDropout = Union[None, torch.Generator, Mapping[str, list]]


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
    attn_dropout: float = 0.1
    proj_dropout: float = 0.1
    # training: the mask ratio's lower end
    mask_ratio_min: float = 0.7
    # video head
    diffloss_d: int = 6
    diffloss_w: int = 1024
    num_sampling_steps: str = "100"
    predict_video: bool = True
    # action head
    predict_action: bool = True
    act_diff_training_steps: int = 1000
    diffloss_act_d: int = 6
    diffloss_act_w: int = 1024
    act_diff_testing_steps: str = "100"
    act_model_type: str = "conv_fc"
    action_dim: int = 2
    num_action_tokens: int = 16
    # language conditioning: "clip" prepends a text buffer of this many tokens;
    # training replaces a goal by the null latent at this rate (the CFG label drop)
    language_emb_model: Optional[str] = None
    buffer_size_text: int = 64
    label_drop_prob: float = 0.1
    # conditioning streams (mar.py:90-98)
    use_proprioception: bool = False
    use_history_action: bool = False
    action_mask_ratio: float = 0.5  # the share of history actions kept in training
    different_history_freq: bool = False
    predict_wrist_img: bool = False
    predict_proprioception: bool = False
    proprio_dim: int = 0  # the width of the concatenated state vector
    proprio_pred_dim: int = 0  # the proprioception head's target width
    proprio_use_image: bool = False  # the second camera conditions (robomimic)
    task_name: str = "pusht"
    # int8 W8A8 dense layers in both stacks and both denoisers (serving)
    quant: bool = False
    # torch.utils.checkpoint per ViT block in training (flax's nn.remat)
    grad_checkpointing: bool = False

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
    def buffer_size_proprio(self) -> int:
        return 64 * 4 if self.different_history_freq else 64

    @property
    def n_streams(self) -> int:
        """The streams ``proj_cond_x_layer`` fuses: target, conditioning and
        actions, plus the wrist camera's, the history actions' and the
        proprioception's (two with the second camera)."""
        proprio = (2 if self.proprio_use_image else 1) if self.use_proprioception else 0
        return 3 + self.predict_wrist_img + self.use_history_action + proprio

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


def unpatchify(x: torch.Tensor, patch_size: int, vae_embed_dim: int, seq_hw: int) -> torch.Tensor:
    """(B, L, C·p²) -> (B, C, h·p, w·p), the inverse of :func:`patchify`."""
    B = x.shape[0]
    p, c, hw = patch_size, vae_embed_dim, seq_hw
    if p == 1:
        return x.reshape(B, hw, hw, c).permute(0, 3, 1, 2)
    x = x.reshape(B, hw, hw, c, p, p).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B, c, hw * p, hw * p)


def sample_orders(batch: int, seq_len: int, generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """(batch, seq_len) int64 random generation orders as ranks: rank[b, s]
    is the place of token s in row b's order."""
    u = torch.rand((batch, seq_len), generator=generator, device=device)
    return u.argsort(dim=-1).argsort(dim=-1)


def mask_schedule(seq_len: int, num_iter: int) -> List[int]:
    """The tokens still masked after each MaskGIT round (``mar.py:781-788``):
    floor(S·cos(π/2·(step+1)/num_iter)), at least 1 and at most one fewer than
    the round before, and 0 after the last."""
    lens, prev = [], seq_len
    for step in range(num_iter):
        ml = int(np.floor(seq_len * np.cos(math.pi / 2.0 * (step + 1) / num_iter)))
        ml = max(1, min(prev - 1, ml)) if step < num_iter - 1 else 0
        lens.append(ml)
        prev = ml
    return lens


def sample_mask_rate(mask_ratio_min: float, generator: torch.Generator,
                     device: torch.device) -> torch.Tensor:
    """The mask rate, a scalar: a gaussian centred at 1.0 with std 0.25,
    truncated to [mask_ratio_min, 1.0] (mar_con_unified.py:85-88), drawn by
    the inverse CDF."""
    lower = torch.tensor((mask_ratio_min - 1.0) / 0.25, device=device)
    a, b = torch.special.ndtr(lower), 0.5  # the CDF at the two ends
    u = torch.rand((), generator=generator, device=device)
    return torch.special.ndtri(a + u * (b - a)) * 0.25 + 1.0


def random_spatial_mask(rate: torch.Tensor, batch: int, seq_len: int, generator: torch.Generator,
                        device: torch.device) -> torch.Tensor:
    """(batch, seq_len) float mask with ceil(seq_len·rate) ones per row at
    random positions: the rank of a uniform draw below that count."""
    u = torch.rand((batch, seq_len), generator=generator, device=device)
    rank = u.argsort(dim=-1).argsort(dim=-1)
    return (rank < torch.ceil(seq_len * rate)).float()


def _repeat_stream(stream: torch.Tensor, tokens: int, name: str) -> torch.Tensor:
    """(B, n, D) -> (B, tokens, D), each row repeated tokens / n times (the
    reference's repeat_interleave); a stream whose rows do not divide the
    tokens is refused, as JAX's assertion refuses it."""
    if tokens % stream.shape[1]:
        raise ValueError(f"the {name} stream's {stream.shape[1]} rows do not divide the "
                         f"{tokens} frame tokens")
    return stream.repeat_interleave(tokens // stream.shape[1], dim=1)


def _blend(fake: torch.Tensor, x: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
    """x with its rows replaced by ``fake`` (1, D) where ``where`` (B, n) holds."""
    return torch.where(where[..., None], fake[None].to(x.dtype), x)


class Mar(nn.Module):
    def __init__(self, cfg: MarConfig):
        super().__init__()
        self.cfg = c = cfg
        D, Dd = c.encoder_embed_dim, c.decoder_embed_dim

        def proj(width: int) -> nn.Module:
            return dense(width, D, False, "xavier_uniform")

        self.z_proj_cond = proj(c.token_embed_dim)
        self.z_proj = proj(c.token_embed_dim)
        self.action_proj_cond = proj(c.action_dim)
        # channel concat of the streams (MarConfig.n_streams)
        self.proj_cond_x_layer = dense(c.n_streams * D, D, False, "xavier_uniform")
        self.z_proj_ln = nn.LayerNorm(D, eps=1e-6)
        self.fake_latent_x = nn.Parameter(torch.zeros(1, D))
        self.fake_action_latent = nn.Parameter(torch.zeros(1, D))
        if c.predict_wrist_img:
            self.z_proj_wrist = proj(c.token_embed_dim)
            self.fake_latent_wrist_x = nn.Parameter(torch.zeros(1, D))
        if c.use_history_action:
            self.history_action_proj_cond = proj(c.action_dim)
            self.fake_latent_history_action = nn.Parameter(torch.zeros(1, D))
        if c.use_proprioception:
            self.proprioception_proj_cond = proj(c.proprio_dim)
            # built whatever proprio_use_image says, as JAX builds it
            # (mar.py:222-229): unused without the second camera
            self.proprioception_image_proj_cond = proj(c.token_embed_dim)
        if c.has_text:
            self.fake_latent = nn.Parameter(torch.zeros(1, D))
            self.text_proj_cond = proj(CLIP_DIM)
            self.text_pos_embed = nn.Parameter(torch.zeros(1, c.buffer_size_text, D))
            self.decoder_text_pos_embed = nn.Parameter(torch.zeros(1, c.buffer_size_text, Dd))
        self.temporal_pos_embed = nn.Parameter(torch.zeros(1, c.n_frames, D))
        self.spatial_pos_embed = nn.Parameter(torch.zeros(1, c.seq_len, D))
        self.decoder_temporal_pos_embed = nn.Parameter(torch.zeros(1, c.n_frames, Dd))
        self.decoder_spatial_pos_embed = nn.Parameter(torch.zeros(1, c.seq_len, Dd))
        self.diffusion_temporal_embed = nn.Parameter(torch.zeros(1, c.n_frames, Dd))
        self.diffusion_spatial_embed = nn.Parameter(torch.zeros(1, c.seq_len, Dd))
        stack = dict(mlp_ratio=c.mlp_ratio, quant=c.quant, attn_dropout=c.attn_dropout,
                     proj_dropout=c.proj_dropout, remat=c.grad_checkpointing)
        self.encoder_blocks = TransformerStack(c.encoder_depth, D, c.encoder_num_heads, **stack)
        self.encoder_norm = nn.LayerNorm(D, eps=1e-6)
        self.decoder_embed = dense(D, Dd, False, "xavier_uniform")
        self.decoder_blocks = TransformerStack(c.decoder_depth, Dd, c.decoder_num_heads, **stack)
        self.decoder_norm = nn.LayerNorm(Dd, eps=1e-6)
        video_head = dict(target_channels=c.token_embed_dim, z_channels=Dd, width=c.diffloss_w,
                          depth=c.diffloss_d, num_sampling_steps=c.num_sampling_steps)
        action_head = dict(z_channels=Dd, width=c.diffloss_act_w, depth=c.diffloss_act_d,
                           n_frames=c.n_frames, num_actions=c.num_action_tokens,
                           act_diff_training_steps=c.act_diff_training_steps,
                           act_diff_testing_steps=c.act_diff_testing_steps,
                           act_model_type=c.act_model_type, quant=c.quant)
        if c.predict_video:
            self.diffloss = VideoDiffusionHead(**video_head, quant=c.quant)
            if c.predict_wrist_img:  # JAX gives the wrist head no quant
                self.diffloss_wrist = VideoDiffusionHead(**video_head)
        if c.predict_action:
            self.diffactloss = ActionDiffusionHead(target_channels=c.action_dim, **action_head)
        if c.predict_proprioception:
            self.diffproploss = ActionDiffusionHead(target_channels=c.proprio_pred_dim, **action_head)

    @staticmethod
    def _factorized(temporal: torch.Tensor, spatial: torch.Tensor) -> torch.Tensor:
        """(1, T, D) + (1, S, D) -> (1, T·S, D) position embedding."""
        return (temporal[:, :, None, :] + spatial[:, None, :, :]).flatten(1, 2)

    @staticmethod
    def _stack_drop(drop: MarDropout, stack: str):
        return drop if drop is None or isinstance(drop, torch.Generator) else drop[stack]

    def _wrist_stream(self, proprio: Optional[Mapping[str, torch.Tensor]], B: int,
                      L: int) -> torch.Tensor:
        if proprio is None or "pred_second_image_tokens" not in proprio:
            raise ValueError("predict_wrist_img needs proprio['pred_second_image'] outside "
                             "policy_model")
        tokens = proprio["pred_second_image_tokens"]
        return self.z_proj_wrist(tokens.to(self.z_proj_wrist.weight.dtype)).reshape(B, L, -1)

    def forward_encoder(self, cond_tokens: torch.Tensor,
                        text_latents: Optional[torch.Tensor] = None,
                        task_mode: str = "policy_model",
                        x_tokens: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None,
                        actions: Optional[torch.Tensor] = None,
                        drop: MarDropout = None,
                        history_actions: Optional[torch.Tensor] = None,
                        proprio: Optional[Mapping[str, torch.Tensor]] = None,
                        history_keep: Optional[torch.Tensor] = None,
                        label_drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, S, C_tok) conditioning tokens -> (B, T·S, D), or with
        language (B, 64 + T·S, D). By ``task_mode``: ``policy_model`` takes
        the learned fake latent as the target stream; ``inverse_model`` the
        target tokens ``x_tokens`` and the fake latent as the conditioning
        stream; the video modes the target tokens with the fake latent where
        ``mask`` (B, T, S) is 1. The action stream is the projected
        ``actions`` (B, 16, A) in ``dynamic_model``, else the fake action
        latent, repeated over the tokens. ``text_latents``: the projected
        goal (B, D) (:meth:`policy_latents` projects it), or None for the
        learned null latent ``fake_latent``. ``history_actions`` (B, n, A):
        the past actions (None: the fake history latent); ``proprio``:
        ``{"state": (B, n, proprio_dim), "second_image_tokens" and
        "pred_second_image_tokens": (B, T, S, C_tok)}`` as the config needs
        them. Training only: ``history_keep`` (B, n) bool keeps a history
        action (the others take the fake latent), ``label_drop`` (B,) bool
        replaces a row's goal by ``fake_latent``, ``drop`` the blocks'
        dropout."""
        c = self.cfg
        B, T, S, _ = cond_tokens.shape
        L = T * S
        dtype = self.z_proj_cond.weight.dtype
        wrist = None
        if task_mode == "inverse_model":
            x = self.z_proj(x_tokens.to(dtype)).reshape(B, L, -1)
            cond = self.fake_latent_x[None].expand(B, L, -1).to(x.dtype)
            if c.predict_wrist_img:
                wrist = self._wrist_stream(proprio, B, L)
        else:
            cond = self.z_proj_cond(cond_tokens.to(dtype)).reshape(B, L, -1)
            if task_mode == "policy_model":
                x = self.fake_latent_x[None].expand(B, L, -1).to(cond.dtype)
                if c.predict_wrist_img:
                    wrist = self.fake_latent_wrist_x[None].expand(B, L, -1).to(cond.dtype)
            else:
                masked = mask.reshape(B, L) == 1.0
                x = _blend(self.fake_latent_x, self.z_proj(x_tokens.to(dtype)).reshape(B, L, -1),
                           masked)
                if c.predict_wrist_img:
                    wrist = _blend(self.fake_latent_wrist_x, self._wrist_stream(proprio, B, L), masked)
        parts = [x, cond] if wrist is None else [x, wrist, cond]
        if c.use_history_action:
            if history_actions is None:
                hist = self.fake_latent_history_action[None].expand(
                    B, c.num_action_tokens, -1).to(x.dtype)
            else:
                hist = self.history_action_proj_cond(history_actions.to(dtype))
                if history_keep is not None:
                    hist = _blend(self.fake_latent_history_action, hist, ~history_keep.bool())
            parts.append(_repeat_stream(hist, L, "history action"))
        if task_mode == "dynamic_model":
            act = self.action_proj_cond(actions.to(dtype))
        else:
            act = self.fake_action_latent[None].expand(B, c.num_action_tokens, -1).to(x.dtype)
        parts.append(_repeat_stream(act, L, "action"))
        if c.use_proprioception:
            if proprio is None or "state" not in proprio:
                raise ValueError("use_proprioception needs proprio['state']")
            state = self.proprioception_proj_cond(proprio["state"].float().to(dtype))
            state = _repeat_stream(state, L, "proprioception")
            if c.proprio_use_image:
                img = self.proprioception_image_proj_cond(
                    proprio["second_image_tokens"].to(dtype)).reshape(B, L, -1)
                parts.append(img)
            parts.append(state)
        h = self.proj_cond_x_layer(torch.cat(parts, dim=-1))
        h = h + self._factorized(self.temporal_pos_embed, self.spatial_pos_embed)
        if c.has_text:
            if text_latents is None:
                txt = self.fake_latent[None].expand(B, c.buffer_size_text, -1).to(h.dtype)
            else:
                txt = text_latents[:, None, :].expand(B, c.buffer_size_text, -1)
                if label_drop is not None:  # JAX's blend (mar.py:463-473)
                    d = label_drop.to(txt.dtype)[:, None, None]
                    txt = d * self.fake_latent[None].to(txt.dtype) + (1.0 - d) * txt
            txt = txt + self.text_pos_embed.to(txt.dtype)
            h = torch.cat([txt.to(h.dtype), h], dim=1)
        h = self.encoder_blocks(self.z_proj_ln(h), self._stack_drop(drop, "encoder_blocks"))
        return self.encoder_norm(h)

    def forward_decoder(self, h: torch.Tensor, drop: MarDropout = None) -> torch.Tensor:
        """(B, [64 +] T·S, D) encoder output -> (B, T·S, Dd): the text
        buffer, where there is one, is dropped after the decoder's norm."""
        c = self.cfg
        z = self.decoder_embed(h)
        pos = self._factorized(self.decoder_temporal_pos_embed, self.decoder_spatial_pos_embed)
        if c.has_text:
            pos = torch.cat([self.decoder_text_pos_embed, pos], dim=1)
        z = z + pos
        z = self.decoder_norm(self.decoder_blocks(z, self._stack_drop(drop, "decoder_blocks")))
        if c.has_text:
            z = z[:, c.buffer_size_text:]
        return z + self._factorized(self.diffusion_temporal_embed, self.diffusion_spatial_embed)

    def _tokens(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, C, h, w) latents -> (B, T, S, C_tok) tokens."""
        c = self.cfg
        B, T = frames.shape[:2]
        tokens = patchify(frames.reshape(B * T, *frames.shape[2:]), c.patch_size)
        return tokens.reshape(B, T, c.seq_len, c.token_embed_dim)

    def _proprio_tokens(self, proprio: Optional[Mapping[str, torch.Tensor]],
                        keys: Tuple[str, ...] = ("second_image",)
                        ) -> Optional[Dict[str, torch.Tensor]]:
        """A copy of ``proprio`` with the tokens of its second-camera latents
        named in ``keys`` ((B, T, C, h, w) each) beside them: training reads
        ``pred_second_image`` too, sampling only ``second_image``, as in JAX."""
        if proprio is None:
            return None
        out = dict(proprio)
        for k in keys:
            if k in out:
                out[k + "_tokens"] = self._tokens(out[k])
        return out

    def _project_text(self, text_latents: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The raw (B, 512) goal latents through ``text_proj_cond``
        (``mar.py:549-550``), or None without language or without a goal."""
        if text_latents is None or not self.cfg.has_text:
            return None
        return self.text_proj_cond(text_latents.to(self.text_proj_cond.weight.dtype))

    def train_draw_shapes(self, batch: int, n_history: Optional[int] = None) -> Dict[str, tuple]:
        """Shapes of a training forward's draws: the spatial mask (B, S), each
        head's steps and standard-normal noise (the wrist video head's and
        the proprioception head's where the config has them), the history
        keep mask over ``n_history`` past actions (with history actions) and
        the label drop (with language)."""
        c = self.cfg
        n_video, n_act = batch * c.total_tokens, batch * c.num_action_tokens
        out = {"mask": (batch, c.seq_len),
               "video_t": (n_video,), "video_noise": (n_video, c.token_embed_dim),
               "action_t": (n_act,), "action_noise": (n_act, c.action_dim)}
        if c.predict_wrist_img:
            out.update(wrist_t=(n_video,), wrist_noise=(n_video, c.token_embed_dim))
        if c.predict_proprioception:
            out.update(prop_t=(n_act,), prop_noise=(n_act, c.proprio_pred_dim))
        if c.use_history_action:
            out["history_keep"] = (batch, n_history or c.num_action_tokens)
        if c.has_text:
            out["label_drop"] = (batch,)
        return out

    def sample_train_draws(self, batch: int, generator: torch.Generator, device: torch.device,
                           n_history: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The draws of one training forward from ``generator``: the mask rate
        and spatial mask (``mar.py:552-555``), each head's steps in [0,
        training steps) and noise, the history keep mask (a uniform draw at
        most ``action_mask_ratio``) and the label drop (a uniform draw below
        ``label_drop_prob``)."""
        c = self.cfg
        shapes = self.train_draw_shapes(batch, n_history)
        rate = sample_mask_rate(c.mask_ratio_min, generator, device)
        out = {"mask": random_spatial_mask(rate, batch, c.seq_len, generator, device)}
        # the video heads' training diffusion has 1000 steps (heads.py:53)
        steps = {"video": 1000, "wrist": 1000, "action": c.act_diff_training_steps,
                 "prop": c.act_diff_training_steps}
        for head, n in steps.items():
            if f"{head}_t" in shapes:
                out[f"{head}_t"] = torch.randint(0, n, shapes[f"{head}_t"], generator=generator,
                                                 device=device)
                out[f"{head}_noise"] = torch.randn(shapes[f"{head}_noise"], generator=generator,
                                                   device=device)
        if "history_keep" in shapes:
            u = torch.rand(shapes["history_keep"], generator=generator, device=device)
            out["history_keep"] = u <= c.action_mask_ratio
        if "label_drop" in shapes:
            u = torch.rand(shapes["label_drop"], generator=generator, device=device)
            out["label_drop"] = u < c.label_drop_prob
        return out

    def draw_dropout(self, batch: int, generator: torch.Generator,
                     device: torch.device) -> Dict[str, list]:
        """Every block's keep masks for one training forward at ``batch``, in
        the form ``forward``'s ``drop`` takes (to hand the same masks to two
        runs)."""
        n = self.cfg.attention_tokens
        return {name: [blk.draw_masks(batch, n, generator, device)
                       for blk in getattr(self, name).blocks()]
                for name in ("encoder_blocks", "decoder_blocks")}

    def forward(self, x_frames: torch.Tensor, cond_frames: torch.Tensor, task_mode: str,
                actions: torch.Tensor, draws: Mapping[str, torch.Tensor],
                drop: MarDropout = None, history_actions: Optional[torch.Tensor] = None,
                text_latents: Optional[torch.Tensor] = None,
                proprio: Optional[Mapping[str, torch.Tensor]] = None,
                proprio_target: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training forward of one task mode (``mar.py:506-595``): (B, T, C,
        h, w) target and conditioning latents, the (B, 16, A) normalized
        action chunk and the draws of :meth:`sample_train_draws` -> (loss,
        video loss, action loss), fp32 scalars. ``history_actions`` (B, n,
        A), ``text_latents`` the raw (B, 512) goals, ``proprio`` (``state``
        and the second camera's latents ``second_image`` and
        ``pred_second_image``, (B, T, C, h, w)) and ``proprio_target`` (B,
        16, proprio_pred_dim) feed the streams and heads the config has; the
        wrist head's loss joins the video loss, the proprioception head's
        the total."""
        c = self.cfg
        if task_mode not in TASK_MODES:
            raise ValueError(f"task_mode must be one of {TASK_MODES}, got {task_mode!r}")
        B, T = x_frames.shape[:2]
        x_tokens, cond_tokens = self._tokens(x_frames), self._tokens(cond_frames)
        proprio = self._proprio_tokens(proprio, ("second_image", "pred_second_image"))
        gt_latents = x_tokens.detach().reshape(B, c.total_tokens, c.token_embed_dim)
        text_latents = self._project_text(text_latents)
        history_keep = label_drop = None
        if c.use_history_action and history_actions is not None:
            history_keep = draws["history_keep"]
        if text_latents is not None:
            label_drop = draws["label_drop"]
        mask = draws["mask"][:, None, :].expand(B, T, c.seq_len)
        h = self.forward_encoder(cond_tokens, text_latents, task_mode, x_tokens, mask, actions, drop,
                                 history_actions, proprio, history_keep, label_drop)
        z = self.forward_decoder(h, drop)
        flat_mask = mask.reshape(B, c.total_tokens)
        zero = torch.zeros((), dtype=torch.float32, device=z.device)
        video_loss, act_loss = zero, zero
        if c.predict_video and task_mode in VIDEO_MODES:
            video_loss = self.diffloss.loss(gt_latents, z, flat_mask, draws["video_t"],
                                            draws["video_noise"])
            if c.predict_wrist_img:
                gt_wrist = proprio["pred_second_image_tokens"].detach().reshape(
                    B, c.total_tokens, c.token_embed_dim)
                video_loss = video_loss + self.diffloss_wrist.loss(
                    gt_wrist, z, flat_mask, draws["wrist_t"], draws["wrist_noise"])
        if c.predict_action and task_mode in ACTION_MODES:
            act_loss = self.diffactloss.loss(actions, z, draws["action_t"], draws["action_noise"])
        loss = video_loss + act_loss
        if c.predict_proprioception:
            if proprio_target is None:
                raise ValueError("predict_proprioception needs proprio_target")
            loss = loss + self.diffproploss.loss(proprio_target, z, draws["prop_t"],
                                                 draws["prop_noise"])
        return loss, video_loss, act_loss

    def policy_latents(self, cond_frames: torch.Tensor,
                       text_latents: Optional[torch.Tensor] = None,
                       history_actions: Optional[torch.Tensor] = None,
                       proprio: Optional[Mapping[str, torch.Tensor]] = None,
                       task_mode: str = "policy_model",
                       x_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, C, h, w) conditioning latents -> (B, T·S, D) decoder output
        that conditions the action head: one encoder+decoder pass
        (``mar.py:645-683``). ``text_latents``: the raw (B, 512) goal
        latents, projected here by ``text_proj_cond``; ignored without
        language. ``history_actions`` and ``proprio`` (``state``,
        ``second_image`` latents) feed their streams. In ``inverse_model``
        the target latents ``x_frames`` are given and nothing is masked; in
        the other modes the target is all masked."""
        c = self.cfg
        B, T = cond_frames.shape[:2]
        cond_tokens = self._tokens(cond_frames)
        if task_mode == "inverse_model":
            x_tokens = self._tokens(x_frames)
            mask = torch.zeros((B, T, c.seq_len), device=cond_frames.device)
        else:
            x_tokens = torch.zeros_like(cond_tokens)
            mask = torch.ones((B, T, c.seq_len), device=cond_frames.device)
        h = self.forward_encoder(cond_tokens, self._project_text(text_latents), task_mode, x_tokens,
                                 mask, history_actions=history_actions,
                                 proprio=self._proprio_tokens(proprio))
        return self.forward_decoder(h)

    def sample_policy(self, cond_frames: torch.Tensor, noise: torch.Tensor,
                      step_noise: torch.Tensor, temperature: float = 1.0,
                      text_latents: Optional[torch.Tensor] = None,
                      history_actions: Optional[torch.Tensor] = None,
                      proprio: Optional[Mapping[str, torch.Tensor]] = None,
                      task_mode: str = "policy_model",
                      x_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, C, h, w) conditioning latents -> (B, 16, action_dim): the
        decoder output of :meth:`policy_latents`, then the action sampler
        from injected noise."""
        z = self.policy_latents(cond_frames, text_latents, history_actions, proprio, task_mode,
                                x_frames)
        return self.diffactloss.sample(z, noise, step_noise, temperature=temperature)

    # -- video generation ---------------------------------------------------

    def _samples_action(self, task_mode: str) -> bool:
        return self.cfg.predict_action and task_mode in ACTION_MODES

    def video_draw_shapes(self, batch: int, num_iter: int = 1,
                          task_mode: str = "full_dynamic_model",
                          cfg: float = 1.0) -> Dict[str, object]:
        """Shapes of :meth:`sample_video`'s draws: ``order_rank`` (B, S), and a
        list of ``rounds``, each with the video head's ``video_init`` and
        ``video_steps`` (``VideoDiffusionHead.draw_shapes`` over the round's
        2B or B rows times T times the tokens it reveals), the wrist head's
        ``wrist_init`` and ``wrist_steps`` of the same shapes (with
        ``predict_wrist_img``) and, where the mode samples the action head,
        its ``action_init`` and ``action_steps``."""
        c = self.cfg
        B2 = 2 * batch if cfg != 1.0 else batch
        S, lens = c.seq_len, mask_schedule(c.seq_len, num_iter)
        rounds = []
        for step in range(num_iter):
            n_pred = (S if step == 0 else lens[step - 1]) - lens[step]
            head = self.diffloss.draw_shapes(B2 * c.n_frames * n_pred, cfg)
            shapes = {f"video_{k}": v for k, v in head.items()}
            if c.predict_wrist_img:
                shapes.update({f"wrist_{k}": v for k, v in head.items()})
            if self._samples_action(task_mode):
                n = batch * c.num_action_tokens
                shapes.update(action_init=(n, c.action_dim),
                              action_steps=(self.diffactloss.num_steps, n, c.action_dim))
            rounds.append(shapes)
        return {"order_rank": (batch, S), "rounds": rounds}

    def sample_video_draws(self, batch: int, generator: torch.Generator, device: torch.device,
                           num_iter: int = 1, task_mode: str = "full_dynamic_model",
                           cfg: float = 1.0) -> Dict[str, object]:
        """The draws of :meth:`video_draw_shapes` from ``generator``: a random
        order (:func:`sample_orders`) and standard-normal noise."""
        shapes = self.video_draw_shapes(batch, num_iter, task_mode, cfg)
        order = sample_orders(batch, self.cfg.seq_len, generator, device)
        rounds = [{k: torch.randn(s, generator=generator, device=device) for k, s in r.items()}
                  for r in shapes["rounds"]]
        return {"order_rank": order, "rounds": rounds}

    @torch.no_grad()
    def sample_video(self, cond_frames: torch.Tensor, draws: Mapping[str, object],
                     num_iter: int = 1, cfg: float = 1.0, cfg_schedule: str = "linear",
                     temperature: float = 1.0, task_mode: str = "full_dynamic_model",
                     actions: Optional[torch.Tensor] = None,
                     text_latents: Optional[torch.Tensor] = None,
                     history_actions: Optional[torch.Tensor] = None,
                     proprio: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """MaskGIT video generation (``mar.py:686-852``): (B, T, C, h, w)
        conditioning latents -> ((B·T, C, h, w) fp32 latents of the target
        frames, the (B, 16, A) action chunk of the last round or None).

        ``draws`` as :meth:`sample_video_draws` makes them. Round ``step``
        reveals the positions of ranks [next_len, cur_len) of
        :func:`mask_schedule`: their decoder outputs over all T frames go to
        the video head, whose samples replace those tokens; then the spatial
        mask keeps the ranks below next_len. The action head samples from
        the conditional rows at cfg 1 in the action modes. ``cfg != 1`` needs
        the raw (B, 512) ``text_latents`` of a language model: the second
        half of the doubled batch takes ``fake_latent``, and the video head
        guides at ``1 + (cfg-1)·(S-next_len)/S`` under ``cfg_schedule``
        ``"linear"``, else at ``cfg``. ``actions`` (B, 16, A) feed the action
        stream in ``dynamic_model``; ``history_actions`` and ``proprio`` as
        :meth:`policy_latents` takes them. With ``predict_wrist_img`` the
        wrist head samples the same positions into the wrist stream, and the
        wrist frames are returned, as JAX returns them."""
        c = self.cfg
        if task_mode not in TASK_MODES:
            raise ValueError(f"task_mode must be one of {TASK_MODES}, got {task_mode!r}")
        use_cfg = cfg != 1.0
        if use_cfg and (not c.has_text or text_latents is None):
            raise ValueError("cfg != 1.0 requires CLIP text conditioning (the only latent "
                             f"trained with drop), got language_emb_model={c.language_emb_model!r}")
        B, T = cond_frames.shape[:2]
        S = c.seq_len
        cond_tokens = self._tokens(cond_frames)
        text_latents = self._project_text(text_latents)
        proprio = self._proprio_tokens(proprio)

        def dup(a):  # the conditional and unconditional halves of the rows
            return torch.cat([a, a], dim=0) if use_cfg and a is not None else a

        if use_cfg:
            uncond = self.fake_latent.expand(B, -1).to(text_latents.dtype)
            text_latents = torch.cat([text_latents, uncond], dim=0)
        cond_tokens, actions, history_actions = dup(cond_tokens), dup(actions), dup(history_actions)
        if proprio is not None:
            proprio = {k: dup(v) for k, v in proprio.items()}
        want = self.video_draw_shapes(B, num_iter, task_mode, cfg)
        order_rank = draws["order_rank"]
        if tuple(order_rank.shape) != want["order_rank"] or len(draws["rounds"]) != num_iter:
            raise ValueError(f"draws must hold order_rank {want['order_rank']} and {num_iter} "
                             f"rounds, got {tuple(order_rank.shape)} and {len(draws['rounds'])}")
        # order_perm[b, r]: the position of rank r, so a round's revealed
        # positions are the slice order_perm[:, next_len:cur_len]
        order_perm = order_rank.argsort(dim=-1)
        tokens = torch.zeros((B, T, S, c.token_embed_dim), device=cond_frames.device)
        wrist_tokens = torch.zeros_like(tokens) if c.predict_wrist_img else None
        spatial_mask = torch.ones((B, S), device=cond_frames.device)
        act_out = None
        lens = mask_schedule(S, num_iter)
        for step, r in enumerate(draws["rounds"]):
            for k, s in want["rounds"][step].items():
                if tuple(r[k].shape) != s:
                    raise ValueError(f"round {step}: {k} must be {s}, got {tuple(r[k].shape)}")
            mask = spatial_mask[:, None, :].expand(B, T, S)
            if c.predict_wrist_img:
                proprio = dict(proprio or {}, pred_second_image_tokens=dup(wrist_tokens))
            h = self.forward_encoder(cond_tokens, text_latents, task_mode, dup(tokens), dup(mask),
                                     actions, history_actions=history_actions, proprio=proprio)
            z = self.forward_decoder(h)
            if self._samples_action(task_mode):
                act_out = self.diffactloss.sample(z[:B], r["action_init"], r["action_steps"],
                                                  temperature=temperature)
            cur_len = S if step == 0 else lens[step - 1]
            next_len = lens[step]
            n_pred = cur_len - next_len
            pred_pos = order_perm[:, next_len:cur_len]  # (B, n_pred)
            cfg_iter = 1.0 + (cfg - 1.0) * (S - next_len) / S if cfg_schedule == "linear" else cfg
            pp = dup(pred_pos)
            z_g = z.reshape(pp.shape[0], T, S, -1).gather(
                2, pp[:, None, :, None].expand(-1, T, -1, z.shape[-1]))  # (B2, T, n_pred, D)
            z_g = z_g.reshape(-1, z.shape[-1])
            scatter = pred_pos[:, None, :, None].expand(-1, T, -1, c.token_embed_dim)

            def sample(head, init, steps):
                return head.sample(z_g, init, steps, temperature=temperature, cfg=cfg_iter
                                   ).reshape(pp.shape[0], T, n_pred, c.token_embed_dim)[:B]

            tokens = tokens.scatter(2, scatter, sample(self.diffloss, r["video_init"],
                                                       r["video_steps"]))
            if c.predict_wrist_img:
                wrist_tokens = wrist_tokens.scatter(2, scatter, sample(
                    self.diffloss_wrist, r["wrist_init"], r["wrist_steps"]))
            spatial_mask = (order_rank < next_len).float()
        out = wrist_tokens if c.predict_wrist_img else tokens
        frames = unpatchify(out.reshape(B * T, S, c.token_embed_dim), c.patch_size,
                            c.vae_embed_dim, c.seq_hw)
        return frames, act_out
