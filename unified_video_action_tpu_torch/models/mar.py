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
spatial mask, each head's steps and noise) are passed in. Parameters carry
the flax names so ``convert.py`` maps the JAX tree by name. With
``language_emb_model="clip"`` (the kitchen model) a 64-token text buffer goes
before the frame tokens (``mar.py:449-475``, ``:489-495``): the projected
goal latent repeated, or the learned ``fake_latent`` when no goal is given,
plus its own position embeddings; the decoder drops it again.

``sample_video`` generates the target frames' latents MaskGIT-style: each of
``num_iter`` rounds runs the encoder and decoder over every token, then the
video head samples the tokens of the positions the round reveals (a cosine
schedule over a random order) and writes them into the target stream.
Under classifier-free guidance the batch is doubled, the second half
conditioned on ``fake_latent`` in place of the projected goal. Its draws
(the order and each round's head noise) are injected or drawn from a
generator, as the action sampler's are. Training with a goal (the label
drop of classifier-free guidance), proprioception, wrist images and history
actions wait for later slices.
``MarConfig.quant`` makes the stacks' and both denoisers' dense layers W8A8
(``mar.py:104``); ``decoder_embed`` and the ``z_proj*`` layers stay float,
as in JAX.
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
    # language conditioning: "clip" prepends a text buffer of this many tokens
    language_emb_model: Optional[str] = None
    buffer_size_text: int = 64
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


class Mar(nn.Module):
    def __init__(self, cfg: MarConfig):
        super().__init__()
        self.cfg = c = cfg
        D, Dd = c.encoder_embed_dim, c.decoder_embed_dim
        self.z_proj_cond = dense(c.token_embed_dim, D, False, "xavier_uniform")
        self.z_proj = dense(c.token_embed_dim, D, False, "xavier_uniform")
        self.action_proj_cond = dense(c.action_dim, D, False, "xavier_uniform")
        # channel concat of (target stream, cond stream, action stream)
        self.proj_cond_x_layer = dense(3 * D, D, False, "xavier_uniform")
        self.z_proj_ln = nn.LayerNorm(D, eps=1e-6)
        self.fake_latent_x = nn.Parameter(torch.zeros(1, D))
        self.fake_action_latent = nn.Parameter(torch.zeros(1, D))
        if c.has_text:
            self.fake_latent = nn.Parameter(torch.zeros(1, D))
            self.text_proj_cond = dense(CLIP_DIM, D, False, "xavier_uniform")
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
        if c.predict_video:
            self.diffloss = VideoDiffusionHead(
                target_channels=c.token_embed_dim,
                z_channels=Dd,
                width=c.diffloss_w,
                depth=c.diffloss_d,
                num_sampling_steps=c.num_sampling_steps,
                quant=c.quant,
            )
        if c.predict_action:
            self.diffactloss = ActionDiffusionHead(
                target_channels=c.action_dim,
                z_channels=Dd,
                width=c.diffloss_act_w,
                depth=c.diffloss_act_d,
                n_frames=c.n_frames,
                num_actions=c.num_action_tokens,
                act_diff_training_steps=c.act_diff_training_steps,
                act_diff_testing_steps=c.act_diff_testing_steps,
                act_model_type=c.act_model_type,
                quant=c.quant,
            )

    @staticmethod
    def _factorized(temporal: torch.Tensor, spatial: torch.Tensor) -> torch.Tensor:
        """(1, T, D) + (1, S, D) -> (1, T·S, D) position embedding."""
        return (temporal[:, :, None, :] + spatial[:, None, :, :]).flatten(1, 2)

    @staticmethod
    def _stack_drop(drop: MarDropout, stack: str):
        return drop if drop is None or isinstance(drop, torch.Generator) else drop[stack]

    def forward_encoder(self, cond_tokens: torch.Tensor,
                        text_latents: Optional[torch.Tensor] = None,
                        task_mode: str = "policy_model",
                        x_tokens: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None,
                        actions: Optional[torch.Tensor] = None,
                        drop: MarDropout = None) -> torch.Tensor:
        """(B, T, S, C_tok) conditioning tokens -> (B, T·S, D), or with
        language (B, 64 + T·S, D). By ``task_mode``: ``policy_model`` takes
        the learned fake latent as the target stream; ``inverse_model`` the
        target tokens ``x_tokens`` and the fake latent as the conditioning
        stream; the video modes the target tokens with the fake latent where
        ``mask`` (B, T, S) is 1. The action stream is the projected
        ``actions`` (B, 16, A) in ``dynamic_model``, else the fake action
        latent, repeated over the tokens. ``text_latents``: the projected
        goal (B, D) (:meth:`policy_latents` projects it), or None for the
        learned null latent ``fake_latent``. ``drop``: the blocks' dropout
        (training mode only)."""
        c = self.cfg
        B, T, S, _ = cond_tokens.shape
        L = T * S
        dtype = self.z_proj_cond.weight.dtype
        if task_mode == "inverse_model":
            x = self.z_proj(x_tokens.to(dtype)).reshape(B, L, -1)
            cond = self.fake_latent_x[None].expand(B, L, -1).to(x.dtype)
        else:
            cond = self.z_proj_cond(cond_tokens.to(dtype)).reshape(B, L, -1)
            if task_mode == "policy_model":
                x = self.fake_latent_x[None].expand(B, L, -1)
            else:
                x = self.z_proj(x_tokens.to(dtype)).reshape(B, L, -1)
                masked = mask.reshape(B, L, 1) == 1.0
                x = torch.where(masked, self.fake_latent_x[None].to(x.dtype), x)
        if L % c.num_action_tokens:
            raise ValueError(f"{L} tokens do not split into {c.num_action_tokens} action slots")
        if task_mode == "dynamic_model":
            act = self.action_proj_cond(actions.to(dtype))
        else:
            act = self.fake_action_latent[None].expand(B, c.num_action_tokens, -1)
        act = act.repeat_interleave(L // act.shape[1], dim=1)
        h = self.proj_cond_x_layer(torch.cat([x, cond, act], dim=-1))
        h = h + self._factorized(self.temporal_pos_embed, self.spatial_pos_embed)
        if c.has_text:
            if text_latents is None:
                txt = self.fake_latent[None].expand(B, c.buffer_size_text, -1).to(h.dtype)
            else:
                txt = text_latents[:, None, :].expand(B, c.buffer_size_text, -1)
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

    def train_draw_shapes(self, batch: int) -> Dict[str, tuple]:
        """Shapes of a training forward's draws: the spatial mask (B, S) and
        each head's steps and standard-normal noise."""
        c = self.cfg
        n_video, n_act = batch * c.total_tokens, batch * c.num_action_tokens
        return {"mask": (batch, c.seq_len),
                "video_t": (n_video,), "video_noise": (n_video, c.token_embed_dim),
                "action_t": (n_act,), "action_noise": (n_act, c.action_dim)}

    def sample_train_draws(self, batch: int, generator: torch.Generator,
                           device: torch.device) -> Dict[str, torch.Tensor]:
        """The draws of one training forward from ``generator``: the mask rate
        and spatial mask (``mar.py:552-555``), and each head's steps in
        [0, training steps) and noise."""
        c = self.cfg
        shapes = self.train_draw_shapes(batch)
        rate = sample_mask_rate(c.mask_ratio_min, generator, device)
        mask = random_spatial_mask(rate, batch, c.seq_len, generator, device)
        # the video head's training diffusion has 1000 steps (heads.py:53)
        steps = {"video_t": 1000, "action_t": c.act_diff_training_steps}
        out = {"mask": mask}
        for head in ("video", "action"):
            out[f"{head}_t"] = torch.randint(0, steps[f"{head}_t"], shapes[f"{head}_t"],
                                             generator=generator, device=device)
            out[f"{head}_noise"] = torch.randn(shapes[f"{head}_noise"], generator=generator,
                                               device=device)
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
                drop: MarDropout = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training forward of one task mode (``mar.py:506-595``): (B, T, C,
        h, w) target and conditioning latents, the (B, 16, A) normalized
        action chunk and the draws of :meth:`sample_train_draws` -> (loss,
        video loss, action loss), fp32 scalars."""
        c = self.cfg
        if task_mode not in TASK_MODES:
            raise ValueError(f"task_mode must be one of {TASK_MODES}, got {task_mode!r}")
        B, T = x_frames.shape[:2]
        x_tokens, cond_tokens = self._tokens(x_frames), self._tokens(cond_frames)
        gt_latents = x_tokens.detach().reshape(B, c.total_tokens, c.token_embed_dim)
        mask = draws["mask"][:, None, :].expand(B, T, c.seq_len)
        h = self.forward_encoder(cond_tokens, None, task_mode, x_tokens, mask, actions, drop)
        z = self.forward_decoder(h, drop)
        zero = torch.zeros((), dtype=torch.float32, device=z.device)
        video_loss, act_loss = zero, zero
        if c.predict_video and task_mode in VIDEO_MODES:
            video_loss = self.diffloss.loss(gt_latents, z, mask.reshape(B, c.total_tokens),
                                            draws["video_t"], draws["video_noise"])
        if c.predict_action and task_mode in ACTION_MODES:
            act_loss = self.diffactloss.loss(actions, z, draws["action_t"], draws["action_noise"])
        return video_loss + act_loss, video_loss, act_loss

    def policy_latents(self, cond_frames: torch.Tensor,
                       text_latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, C, h, w) conditioning latents -> (B, T·S, D) decoder output
        that conditions the action head: one encoder+decoder pass.
        ``text_latents``: the raw (B, 512) goal latents, projected here by
        ``text_proj_cond`` (``mar.py:670-671``); ignored without language."""
        c = self.cfg
        cond_tokens = self._tokens(cond_frames)
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

    # -- video generation ---------------------------------------------------

    def _samples_action(self, task_mode: str) -> bool:
        return self.cfg.predict_action and task_mode in ACTION_MODES

    def video_draw_shapes(self, batch: int, num_iter: int = 1,
                          task_mode: str = "full_dynamic_model",
                          cfg: float = 1.0) -> Dict[str, object]:
        """Shapes of :meth:`sample_video`'s draws: ``order_rank`` (B, S), and a
        list of ``rounds``, each with the video head's ``video_init`` and
        ``video_steps`` (``VideoDiffusionHead.draw_shapes`` over the round's
        2B or B rows times T times the tokens it reveals) and, where the mode
        samples the action head, its ``action_init`` and ``action_steps``."""
        c = self.cfg
        B2 = 2 * batch if cfg != 1.0 else batch
        S, lens = c.seq_len, mask_schedule(c.seq_len, num_iter)
        rounds = []
        for step in range(num_iter):
            n_pred = (S if step == 0 else lens[step - 1]) - lens[step]
            shapes = {f"video_{k}": v for k, v in
                      self.diffloss.draw_shapes(B2 * c.n_frames * n_pred, cfg).items()}
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
                     text_latents: Optional[torch.Tensor] = None
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
        stream in ``dynamic_model``."""
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
        if text_latents is not None and c.has_text:
            text_latents = self.text_proj_cond(text_latents.to(self.text_proj_cond.weight.dtype))
        else:
            text_latents = None
        def dup(a):  # the conditional and unconditional halves of the rows
            return torch.cat([a, a], dim=0) if use_cfg and a is not None else a

        if use_cfg:
            uncond = self.fake_latent.expand(B, -1).to(text_latents.dtype)
            text_latents = torch.cat([text_latents, uncond], dim=0)
        cond_tokens, actions = dup(cond_tokens), dup(actions)
        want = self.video_draw_shapes(B, num_iter, task_mode, cfg)
        order_rank = draws["order_rank"]
        if tuple(order_rank.shape) != want["order_rank"] or len(draws["rounds"]) != num_iter:
            raise ValueError(f"draws must hold order_rank {want['order_rank']} and {num_iter} "
                             f"rounds, got {tuple(order_rank.shape)} and {len(draws['rounds'])}")
        # order_perm[b, r]: the position of rank r, so a round's revealed
        # positions are the slice order_perm[:, next_len:cur_len]
        order_perm = order_rank.argsort(dim=-1)
        tokens = torch.zeros((B, T, S, c.token_embed_dim), device=cond_frames.device)
        spatial_mask = torch.ones((B, S), device=cond_frames.device)
        act_out = None
        lens = mask_schedule(S, num_iter)
        for step, r in enumerate(draws["rounds"]):
            for k, s in want["rounds"][step].items():
                if tuple(r[k].shape) != s:
                    raise ValueError(f"round {step}: {k} must be {s}, got {tuple(r[k].shape)}")
            mask = spatial_mask[:, None, :].expand(B, T, S)
            h = self.forward_encoder(cond_tokens, text_latents, task_mode, dup(tokens), dup(mask),
                                     actions)
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
            sampled = self.diffloss.sample(
                z_g.reshape(-1, z.shape[-1]), r["video_init"], r["video_steps"],
                temperature=temperature, cfg=cfg_iter,
            ).reshape(pp.shape[0], T, n_pred, c.token_embed_dim)[:B]
            tokens = tokens.scatter(
                2, pred_pos[:, None, :, None].expand(-1, T, -1, c.token_embed_dim), sampled)
            spatial_mask = (order_rank < next_len).float()
        frames = unpatchify(tokens.reshape(B * T, S, c.token_embed_dim), c.patch_size,
                            c.vae_embed_dim, c.seq_hw)
        return frames, act_out
