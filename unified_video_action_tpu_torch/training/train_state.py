"""The train state and one optimization step (the port's own copy of
``training/train_state.py``): the task mode's loss, the gradients, AdamW
with its schedule, then the EMA.

``TrainState`` holds the training policy (its fp32 MAR in train mode and its
frozen VAE), an fp32 EMA copy of the MAR's parameters, the optimizer and its
scheduler, and the step. Every parameter is updated at every step, with a
zero gradient where the task mode does not reach it (optax updates every
leaf; ``torch.optim`` would skip a parameter without a gradient). With
``grad_accum`` k > 1 the gradients of k steps are averaged and the update
lands on every k-th (optax's ``MultiSteps``); the EMA moves at every step,
as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.models.mar import MarDropout
from unified_video_action_tpu_torch.training.ema import EmaConfig, ema_update
from unified_video_action_tpu_torch.training.optim import (
    clip_by_global_norm,
    global_norm,
    make_optimizer,
)


@dataclasses.dataclass
class TrainState:
    policy: Any  # UnifiedVideoActionPolicy built with train=True
    ema: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    ema_cfg: EmaConfig
    grad_accum: int = 1
    max_grad_norm: Optional[float] = None
    step: int = 0

    @property
    def mar(self) -> torch.nn.Module:
        return self.policy.mar

    def ema_tree(self) -> Dict[str, Dict]:
        """The EMA weights as the MAR's flax tree (numpy), which a serving
        policy's ``load_params`` reads."""
        return convert.to_flax_tree(self.mar, self.ema)


def create_train_state(policy, ema_cfg: EmaConfig = EmaConfig(), grad_accum: int = 1,
                       max_grad_norm: Optional[float] = None, **optimizer_kwargs) -> TrainState:
    """The state of a training policy whose parameters are set
    (``init_params`` or ``load_params``); ``optimizer_kwargs`` go to
    ``optim.make_optimizer``."""
    if not policy.training:
        raise ValueError("create_train_state needs a policy built with train=True")
    opt, sched = make_optimizer(policy.mar, **optimizer_kwargs)
    ema = {n: p.detach().float().clone() for n, p in policy.mar.named_parameters()}
    return TrainState(policy, ema, opt, sched, ema_cfg, int(grad_accum), max_grad_norm)


def train_step(state: TrainState, batch: Mapping[str, Any], task_mode: str,
               frame_indices: Optional[np.ndarray] = None,
               noise: Optional[Mapping[str, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None, pregathered: bool = False,
               drop: MarDropout = None) -> Dict[str, torch.Tensor]:
    """One step on ``batch`` in ``task_mode`` (``compute_loss``'s arguments).
    Returns ``train_loss``, ``diffusion_loss``, ``action_loss`` and
    ``grad_norm`` (the global norm of this batch's gradients, before any
    clipping) as device scalars, without waiting for them."""
    mar = state.mar
    params: List[torch.Tensor] = list(mar.parameters())
    loss, video_loss, act_loss = state.policy.compute_loss(
        batch, task_mode, frame_indices, pregathered=pregathered, noise=noise,
        generator=generator, drop=drop)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    grad_norm = global_norm(grads)
    k = state.grad_accum
    for p, g in zip(params, grads):
        if p.grad is None:
            p.grad = g if k == 1 else g / k
        else:
            p.grad.add_(g, alpha=1.0 / k)
    state.step += 1
    if state.step % k == 0:
        if state.max_grad_norm:
            clip_by_global_norm([p.grad for p in params], state.max_grad_norm)
        state.optimizer.step()
        state.scheduler.step()
        for p in params:
            p.grad = None
    ema_update([state.ema[n] for n, _ in mar.named_parameters()], params, state.step,
               state.ema_cfg)
    return {"train_loss": loss.detach(), "diffusion_loss": video_loss.detach(),
            "action_loss": act_loss.detach(), "grad_norm": grad_norm}
