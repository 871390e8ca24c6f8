"""AdamW and its learning-rate schedule (the port's own copy of
``training/optim.py``): optax's ``adamw`` with the decay mask, as
``torch.optim.AdamW`` over two parameter groups and a ``LambdaLR``.

* ``decay_mask``: weight decay where the flax leaf has two dimensions or
  more (kernels, the position embeddings (1, T, D), the fake latents
  (1, D)); none on biases and norm parameters (the reference's
  ``add_weight_decay``).
* The schedules count updates from 0, as optax's do: the linear warmup gives
  lr 0 at the first update, and ``join_schedules`` restarts the cosine (or
  the constant) at the warmup's end.
* ``clip_by_global_norm``: optax's global-norm clipping, for a trainer that
  sets ``max_grad_norm``; gradient accumulation (optax's ``MultiSteps``)
  is in ``train_state.py``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from unified_video_action_tpu_torch import convert

Schedule = Callable[[int], float]


def decay_mask(module: nn.Module) -> Dict[str, bool]:
    """{parameter name: decays}: True where the parameter's flax leaf has
    ndim >= 2."""
    shapes = convert.flax_layout_shapes(module)
    paths = convert.flax_paths(module)
    return {name: len(shapes[paths[name][0]]) >= 2 for name, _ in module.named_parameters()}


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    def schedule(count: int) -> float:
        return init_value * 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = nxt(count - boundary)
        return out
    return schedule


def cosine_warmup_schedule(learning_rate: float, warmup_steps: int, total_steps: int) -> Schedule:
    warmup = linear_schedule(0.0, learning_rate, max(warmup_steps, 1))
    cosine = cosine_decay_schedule(learning_rate, max(total_steps - warmup_steps, 1))
    return join_schedules([warmup, cosine], [warmup_steps])


def constant_warmup_schedule(learning_rate: float, warmup_steps: int) -> Schedule:
    warmup = linear_schedule(0.0, learning_rate, max(warmup_steps, 1))
    return join_schedules([warmup, lambda count: learning_rate], [warmup_steps])


def make_optimizer(
    module: nn.Module,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.02,
    betas: Tuple[float, float] = (0.9, 0.95),
    warmup_steps: int = 1000,
    total_steps: int = 1_000_000,
    schedule: str = "cosine",
) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over ``module``'s parameters (eps 1e-8, as optax), decayed by
    :func:`decay_mask`, and the scheduler that sets its lr to the schedule's
    value at the count of updates made (call ``step()`` after each update)."""
    if schedule == "cosine":
        lr = cosine_warmup_schedule(learning_rate, warmup_steps, total_steps)
    elif schedule == "constant":
        lr = constant_warmup_schedule(learning_rate, warmup_steps)
    else:
        raise ValueError(f"schedule must be 'cosine' or 'constant', got {schedule!r}")
    mask = decay_mask(module)
    groups = [
        {"params": [p for n, p in module.named_parameters() if mask[n]],
         "weight_decay": weight_decay},
        {"params": [p for n, p in module.named_parameters() if not mask[n]],
         "weight_decay": 0.0},
    ]
    opt = torch.optim.AdamW(groups, lr=learning_rate, betas=tuple(betas), eps=1e-8)
    scale = (lambda count: lr(count) / learning_rate) if learning_rate else (lambda count: 0.0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, scale)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of ``tensors``."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> None:
    """optax's ``clip_by_global_norm``, in place: g / norm · max_norm where
    the global norm reaches ``max_norm``."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(grads), scale)
