"""Exponential moving average of the MAR's parameters (the port's own copy
of ``training/ema.py``): decay = 1 - (1 + s / inv_gamma)^(-power) at
optimization step s counted from ``update_after_step``, 0 at s <= 0,
clamped to [min_value, max_value]; ``ema = ema · d + params · (1 - d)``.
The decay is computed in float32, as JAX computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EmaConfig:
    update_after_step: int = 0
    inv_gamma: float = 1.0
    power: float = 0.75
    min_value: float = 0.0
    max_value: float = 0.9999


def ema_decay(step: int, cfg: EmaConfig) -> float:
    """The decay at optimization step ``step`` (1 after the first update)."""
    s = np.float32(max(0, step - cfg.update_after_step - 1))
    if s <= 0:
        value = np.float32(0.0)
    else:
        value = np.float32(1.0) - (np.float32(1.0) + s / np.float32(cfg.inv_gamma)) \
            ** np.float32(-cfg.power)
    return float(np.clip(value, np.float32(cfg.min_value), np.float32(cfg.max_value)))


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor], step: int,
               cfg: EmaConfig) -> None:
    """``ema`` (fp32 tensors) <- ema · d + params · (1 - d), in place."""
    d = ema_decay(step, cfg)
    ema = list(ema)
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, [p.to(e.dtype) for e, p in zip(ema, params)],
                        alpha=float(np.float32(1.0) - np.float32(d)))
