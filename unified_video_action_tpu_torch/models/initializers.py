"""Flax's initializers on the port's modules: the distributions that JAX's
``UnifiedVideoActionPolicy.init_params`` (``policy/policy.py:220-255``)
draws the MAR's parameters from, per leaf.

* Dense and Conv kernels: the initializer the JAX module names, which the
  port's layer carries in ``kernel_init`` (``xavier_uniform``,
  ``normal_0.02`` or ``zeros``), else flax's default ``lecun_normal``: a
  normal truncated at two standard deviations, scaled so that its standard
  deviation is sqrt(1 / fan_in).
* Biases zero; LayerNorm and GroupNorm scales one and biases zero.
* Raw parameters (the fake latents and the position embeddings):
  ``normal(0.02)``, as ``models/mar.py`` names them.

Fans follow flax: a Dense kernel's fan in and out are its input and output
widths, a Conv kernel's are multiplied by its receptive field.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# flax's truncated_normal(-2, 2) has this standard deviation before scaling
_TRUNC_STD = 0.87962566103423978


def _fans(w: torch.Tensor):
    receptive = math.prod(w.shape[2:]) if w.dim() > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive


@torch.no_grad()
def init_kernel(w: torch.Tensor, kind: str, generator: torch.Generator) -> None:
    fan_in, fan_out = _fans(w)
    if kind == "lecun_normal":
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    elif kind == "xavier_uniform":
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        w.uniform_(-limit, limit, generator=generator)
    elif kind == "normal_0.02":
        w.normal_(0.0, 0.02, generator=generator)
    elif kind == "zeros":
        w.zero_()
    else:
        raise ValueError(f"unknown kernel initializer {kind!r}")


@torch.no_grad()
def init_module(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` from its flax initializer, in
    module order, from ``generator`` (on the parameters' device)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose3d)):
            # a transposed convolution's weight is (in, out, ...): its fans as flax's
            w = m.weight.transpose(0, 1) if isinstance(m, nn.ConvTranspose3d) else m.weight
            init_kernel(w, getattr(m, "kernel_init", "lecun_normal"), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            if m.weight is not None:
                m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
        else:
            for p in m.parameters(recurse=False):
                p.normal_(0.0, 0.02, generator=generator)
    return module
