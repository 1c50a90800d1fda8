"""Seeded weight initialization with the JAX package's defaults.

Counterpart of the init that ``train/state.py::create_train_state`` gets
from flax: conv and deconv kernels are lecun_normal (a normal truncated at
two standard deviations, scaled to variance 1/fan_in), BN scale 1 and bias
0, running mean 0 and variance 1.  torch's own default (kaiming-uniform)
draws another distribution.  The draws come from a ``torch.Generator``; they
are not the numbers flax draws from the same seed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2]; flax divides it out
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            # torch layouts [O, I, kh, kw] and [I, O, kh, kw] both put
            # flax's fan_in (kh * kw * the kernel's input axis) at dim 1
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model
