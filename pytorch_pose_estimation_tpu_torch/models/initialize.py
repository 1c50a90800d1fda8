"""Seeded weight initialization.

``lecun_normal_``: the init that the JAX package's
``train/state.py::create_train_state`` gets from flax: conv and deconv
kernels are lecun_normal (a normal truncated at two standard deviations,
scaled to variance 1/fan_in), BN scale 1 and bias 0, running mean 0 and
variance 1.  torch's own default (kaiming-uniform) draws another
distribution.

``weight_initialize``: the reference's explicit scheme (counterpart of
pytorch_pose_estimation_tpu/models/initialize.py; reference:
models/initialize.py:4-16, commented out at its call site): Xavier-uniform
conv and deconv kernels, BN scale 1 and bias 0, N(0, 0.01) linear weights.
No path of the port calls it, and ``models`` does not export it.

The draws come from a ``torch.Generator``; they are not the numbers flax
or jax.random draw from the same seed.
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


def xavier_limit(weight: torch.Tensor) -> float:
    """The Xavier-uniform bound sqrt(6 / (fan_in + fan_out)) of a conv or
    deconv weight, with the fans the JAX package takes from the flax
    kernel: the receptive field times its input and its output axis.  A
    torch weight [O, I, kh, kw] (conv) or [I, O, kh, kw] (deconv) holds the
    same two axes at dims 0 and 1, so their sum is the same either way."""
    rf = weight.shape[2] * weight.shape[3]
    return math.sqrt(6.0 / (rf * weight.shape[0] + rf * weight.shape[1]))


@torch.no_grad()
def weight_initialize(model: nn.Module, generator: torch.Generator
                      ) -> nn.Module:
    """Re-draw ``model``'s parameters with the reference's scheme, in
    place: conv and deconv weights uniform in +-``xavier_limit``, BN weight
    1 and bias 0, linear weights N(0, 0.01), every other bias 0."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            limit = xavier_limit(m.weight)
            m.weight.uniform_(-limit, limit, generator=generator)
        elif isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 0.01, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return model
