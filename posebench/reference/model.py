"""The pose network in plain PyTorch, float32, over a dict of tensors.

Darknet19 features, three ConvTranspose(4, 2, 1) -> BN -> ReLU, a 1x1
head, with the reference's state_dict keys (``work.layers``); the
harness reaches it through ``networks/darknet19_pose.py``.  BatchNorm
normalizes by the batch's mean and biased variance in train mode and by the
running statistics in eval mode (eps 1e-5).  Seeded weights
(``make_weights``) are lecun-normal, as the port's ``build_model`` draws
them: a normal truncated at two standard deviations, variance 1/fan_in,
fan_in = dim 1 x kh x kw of the torch weight.

A random chain of conv -> BN -> ReLU with BN shifts of 0 is chaotic: a
relative perturbation grows by about a fifth a layer, so bf16 rounding
reaches 30% of the logits' size by the head at 256x192.  A shift of 1
keeps about 84% of the units active and the rounding near 2%; the
configurations state the shift under ``init``.

``Quantized`` is the comparison's control: every convolution's input and
weight rounded to float8 e4m3 with a per-tensor scale, and its output's
gradient to e5m2, the step below the bfloat16 that the configurations
state; the augmentation rounds its image to e4m3 where the program
rounds it to bf16 (``reference.augment``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from posebench import work

BN_EPS = 1e-5
_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2


def weight_shape(layer) -> tuple:
    kind, _, c_in, c_out, k, *_ = layer
    return (c_in, c_out, k, k) if kind == "deconv" else (c_out, c_in, k, k)


def weight_key(layer) -> str:
    kind, prefix = layer[0], layer[1]
    return {"conv": prefix + ".conv.weight", "deconv": prefix + ".0.weight",
            "head": prefix + ".weight"}[kind]


def bn_prefix(layer) -> Optional[str]:
    kind, prefix = layer[0], layer[1]
    return {"conv": prefix + ".bn", "deconv": prefix + ".1"}.get(kind)


@torch.no_grad()
def make_weights(kind: str, num_keypoints: int, seed: int,
                 device="cuda", bn_shift: float = 0.0
                 ) -> Dict[str, torch.Tensor]:
    """Seeded fp32 weights and BN state under the reference's keys, drawn
    on ``device`` in one call; every BN's shift (bias) is ``bn_shift``."""
    ls = work.layers(kind, (32, 32), num_keypoints)
    shapes = [weight_shape(l) for l in ls]
    total = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device).manual_seed(int(seed))
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for layer, shape in zip(ls, shapes):
        n = math.prod(shape)
        fan_in = shape[1] * shape[2] * shape[3]
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        out[weight_key(layer)] = (flat[at:at + n] * std).view(shape)
        at += n
        bn = bn_prefix(layer)
        if bn:
            c = layer[3]
            out[bn + ".weight"] = torch.ones(c, device=device)
            out[bn + ".bias"] = torch.full((c,), float(bn_shift),
                                           device=device)
            out[bn + ".running_mean"] = torch.zeros(c, device=device)
            out[bn + ".running_var"] = torch.ones(c, device=device)
            out[bn + ".num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64, device=device)
    return out


def parameter_groups(kind: str, num_keypoints: int) -> Dict[str, str]:
    """The trainable tensors' keys, in the model's parameter order, each
    with its group: ``conv``, ``deconv`` or ``head`` (the weights) or
    ``bn`` (BN scales and shifts)."""
    groups = {}
    for layer in work.layers(kind, (32, 32), num_keypoints):
        groups[weight_key(layer)] = layer[0]
        bn = bn_prefix(layer)
        if bn:
            groups[bn + ".weight"] = groups[bn + ".bias"] = "bn"
    return groups


def parameter_keys(kind: str, num_keypoints: int):
    """The trainable tensors' keys, in the model's parameter order."""
    return list(parameter_groups(kind, num_keypoints))


def _scaled_cast(x: torch.Tensor, dtype: torch.dtype, top: float
                 ) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to ``top``, back in x's dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8Operand(torch.autograd.Function):
    """Forward: e4m3 rounding; backward: the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _scaled_cast(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Forward: identity; backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _scaled_cast(g, torch.float8_e5m2, 57344.0)


class Quantized:
    """The control's convolutions: operands in e4m3, gradients in e5m2."""

    @staticmethod
    def operand(x: torch.Tensor) -> torch.Tensor:
        return _Fp8Operand.apply(x)

    @staticmethod
    def output(x: torch.Tensor) -> torch.Tensor:
        return _Fp8Grad.apply(x)


def _batch_norm(x, p, prefix, train, stats=None):
    if train:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        if stats is not None:
            stats[prefix + ".running_mean"] = mean.detach()
            stats[prefix + ".running_var"] = var.detach()
    else:
        mean, var = p[prefix + ".running_mean"], p[prefix + ".running_var"]
    inv = torch.rsqrt(var + BN_EPS) * p[prefix + ".weight"]
    return (x - mean[None, :, None, None]) * inv[None, :, None, None] \
        + p[prefix + ".bias"][None, :, None, None]


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, kind: str,
            num_keypoints: int, train: bool, quant=None,
            stats: Optional[dict] = None) -> torch.Tensor:
    """x [B, 3, H, W] in [0, 1] -> logits [B, C, H/4, W/4].  ``quant``
    (``Quantized``) rounds the convolutions; ``stats`` collects the batch
    statistics of each BN in train mode."""
    h = x
    for layer in work.layers(kind, x.shape[-2:], num_keypoints):
        lkind, _, _, _, k, h_in, *_ = layer
        if lkind == "conv" and h.shape[-2] != h_in:
            h = F.max_pool2d(h, 2, 2)
        w = p[weight_key(layer)]
        if quant is not None:
            h, w = quant.operand(h), quant.operand(w)
        if lkind == "deconv":
            h = F.conv_transpose2d(h, w, stride=2, padding=1)
        else:
            h = F.conv2d(h, w, padding=(k - 1) // 2)
        if quant is not None:
            h = quant.output(h)
        if lkind != "head":
            h = F.relu(_batch_norm(h, p, bn_prefix(layer), train, stats))
    return h
