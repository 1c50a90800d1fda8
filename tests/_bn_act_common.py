"""What K3's CPU and card tests share (imports no JAX): the activation
shapes that reach a train-mode BN in the SBP and SPM models (the trunk's
18 ConvBnRelu blocks, then the 3 deconvolutions), from the Darknet19
table, and the bf16 comparison."""

from typing import List, Tuple

import torch

from pytorch_pose_estimation_tpu_torch.models.darknet import STAGES
from pytorch_pose_estimation_tpu_torch.models.sbp import DECONV_CHANNELS

Shape = Tuple[int, int, int]  # channels, height, width


def trunk_bn_shapes(height: int, width: int) -> List[Shape]:
    """(C, H, W) of each BN's input for a [B, 3, height, width] image."""
    out, h, w = [], height, width
    for table in STAGES:
        for entry in table:
            if entry == "M":
                h, w = h // 2, w // 2
            else:
                out.append((entry[0], h, w))
    for _ in range(3):
        h, w = 2 * h, 2 * w
        out.append((DECONV_CHANNELS, h, w))
    return out


# the benchmark's cells: batch and input size (posebench/configs)
CELLS = {"sbp": (256, (256, 192)), "spm": (32, (512, 512))}


def cell_shapes(cell: str) -> List[Tuple[int, int, int, int]]:
    """[N, C, H, W] of the 21 BN inputs of one train step of the cell."""
    n, (h, w) = CELLS[cell]
    return [(n, c, hh, ww) for c, hh, ww in trunk_bn_shapes(h, w)]


def _ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 bits of mantissa)."""
    a = v.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def bf16_excess(got: torch.Tensor, want: torch.Tensor,
                slack: torch.Tensor) -> tuple:
    """How far two bf16 tensors lie beyond one bf16 ulp of the larger value
    plus ``slack`` (0 when within), and the share of bit-equal elements."""
    got, want = got.float(), want.float()
    tol = _ulp_bf16(torch.maximum(got.abs(), want.abs())) + slack
    excess = float(((got - want).abs() - tol).max().clamp_min(0))
    return excess, float((got == want).float().mean())


def assert_bf16_close(got: torch.Tensor, want: torch.Tensor,
                      slack: torch.Tensor) -> float:
    """Bit-equal in bf16, or within one bf16 ulp of the larger value plus
    ``slack`` (``reference``'s).  Returns the share of bit-equal
    elements."""
    excess, equal = bf16_excess(got, want, slack)
    assert excess == 0, excess
    return equal


def reference(x, dy, weight, bias, eps, relu) -> dict:
    """Train-mode BN (+ ReLU) of bf16 x in float64: the batch mean and
    biased variance, the gradients dweight and dbias of sum(y * dy), and
    what two fp32 computations of the same function may differ by.

    v = x * scale + shift is fp32 in both, from statistics whose last bits
    depend on the order of the sums: v may differ by a few fp32 ulps of
    x * scale, mean * scale and bias (``slack_y`` allows 8).  Where |v| is
    within that of 0 the ReLU's mask may differ too, and since x is bf16,
    every element of a channel that holds the one value x at the threshold
    flips together: the gradient there differs by scale * dy
    (``slack_dx``), the channel's sums of g and g * xhat by the sums of
    |dy| and |dy * xhat| over those elements (``flip_db``, ``flip_dw``),
    and so its every dx by scale * (flip_db + |xhat| flip_dw) / n.  Beside
    that, dx allows 16 fp32 ulps of the terms of scale * (g - mean g -
    xhat mean(g xhat))."""
    eps32 = torch.finfo(torch.float32).eps
    dims = (0, 2, 3)

    def per_channel(v):
        return v.view(1, -1, 1, 1)

    xf = x.double()
    n = x.numel() // x.shape[1]
    mean = xf.mean(dims)
    var = xf.var(dims, unbiased=False)
    invstd = per_channel(1.0 / torch.sqrt(var + eps))
    scale = per_channel(weight.double()) * invstd
    shift = per_channel(bias.double()) - per_channel(mean) * scale
    slack_y = 8 * eps32 * ((xf * scale).abs() + (per_channel(mean)
                                                 * scale).abs()
                           + per_channel(bias.double()).abs())
    v = xf * scale + shift
    g = dy.double()
    if relu:
        flips = v.abs() <= slack_y
        g = g * (v > 0)
    else:
        flips = torch.zeros_like(v, dtype=torch.bool)
    del v
    xhat = (xf - per_channel(mean)) * invstd
    del xf
    gx = g * xhat
    flip_db = (dy.double().abs() * flips).sum(dims)
    flip_dw = (dy.double().abs() * xhat.abs() * flips).sum(dims)
    terms = scale.abs() * (
        g.abs() + g.abs().mean(dims, keepdim=True)
        + (xhat.abs() + per_channel(mean).abs() * invstd)
        * gx.abs().mean(dims, keepdim=True))
    slack_dx = 16 * eps32 * terms + scale.abs() * (
        dy.double().abs() * flips
        + (per_channel(flip_db) + xhat.abs() * per_channel(flip_dw)) / n)
    return {"mean": mean, "var": var, "slack_y": slack_y.float(),
            "slack_dx": slack_dx.float(), "db": g.sum(dims),
            "dw": gx.sum(dims), "flip_db": flip_db, "flip_dw": flip_dw,
            "flipped": int(flips.sum())}


def rel(got: torch.Tensor, want: torch.Tensor,
        allow: torch.Tensor = None) -> float:
    """The largest gap, less ``allow`` (per element, if given), over the
    largest value of ``want``."""
    gap = (got.double() - want.double()).abs()
    if allow is not None:
        gap = (gap - allow).clamp_min(0)
    return float(gap.max() / want.double().abs().max())
