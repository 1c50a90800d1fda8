"""Layer primitives: conv -> BN -> activation blocks, NCHW.

Counterpart of pytorch_pose_estimation_tpu/models/layers.py (reference:
models/layers/conv_block.py:4-53).  Parameters are fp32; ``dtype`` is the
compute type of the convolutions.  With ``dtype=torch.bfloat16`` a block
casts its input and weight to bf16 for the convolution, runs BatchNorm in
fp32 and casts its output back to bf16, as the JAX blocks do.  BN uses
eps=1e-5 and torch momentum 0.1 (flax momentum 0.9), and updates its
running variance with the biased batch variance, as flax does
(``BatchNorm2d``).

In train mode on one CUDA device with bf16 compute, a block's BN and ReLU
are one function instead (``BnAct``): the hand-written kernel K3
(``csrc/bn_act.cu``) reads the bf16 convolution output and writes the bf16
block output, with the statistics, normalisation and ReLU in fp32, and
saves only the bf16 input and four floats a channel for the backward.
Every other case (eval mode, fp32 models, CPU tensors, several ranks)
runs the unfused chain above.  ``tracing`` counts ``bn.fused`` for each K3
forward and ``bn.unfused`` for each train-mode call of the unfused BN:
calls, not layers, so under ``remat`` the forwards that the backward runs
again count again.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops import kernels
from ..parallel import mesh

_DIMS = (0, 2, 3)  # every axis but the channels'


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class _CrossReplicaBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of every rank's equal
    share: the forward gathers each rank's per-channel mean and sum of
    squared deviations and combines them (Chan's rule, exact in exact
    arithmetic and stable); the backward all-reduces the sums of dy and of
    dy * (x - mean), so dx is the gradient of the ranks' summed loss, as
    the global batch's BN gives it.  The weight and bias gradients are
    this rank's share (the train step averages the gradients).  Returns
    (y, mean, biased variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        n = x.numel() // x.shape[1]
        mean = x.mean(_DIMS)
        m2 = (x - _channel(mean)).square().sum(_DIMS)
        stats = mesh.gather_rows(torch.stack([mean, m2])[None])
        world = stats.shape[0]
        g_mean = stats[:, 0].mean(0)
        var = (stats[:, 1] + n * (stats[:, 0] - g_mean).square()).sum(0) \
            / (n * world)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, g_mean, invstd)
        ctx.count = n * world
        ctx.mark_non_differentiable(g_mean, var)
        y = (x - _channel(g_mean)) * _channel(invstd * weight) \
            + _channel(bias)
        return y, g_mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd = ctx.saved_tensors
        xmu = x - _channel(mean)
        sum_dy = dy.sum(_DIMS)
        sum_dy_xmu = (dy * xmu).sum(_DIMS)
        total = mesh.all_reduce_sum(torch.stack([sum_dy, sum_dy_xmu]))
        mean_dy = total[0] / ctx.count
        mean_dy_xmu = total[1] / ctx.count
        dx = (dy - _channel(mean_dy)
              - xmu * _channel(invstd.square() * mean_dy_xmu)) \
            * _channel(invstd * weight)
        return dx, sum_dy_xmu * invstd, sum_dy, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm (eps 1e-5) whose train-mode update of the running
    statistics is flax's: ``running = 0.9 running + 0.1 batch_stat``, with
    the biased batch variance.  torch's own rule adds the unbiased one,
    larger by n/(n-1) for n values per channel, which matters for the deep,
    small maps (n = 8 at batch 2 in layer5 of a 64x64 input).

    The normalization is torch's, with the batch statistics.  torch's kernel
    still does the update: it is handed the running variance divided by
    s = (n-1)/n, adds 0.1 of the unbiased variance (= biased / s), and the
    sum times s is flax's update.  Eval mode is torch's.  The state_dict
    keys are those of ``nn.BatchNorm2d``.

    Under a process group of several ranks (``parallel``), train mode is
    cross-replica: the statistics, the running statistics' update (with
    the global count n) and the backward are those of the global batch,
    as GSPMD gives the JAX package on a mesh."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        tracing.count("bn.unfused")
        if mesh.world_size() > 1:
            return self._cross_replica(x)
        n = x.numel() // x.shape[1]
        if n < 2:
            raise ValueError("BatchNorm2d needs more than one value per "
                             f"channel in train mode, got input {x.shape}")
        s = (n - 1) / n
        running_var = self.running_var / s
        out = F.batch_norm(x, self.running_mean, running_var, self.weight,
                           self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.copy_(running_var * s)
            self.num_batches_tracked.add_(1)
        return out

    def _cross_replica(self, x: torch.Tensor) -> torch.Tensor:
        out, mean, var = _CrossReplicaBatchNorm.apply(x, self.weight,
                                                      self.bias, self.eps)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return out


def bn_act_forward_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, running_mean: torch.Tensor,
                         running_var: torch.Tensor,
                         num_batches_tracked: torch.Tensor, momentum: float,
                         eps: float, relu: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's forward in plain PyTorch: train-mode BatchNorm (+ ReLU) of x
    [N, C, H, W] bf16 -> (y bf16, stats [4, C] fp32: mean, invstd,
    scale = weight * invstd, shift = bias - mean * scale).  The batch
    variance is two-pass and biased; the running statistics follow flax's
    rule in place.  fp32 inside; y = max(x * scale + shift, 0)."""
    n = x.numel() // x.shape[1]
    if n < 2:
        raise ValueError("BatchNorm needs more than one value per channel "
                         f"in train mode, got input {tuple(x.shape)}")
    with torch.no_grad():
        xf = x.float()
        mean = xf.mean(_DIMS)
        var = (xf - _channel(mean)).square().mean(_DIMS)
        invstd = 1.0 / torch.sqrt(var + eps)
        scale = weight * invstd
        shift = bias - mean * scale
        v = xf * _channel(scale) + _channel(shift)
        y = F.relu(v) if relu else v
        running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1 - momentum).add_(var, alpha=momentum)
        num_batches_tracked.add_(1)
    return y.to(x.dtype), torch.stack([mean, invstd, scale, shift])


def bn_act_backward_plain(dy: torch.Tensor, x: torch.Tensor,
                          stats: torch.Tensor, relu: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's backward in plain PyTorch: (dx in x's dtype, dweight, dbias
    fp32).  g = dy where x * scale + shift > 0 (the forward's ReLU mask;
    everywhere without the ReLU); dx = scale * (g - mean(g) - xhat *
    mean(g * xhat)), xhat = (x - mean) * invstd."""
    with torch.no_grad():
        mean, invstd, scale, shift = (_channel(s) for s in stats)
        xf, g = x.float(), dy.float()
        if relu:
            g = torch.where(xf * scale + shift > 0, g, torch.zeros_like(g))
        xhat = (xf - mean) * invstd
        dbias = g.sum(_DIMS)
        dweight = (g * xhat).sum(_DIMS)
        n = x.numel() // x.shape[1]
        dx = scale * (g - _channel(dbias / n) - xhat * _channel(dweight / n))
    return dx.to(x.dtype), dweight, dbias


class BnAct(torch.autograd.Function):
    """Train-mode ``BatchNorm2d`` (+ ReLU) of a bf16 activation as one
    function: ``BnAct.apply(x, bn.weight, bn.bias, bn, relu)`` (``bn_act``)
    -> y in x's dtype, with the
    statistics, normalisation, ReLU and parameter gradients in fp32 and
    ``bn``'s running statistics updated as its own train mode does.
    Saves x and four floats a channel.  K3 on a CUDA tensor, the plain
    version on the CPU."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn, relu):
        fwd = kernels.bn_act_forward_cuda if x.is_cuda \
            else bn_act_forward_plain
        y, stats = fwd(x, weight, bias, bn.running_mean, bn.running_var,
                       bn.num_batches_tracked, bn.momentum, bn.eps, relu)
        ctx.save_for_backward(x, stats)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, stats = ctx.saved_tensors
        bwd = kernels.bn_act_backward_cuda if x.is_cuda \
            else bn_act_backward_plain
        dx, dweight, dbias = bwd(dy.contiguous(), x, stats, ctx.relu)
        return dx, dweight, dbias, None, None


def bn_act(x: torch.Tensor, bn: "BatchNorm2d", relu: bool) -> torch.Tensor:
    """``BnAct`` of x through ``bn``."""
    return BnAct.apply(x, bn.weight, bn.bias, bn, relu)


def _block_out(x: torch.Tensor, bn: "BatchNorm2d",
               activation: Optional[Callable], dtype: torch.dtype
               ) -> torch.Tensor:
    """A block's BN and activation of its convolution's output x (in
    ``dtype``), returned in ``dtype``: K3 in train mode on one CUDA device
    in bf16 with ReLU or no activation, else the unfused chain."""
    if bn.training and x.is_cuda and dtype == torch.bfloat16 \
            and activation in (F.relu, None) and mesh.world_size() == 1:
        tracing.count("bn.fused")
        return bn_act(x.contiguous(), bn, activation is F.relu)
    x = bn(x.float())
    if activation is not None:
        x = activation(x)
    return x.to(dtype)


class ConvBnAct(nn.Module):
    """conv (no bias, "same" padding for odd k) -> BatchNorm -> activation.
    Children ``conv`` and ``bn`` give the reference's state_dict keys."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 activation: Optional[Callable] = F.relu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              (kernel_size - 1) // 2, bias=False)
        self.bn = BatchNorm2d(out_channels)
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.padded(x, self.conv.padding)

    def padded(self, x: torch.Tensor, padding) -> torch.Tensor:
        """The layer with the convolution's (rows, cols) ``padding``:
        parallel/spatial.py gives (0, cols) on rows that already carry
        their halo, cast to ``dtype``."""
        c = self.conv
        x = F.conv2d(x.to(self.dtype), c.weight.to(self.dtype), None,
                     c.stride, padding)
        return _block_out(x, self.bn, self.activation, self.dtype)


def ConvBnRelu(in_channels: int, out_channels: int, kernel_size: int = 3,
               stride: int = 1, dtype: torch.dtype = torch.float32
               ) -> ConvBnAct:
    """conv -> BN -> ReLU (reference: models/layers/conv_block.py:4)."""
    return ConvBnAct(in_channels, out_channels, kernel_size, stride, F.relu,
                     dtype)


def ConvBn(in_channels: int, out_channels: int, kernel_size: int = 3,
           stride: int = 1, dtype: torch.dtype = torch.float32) -> ConvBnAct:
    """conv -> BN, no activation (reference:
    models/layers/conv_block.py:41)."""
    return ConvBnAct(in_channels, out_channels, kernel_size, stride, None,
                     dtype)


class DeconvBnRelu(nn.Sequential):
    """ConvTranspose2d(k=4, s=2, p=1, no bias) -> BN -> ReLU: an exact 2x
    upsample (reference: models/detector/sbp.py:17-33).  This is flax's
    ConvTranspose with ``transpose_kernel=True`` and padding ((2, 2), (2, 2))
    in the JAX package.  Children ``0`` and ``1`` give the reference's keys
    ``deconv_N.0.weight`` and ``deconv_N.1.*``."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            nn.ConvTranspose2d(in_channels, out_channels, 4, 2, 1,
                               bias=False),
            BatchNorm2d(out_channels))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cropped(x)

    def cropped(self, x: torch.Tensor,
                rows: Optional[slice] = None) -> torch.Tensor:
        """The layer, with the transposed convolution's output cut to
        ``rows`` (of dim 2) before the BN: parallel/spatial.py keeps a
        block's own rows of the output of its haloed rows."""
        deconv, bn = self[0], self[1]
        x = F.conv_transpose2d(x.to(self.dtype), deconv.weight.to(self.dtype),
                               None, deconv.stride, deconv.padding)
        if rows is not None:
            x = x[:, :, rows]
        return _block_out(x, bn, F.relu, self.dtype)


def max_pool_2x2() -> nn.MaxPool2d:
    """2x2/stride-2 max pool ('M' entries in the backbone table)."""
    return nn.MaxPool2d(2, 2)
