"""Layer primitives: conv -> BN -> activation blocks, NCHW.

Counterpart of pytorch_pose_estimation_tpu/models/layers.py (reference:
models/layers/conv_block.py:4-53).  Parameters are fp32; ``dtype`` is the
compute type of the convolutions.  With ``dtype=torch.bfloat16`` a block
casts its input and weight to bf16 for the convolution, runs BatchNorm in
fp32 and casts its output back to bf16, as the JAX blocks do.  BN uses
eps=1e-5 and torch momentum 0.1 (flax momentum 0.9).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


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
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.conv2d(x.to(self.dtype), c.weight.to(self.dtype), None,
                     c.stride, c.padding)
        x = self.bn(x.float())
        if self.activation is not None:
            x = self.activation(x)
        return x.to(self.dtype)


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
            nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        deconv, bn = self[0], self[1]
        x = F.conv_transpose2d(x.to(self.dtype), deconv.weight.to(self.dtype),
                               None, deconv.stride, deconv.padding)
        return F.relu(bn(x.float())).to(self.dtype)


def max_pool_2x2() -> nn.MaxPool2d:
    """2x2/stride-2 max pool ('M' entries in the backbone table)."""
    return nn.MaxPool2d(2, 2)
