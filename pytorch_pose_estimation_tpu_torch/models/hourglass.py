"""Stacked-hourglass building blocks, NCHW.

Counterpart of pytorch_pose_estimation_tpu/models/hourglass.py.  The
reference carries these as scaffolding for a future hourglass backbone
(reference: models/layers/blocks.py:8-86, never imported by the main path);
so do both packages: a pre-activation residual bottleneck and the classic
recursive hourglass (pool -> recurse -> upsample + skip).  The children's
names are the flax modules' names, so ``hourglass_state_dict`` maps a flax
tree of either block to a state_dict by its paths.  No training, inference
or CLI path builds them, and ``models`` does not export them: import this
module by its own name.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .convert import _kernel
from .layers import ConvBnRelu, max_pool_2x2


class Residual(nn.Module):
    """Bottleneck residual: 1x1 -> 3x3 -> 1x1 conv-BN-ReLU blocks at half,
    half and ``features`` channels, plus the input (through a 1x1 conv
    ``skip`` when its channels differ)."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        half = max(features // 2, 1)
        self.conv1 = ConvBnRelu(in_channels, half, 1, dtype=dtype)
        self.conv2 = ConvBnRelu(half, half, 3, dtype=dtype)
        self.conv3 = ConvBnRelu(half, features, 1, dtype=dtype)
        self.skip = nn.Conv2d(in_channels, features, 1, bias=False) \
            if in_channels != features else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        if self.skip is not None:
            x = F.conv2d(x.to(self.dtype), self.skip.weight.to(self.dtype))
        return x.to(self.dtype) + y


class Hourglass(nn.Module):
    """Recursive hourglass of ``depth``: the up branch's residual plus the
    low branch (2x2 max pool -> residual -> inner hourglass, or a residual
    at depth 1 -> residual -> 2x nearest upsample)."""

    def __init__(self, depth: int, in_channels: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.up = Residual(in_channels, features, dtype)
        self.pool = max_pool_2x2()
        self.low1 = Residual(in_channels, features, dtype)
        if depth > 1:
            self.inner = Hourglass(depth - 1, features, features, dtype)
        else:
            self.low2 = Residual(features, features, dtype)
        self.low3 = Residual(features, features, dtype)
        self.depth = depth

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self.up(x)
        low = self.low1(self.pool(x))
        low = self.inner(low) if self.depth > 1 else self.low2(low)
        low = self.low3(low)
        return up + F.interpolate(low, scale_factor=2, mode="nearest")


_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def hourglass_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} of the JAX ``Residual`` or ``Hourglass``
    (numpy leaves) -> the state_dict of the port's module: each flax path
    joined with dots, conv kernels [kh, kw, I, O] -> [O, I, kh, kw], BN
    scale/bias/mean/var -> weight/bias/running_mean/running_var."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + (name,))
            elif name == "kernel":
                out[".".join(path + ("weight",))] = _kernel(child)
            else:
                out[".".join(path + (_BN[name],))] = torch.from_numpy(
                    np.array(child, np.float32))
                if name == "scale":
                    out[".".join(path + ("num_batches_tracked",))] = \
                        torch.tensor(0, dtype=torch.long)

    walk(variables["params"], ())
    walk(variables.get("batch_stats", {}), ())
    return out
