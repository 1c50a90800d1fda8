"""Parameter counts (counterpart of pytorch_pose_estimation_tpu/models/
summary.py::count_params; replaces the reference's torchinfo.summary call
at train_sbp.py:48)."""

from __future__ import annotations

from torch import nn


def count_params(model: nn.Module) -> int:
    """Number of trainable parameters (BN running statistics excluded, as
    the JAX count over ``params`` excludes ``batch_stats``)."""
    return sum(p.numel() for p in model.parameters())
