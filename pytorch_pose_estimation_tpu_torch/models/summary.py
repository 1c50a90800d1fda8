"""Parameter counts and the model summary (counterpart of
pytorch_pose_estimation_tpu/models/summary.py; replaces the reference's
torchinfo.summary call at train_sbp.py:48)."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn


def count_params(model: nn.Module) -> int:
    """Number of trainable parameters (BN running statistics excluded, as
    the JAX count over ``params`` excludes ``batch_stats``)."""
    return sum(p.numel() for p in model.parameters())


def summarize(model: nn.Module, input_shape: Tuple[int, ...]
              ) -> Dict[str, Any]:
    """The summary dict: the parameters of each top-level module, the
    total, the BN running statistics and the output shape for
    ``input_shape`` (NCHW; one eval-mode forward of zeros on the model's
    device)."""
    per_module = {name: count_params(child)
                  for name, child in model.named_children()}
    n_stats = sum(b.numel() for name, b in model.named_buffers()
                  if name.endswith(("running_mean", "running_var")))
    device = next(model.parameters()).device
    training = model.training
    with torch.inference_mode():
        out = model.eval()(torch.zeros(input_shape, device=device))
    model.train(training)
    return {"input_shape": tuple(input_shape),
            "output_shape": tuple(out.shape),
            "params_per_module": per_module,
            "total_params": count_params(model), "batch_stats": n_stats}


def print_summary(model: nn.Module, input_shape: Tuple[int, ...]
                  ) -> Dict[str, Any]:
    """Print ``summarize``'s dict as a table and return it."""
    info = summarize(model, input_shape)
    width = max((len(k) for k in info["params_per_module"]), default=10) + 2
    print("=" * (width + 20))
    print(f"{'Module':<{width}}{'Params':>14}")
    print("-" * (width + 20))
    for name, n in info["params_per_module"].items():
        print(f"{name:<{width}}{n:>14,}")
    print("-" * (width + 20))
    print(f"{'Total trainable':<{width}}{info['total_params']:>14,}")
    print(f"{'BN running stats':<{width}}{info['batch_stats']:>14,}")
    print(f"Input  shape: {info['input_shape']}")
    print(f"Output shape: {info['output_shape']}")
    print("=" * (width + 20))
    return info
