"""SBP training loss on NCHW tensors.

Counterpart of pytorch_pose_estimation_tpu/losses.py (SBP part; reference:
models/loss/sbp_loss.py:20-66): sigmoid on the logits, then a weighted
masked sum of squared errors.  The positive region is where target > 0,
weighted ``lambda_positive``; the rest is weighted ``lambda_negative``; each
term is divided by 2K and the total by the batch size.  Because the target
is zero off the positive mask, masking the prediction reproduces the
reference's ``mse(pred*mask, target)`` / ``mse(pred*n_mask, target*n_mask)``.
The SPM loss comes with the SPM slice.
"""

from __future__ import annotations

import torch


def _masked_sq_errors(logits: torch.Tensor, target: torch.Tensor):
    pred = torch.sigmoid(logits.to(torch.float32))
    target = target.to(torch.float32)
    pos = target > 0.0
    zero = torch.zeros((), dtype=torch.float32, device=pred.device)
    err_pos = torch.where(pos, pred - target, zero)
    err_neg = torch.where(pos, zero, pred)
    return err_pos * err_pos, err_neg * err_neg


def sbp_loss_per_sample(logits: torch.Tensor, target: torch.Tensor,
                        lambda_positive: float = 5.0,
                        lambda_negative: float = 1.0) -> torch.Tensor:
    """logits, target: [B, K, H, W] -> per-sample losses [B]; their mean is
    ``sbp_loss``.  Padded eval rows are masked out by the caller."""
    sq_pos, sq_neg = _masked_sq_errors(logits, target)
    k = logits.shape[1]
    per = (lambda_positive * sq_pos.sum(dim=(1, 2, 3))
           + lambda_negative * sq_neg.sum(dim=(1, 2, 3)))
    return per / (k * 2)


def sbp_loss(logits: torch.Tensor, target: torch.Tensor,
             lambda_positive: float = 5.0,
             lambda_negative: float = 1.0) -> torch.Tensor:
    """logits, target: [B, K, H, W] -> scalar loss."""
    sq_pos, sq_neg = _masked_sq_errors(logits, target)
    k = logits.shape[1]
    loss_pos = lambda_positive * sq_pos.sum() / (k * 2)
    loss_neg = lambda_negative * sq_neg.sum() / (k * 2)
    return (loss_pos + loss_neg) / logits.shape[0]
