"""Training losses on NCHW tensors.

Counterpart of pytorch_pose_estimation_tpu/losses.py.  SBP (reference:
models/loss/sbp_loss.py:20-66): sigmoid on the logits, then a weighted
masked sum of squared errors.  The positive region is where target > 0,
weighted ``lambda_positive``; the rest is weighted ``lambda_negative``; each
term is divided by 2K and the total by the batch size.  Because the target
is zero off the positive mask, masking the prediction reproduces the
reference's ``mse(pred*mask, target)`` / ``mse(pred*n_mask, target*n_mask)``.

SPM (reference: models/loss/spm_loss.py:23-105): channel 0 sigmoid and a
sum of squared errors (``lambda_root``), channels 1..2K tanh and a sum of
SmoothL1 (beta 1, quadratic where strictly |x| < 1; ``lambda_disp``), both
with only the prediction multiplied by the root mask ``target[:, 0] > 0``:
off the mask a displacement target may be non-zero where another person's
box overlaps, and it counts.  The total is divided by the batch size.
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


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _spm_errors(logits: torch.Tensor, target: torch.Tensor):
    """[B, 1+2K, H, W] -> (root squared errors [B, 1, H, W], displacement
    SmoothL1 terms [B, 2K, H, W])."""
    logits = logits.to(torch.float32)
    target = target.to(torch.float32)
    true_root = target[:, :1]
    mask = (true_root > 0.0).to(torch.float32)
    root = torch.sigmoid(logits[:, :1]) * mask - true_root
    disp = torch.tanh(logits[:, 1:]) * mask - target[:, 1:]
    return root * root, _smooth_l1(disp)


def spm_loss_per_sample(logits: torch.Tensor, target: torch.Tensor,
                        lambda_root: float = 1.0,
                        lambda_disp: float = 0.1) -> torch.Tensor:
    """logits, target: [B, 1+2K, H, W] -> per-sample losses [B]; their
    mean is ``spm_loss``."""
    root, disp = _spm_errors(logits, target)
    return (lambda_root * root.sum(dim=(1, 2, 3))
            + lambda_disp * disp.sum(dim=(1, 2, 3)))


def spm_loss(logits: torch.Tensor, target: torch.Tensor,
             lambda_root: float = 1.0, lambda_disp: float = 0.1
             ) -> torch.Tensor:
    """logits, target: [B, 1+2K, H, W] -> scalar loss."""
    root, disp = _spm_errors(logits, target)
    return (lambda_root * root.sum() + lambda_disp * disp.sum()) \
        / logits.shape[0]
