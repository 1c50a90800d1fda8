"""SBP eval step.

Counterpart of pytorch_pose_estimation_tpu/train/steps.py (``_sbp_targets``
and the eval step of ``make_sbp_steps``).  Everything after the uint8 batch
lands on the device runs on the device: normalization, Gaussian targets
(kernel K1), forward, per-sample loss and decode (kernel K2), so only K*3
floats per sample come back.  The train step comes with the training slice.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch import nn

from ..losses import sbp_loss_per_sample
from ..ops.decode import decode_sbp_fast
from ..ops.image import normalize_batch
from ..ops.targets import sbp_heatmaps_batch


def _sbp_targets(joints: torch.Tensor, vis: torch.Tensor, ratio: float,
                 output_size: Sequence[int], num_keypoints: int,
                 sigma: float) -> torch.Tensor:
    """joints [B,K,2] input px + vis [B,K] -> heatmaps [B,K,h,w].  Scale to
    the output resolution and mark invisible joints -1 (the generator's
    skip sentinel), the reference dataset's encode chain
    (dataset/sbp_coco_dataset.py:71-77)."""
    scaled = joints.to(torch.float32) * ratio
    scaled = torch.where(vis[..., None] >= 1, scaled,
                         torch.full((), -1.0, device=scaled.device))
    return sbp_heatmaps_batch(scaled, tuple(output_size), num_keypoints,
                              sigma)


def make_sbp_eval_step(model: nn.Module, input_size: Sequence[int],
                       output_size: Tuple[int, int], num_keypoints: int,
                       sigma: float, decode_conf_threshold: float
                       ) -> Callable:
    """Returns ``eval_step(batch) -> (per-sample losses [B], joints
    [B, K, 3] in input coordinates)``.  ``batch``: image uint8
    [B, H, W, 3], joints [B, K, 2], joints_vis [B, K], tensors on the
    model's device.  The model must be in eval mode."""
    ratio = output_size[0] / input_size[0]
    input_w = int(input_size[1])
    threshold = float(decode_conf_threshold)

    @torch.inference_mode()
    def eval_step(batch: dict):
        images = normalize_batch(batch["image"])
        target = _sbp_targets(batch["joints"], batch["joints_vis"], ratio,
                              output_size, num_keypoints, sigma)
        logits = model(images)
        losses = sbp_loss_per_sample(logits, target)
        joints = decode_sbp_fast(logits, input_w, threshold, True)
        return losses, joints

    return eval_step
