"""Image preprocessing on tensors.

Counterpart of pytorch_pose_estimation_tpu/ops/image.py::normalize_batch.
The augmentation ops (rotation, random resized crop, color jitter, CLAHE)
come with the training slice.
"""

from __future__ import annotations

import torch


def normalize_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """Val-time preprocessing, Normalize(0, 1) == /255 (reference:
    dataset/sbp_coco_dataset.py:234-237): uint8 [B, H, W, 3] ->
    contiguous fp32 [B, 3, H, W] on the same device."""
    x = images_u8.permute(0, 3, 1, 2).to(
        torch.float32, memory_format=torch.contiguous_format)
    return x / 255.0
