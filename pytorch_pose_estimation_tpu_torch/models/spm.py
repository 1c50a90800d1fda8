"""SPM detector: Single-Stage Multi-Person Pose Machines.

Counterpart of pytorch_pose_estimation_tpu/models/spm.py (reference:
models/detector/spm.py:11-50): SBP's trunk (``PoseNet``) with a 1x1 head of
``1 + 2 * num_keypoints`` logit maps: channel 0 is the root-joint heatmap,
channels 1..2K the x/y displacement fields per keypoint, interleaved
(dx0, dy0, dx1, ...).  The sigmoid and tanh live in the loss and the
decode.  The head's key is ``spm_head.0.weight``, which the JAX package's
``models/torch_import.py`` reads.

Shapes at a 512x512 input: [B, 3, 512, 512] -> [B, 1024, 16, 16] -> ... ->
[B, 512, 128, 128] -> logits [B, 1 + 2K, 128, 128], always fp32.
"""

from __future__ import annotations

import torch

from .sbp import PoseNet


class SPM(PoseNet):
    head_name = "spm_head"

    def __init__(self, num_keypoints: int = 17,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__(1 + 2 * num_keypoints, dtype, remat)
