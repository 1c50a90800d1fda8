"""SBP Gaussian heatmap targets.

Counterpart of pytorch_pose_estimation_tpu/ops/targets.py (SBP part).
``sbp_heatmaps`` is the plain PyTorch version of the math (reference:
utils/sbp_utils.py:33-53): for joint (x, y), skip if x<0 or y<0; the center
is clip(int(x), 0, W-1), likewise y; stamp
``exp(-((px-ulx-(3s+1))^2 + (py-uly-(3s+1))^2) / (2 s^2))`` on the window
``round(c-3s-1) <= p < round(c+3s+2)``.  ``torch.round`` rounds half to even,
as ``jnp.round`` does.  ``sbp_heatmaps_batch`` launches the CUDA kernel K1
(``ops/kernels.py``) for a CUDA tensor and runs the plain version for a CPU
tensor.  SPM targets come with the SPM slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .kernels import sbp_heatmaps_cuda


def _sbp_stamp(joints: torch.Tensor, h: int, w: int, sigma: float
               ) -> torch.Tensor:
    """joints [..., 2] -> [..., h, w], in the kernel's operation order."""
    x, y = joints[..., 0], joints[..., 1]
    valid = ((x >= 0) & (y >= 0))[..., None, None]
    cx = x.to(torch.int32).to(torch.float32).clamp(0, w - 1)[..., None, None]
    cy = y.to(torch.int32).to(torch.float32).clamp(0, h - 1)[..., None, None]
    ys = torch.arange(h, dtype=torch.float32, device=joints.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=joints.device)[None, :]
    ulx = torch.round(cx - 3 * sigma - 1)
    uly = torch.round(cy - 3 * sigma - 1)
    brx = torch.round(cx + 3 * sigma + 2)
    bry = torch.round(cy + 3 * sigma + 2)
    in_win = (xs >= ulx) & (xs < brx) & (ys >= uly) & (ys < bry)
    gx = xs - ulx - (3 * sigma + 1)
    gy = ys - uly - (3 * sigma + 1)
    g = torch.exp(-(gx * gx + gy * gy) / (2.0 * sigma * sigma))
    return torch.where(in_win & valid, g, torch.zeros((), device=g.device))


def sbp_heatmaps(joints: torch.Tensor, output_res: Tuple[int, int],
                 num_joints: int, sigma: float) -> torch.Tensor:
    """Plain version, on any device: joints [..., 2] (x, y) in output-map
    coords, negatives invisible -> heatmaps [..., H, W] fp32 (one sample
    is [K, 2] -> [K, H, W])."""
    h, w = int(output_res[0]), int(output_res[1])
    return _sbp_stamp(joints.to(torch.float32), h, w, float(sigma))


def sbp_heatmaps_batch(joints: torch.Tensor, output_res: Tuple[int, int],
                       num_joints: int, sigma: float) -> torch.Tensor:
    """joints [B, K, 2] -> heatmaps [B, K, H, W] fp32.  CUDA tensors go
    through kernel K1, CPU tensors through the plain version."""
    joints = joints.to(torch.float32)
    if joints.is_cuda:
        return sbp_heatmaps_cuda(joints.contiguous(), output_res, sigma)
    if joints.device.type != "cpu":
        raise ValueError(f"unsupported device {joints.device}")
    h, w = int(output_res[0]), int(output_res[1])
    return _sbp_stamp(joints, h, w, float(sigma))


class SBPHeatmapGenerator:
    """Reference constructor surface (utils/sbp_utils.py:20-31); sigma < 0
    means output_res[0] / 64."""

    def __init__(self, output_res: Sequence[int], num_joints: int,
                 sigma: float = -1):
        self.output_res = (int(output_res[0]), int(output_res[1]))
        self.num_joints = num_joints
        if sigma < 0:
            sigma = self.output_res[0] / 64
        self.sigma = float(sigma)

    def __call__(self, joints) -> torch.Tensor:
        return sbp_heatmaps(torch.as_tensor(joints, dtype=torch.float32),
                            self.output_res, self.num_joints, self.sigma)

    def batch(self, joints_batch) -> torch.Tensor:
        return sbp_heatmaps_batch(
            torch.as_tensor(joints_batch, dtype=torch.float32),
            self.output_res, self.num_joints, self.sigma)
