"""Ground-truth targets: SBP Gaussian heatmaps and SPM root heatmap,
masks and displacement fields.

Counterpart of pytorch_pose_estimation_tpu/ops/targets.py.
``sbp_heatmaps`` is the plain PyTorch version of the math (reference:
utils/sbp_utils.py:33-53): for joint (x, y), skip if x<0 or y<0; the center
is clip(int(x), 0, W-1), likewise y; stamp
``exp(-((px-ulx-(3s+1))^2 + (py-uly-(3s+1))^2) / (2 s^2))`` on the window
``round(c-3s-1) <= p < round(c+3s+2)``.  ``torch.round`` rounds half to even,
as ``jnp.round`` does.  ``sbp_heatmaps_batch`` launches the CUDA kernel K1
(``ops/kernels.py``) for a CUDA tensor and runs the plain version for a CPU
tensor.

SPM (reference: utils/spm_utils.py:16-95) runs as torch ops on any device,
batched over leading dimensions: the root heatmap stamps the same window
but skips a point only when ``x<=0 and y<=0`` (so (0, 5) is a valid joint)
and takes no int/clip of the center, max-blended over persons; each
person's mask is the union of ``[c-size, c+size+1)`` boxes with
``size = int((6s+2)/2)``; the displacement fields are
``sum over persons of (m * (joint - grid)) / z``, ``z = sqrt(2 S^2)``,
interleaved (dx0, dy0, dx1, ...).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from .kernels import sbp_heatmaps_cuda


def _grid(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device)


def _gaussian_stamp(cx: torch.Tensor, cy: torch.Tensor, valid: torch.Tensor,
                    h: int, w: int, sigma: float) -> torch.Tensor:
    """Windowed Gaussians around centers cx, cy ([...], fp32) where
    ``valid``: [..., h, w], in the kernel's operation order."""
    cx, cy = cx[..., None, None], cy[..., None, None]
    ys = _grid(h, cx.device)[:, None]
    xs = _grid(w, cx.device)[None, :]
    ulx = torch.round(cx - 3 * sigma - 1)
    uly = torch.round(cy - 3 * sigma - 1)
    brx = torch.round(cx + 3 * sigma + 2)
    bry = torch.round(cy + 3 * sigma + 2)
    in_win = (xs >= ulx) & (xs < brx) & (ys >= uly) & (ys < bry)
    gx = xs - ulx - (3 * sigma + 1)
    gy = ys - uly - (3 * sigma + 1)
    g = torch.exp(-(gx * gx + gy * gy) / (2.0 * sigma * sigma))
    return torch.where(in_win & valid[..., None, None], g,
                       torch.zeros((), device=g.device))


def _sbp_stamp(joints: torch.Tensor, h: int, w: int, sigma: float
               ) -> torch.Tensor:
    """joints [..., 2] -> [..., h, w]: SBP's skip rule and centers."""
    x, y = joints[..., 0], joints[..., 1]
    cx = x.to(torch.int32).to(torch.float32).clamp(0, w - 1)
    cy = y.to(torch.int32).to(torch.float32).clamp(0, h - 1)
    return _gaussian_stamp(cx, cy, (x >= 0) & (y >= 0), h, w, sigma)


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


# --------------------------------------------------------------------------
# SPM
# --------------------------------------------------------------------------

def _present(joints: torch.Tensor) -> torch.Tensor:
    """SPM's skip rule: a point is absent only when x<=0 and y<=0."""
    return ~((joints[..., 0] <= 0) & (joints[..., 1] <= 0))


def spm_heatmaps(joints: torch.Tensor, output_res: int, num_joints: int,
                 sigma: float) -> torch.Tensor:
    """joints [..., P, J, 2] -> [..., J, S, S] fp32, the max over persons of
    each point's Gaussian (center not rounded or clipped)."""
    s = int(output_res)
    joints = joints.to(torch.float32)
    stamps = _gaussian_stamp(joints[..., 0], joints[..., 1],
                             _present(joints), s, s, float(sigma))
    return stamps.amax(dim=-4)


def spm_masks(joints: torch.Tensor, output_res: int, sigma: float
              ) -> torch.Tensor:
    """joints [..., P, J, 2] (integer coordinates) -> per-person box masks
    [..., P, S, S] fp32 in {0, 1}: the union over J of the boxes
    ``[c - size, c + size + 1)``, ``size = int((6 sigma + 2) / 2)``."""
    s = int(output_res)
    size = int((6 * sigma + 2) / 2)
    joints = joints.to(torch.float32)
    x = joints[..., 0, None, None]
    y = joints[..., 1, None, None]
    xs = _grid(s, joints.device)[None, :]
    ys = _grid(s, joints.device)[:, None]
    in_box = ((xs >= x - size) & (xs < x + size + 1)
              & (ys >= y - size) & (ys < y + size + 1))
    per_joint = in_box & _present(joints)[..., None, None]
    return per_joint.any(dim=-3).to(torch.float32)


def spm_displacements(joints: torch.Tensor, masks: torch.Tensor,
                      output_res: int, num_joints: int) -> torch.Tensor:
    """joints [..., P, K, 2], masks [..., P, S, S] in {0, 1} ->
    [..., 2K, S, S] fp32: ``sum_p (m * (coord - grid)) / z`` with m the
    person's mask where the joint is present, interleaved (dx0, dy0, ...).

    m is 0 or 1, so ``m * d`` is ``d`` or 0 exactly and the fields are
    ``where(m, d / z, 0)`` summed over persons: ``d / z`` is taken on the
    [..., P, K, S] coordinate differences, and one [..., P, K, S, S]
    temporary is live at a time."""
    s = int(output_res)
    z = math.sqrt(s ** 2 + s ** 2)
    joints = joints.to(torch.float32)
    grid = _grid(s, joints.device)
    on = masks[..., :, None, :, :] != 0                  # [..., P, 1, S, S]
    present = _present(joints)[..., None]                # [..., P, K, 1]
    zero = torch.zeros((), device=joints.device)
    dx = torch.where(present, (joints[..., 0, None] - grid) / z, zero)
    dy = torch.where(present, (joints[..., 1, None] - grid) / z, zero)
    fx = torch.where(on, dx[..., None, :], zero).sum(dim=-4)   # [..., K, S, S]
    fy = torch.where(on, dy[..., :, None], zero).sum(dim=-4)
    out = torch.stack([fx, fy], dim=-3)                  # [..., K, 2, S, S]
    return out.flatten(-4, -3)


def spm_target(centers: torch.Tensor, joints: torch.Tensor, output_res: int,
               num_joints: int, sigma: float) -> torch.Tensor:
    """Full SPM target: centers [..., P, 1, 2] (roots), joints
    [..., P, K, 2], output-map px -> [..., 1 + 2K, S, S] fp32, the root
    heatmap then the displacement fields (dataset/spm_coco_dataset.py:
    77-86)."""
    hm = spm_heatmaps(centers, output_res, 1, sigma)
    masks = spm_masks(centers, output_res, sigma)
    disp = spm_displacements(joints, masks, output_res, num_joints)
    return torch.cat([hm, disp], dim=-3)


class SPMTargetGenerator:
    """Reference constructor surface (utils/spm_utils.py:16-95); sigma < 0
    means output_res / 64.  ``batch`` takes a leading batch dimension."""

    def __init__(self, output_res: int, num_joints: int, sigma: float = -1):
        self.output_res = int(output_res)
        self.num_joints = num_joints
        if sigma < 0:
            sigma = self.output_res / 64
        self.sigma = float(sigma)

    def __call__(self, centers, joints) -> torch.Tensor:
        return spm_target(torch.as_tensor(centers, dtype=torch.float32),
                          torch.as_tensor(joints, dtype=torch.float32),
                          self.output_res, self.num_joints, self.sigma)

    batch = __call__
