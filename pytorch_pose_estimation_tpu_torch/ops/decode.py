"""Heatmap -> joints decoding, SBP and SPM.

Counterpart of pytorch_pose_estimation_tpu/ops/decode.py.  SBP: per
(b, k) map: sigmoid (when ``pred``), max over H x W, the first row-major
index holding it, a strict ``conf > threshold`` test, then
x = (idx % W) * s and y = (idx // W) * s with s = input_w / W; a map whose
peak fails the test gives the sentinel (-s, -s, -1), scaled as the reference
scales it (utils/sbp_utils.py:103-118).  Logits are NCHW: [B, K, H, W].

``decode_sbp_batch`` is the plain PyTorch version; ``decode_sbp_fast``
launches the CUDA kernel K2 (``ops/kernels.py``) for a CUDA tensor and runs
the plain version for a CPU tensor.

SPM (reference: utils/spm_utils.py:98-250), torch ops on any device,
batched over B with no host sync: a greedy peak NMS of ``max_persons``
rounds on the root heatmap (each round the first-occurrence argmax of the
active pixels, inactive ones at -inf; found if strictly above the
threshold, and then every pixel within ``dist_threshold = (6s+2)/2``
(``<=``) is deactivated; empty slots are (-1, -1, -1)), then each root
reads the displacement fields at its pixel, keypoints closer to their root
than ``dist_threshold`` are zeroed, and roots and keypoints are scaled by
input / map size.  The argmax is taken after the sigmoid: saturated pixels
tie at 1.0 and the first one wins.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from .kernels import decode_sbp_cuda


def _decode_maps(maps: torch.Tensor, scale: float,
                 conf_threshold: float) -> torch.Tensor:
    """maps [..., H, W] (after sigmoid) -> joints [..., 3]."""
    w = maps.shape[-1]
    flat = maps.flatten(-2)
    idx = torch.argmax(flat, dim=-1)  # first occurrence of the max
    conf = torch.gather(flat, -1, idx[..., None])[..., 0]
    x = (idx % w).to(torch.float32) * scale
    y = torch.div(idx, w, rounding_mode="floor").to(torch.float32) * scale
    found = conf > conf_threshold
    # scalar fills, no host-to-device copy of a sentinel row
    return torch.stack([torch.where(found, x, -scale),
                        torch.where(found, y, -scale),
                        torch.where(found, conf, -1.0)], dim=-1)


def decode_sbp_batch(logits: torch.Tensor, input_w: int,
                     conf_threshold: float, pred: bool = True
                     ) -> torch.Tensor:
    """Plain version: logits [B, K, H, W] -> joints [B, K, 3] in input-size
    coordinates."""
    x = logits.to(torch.float32)
    if pred:
        x = torch.sigmoid(x)
    return _decode_maps(x, int(input_w) / x.shape[-1], float(conf_threshold))


def decode_sbp(heatmaps: torch.Tensor,
               input_size: Union[int, Sequence[int]],
               conf_threshold: float, pred: bool = True) -> torch.Tensor:
    """One sample: heatmaps [K, H, W] -> joints [K, 3].  Coordinates scale by
    input width / map width, as the reference does for both axes."""
    in_w = input_size[-1] if hasattr(input_size, "__len__") else input_size
    return decode_sbp_batch(heatmaps[None], int(in_w), conf_threshold,
                            pred)[0]


def decode_sbp_fast(logits: torch.Tensor, input_w: int,
                    conf_threshold: float, pred: bool = True
                    ) -> torch.Tensor:
    """Batched decode: kernel K2 on a CUDA tensor, the plain version on a
    CPU tensor."""
    if logits.is_cuda:
        return decode_sbp_cuda(logits.to(torch.float32).contiguous(),
                               input_w, conf_threshold, pred)
    if logits.device.type != "cpu":
        raise ValueError(f"unsupported device {logits.device}")
    return decode_sbp_batch(logits, input_w, conf_threshold, pred)


class DecodeSBP:
    """Reference-compatible decoder object (utils/sbp_utils.py:85-118).

    Accepts [B, K, H, W] or [K, H, W]; any B works (the reference asserted
    B == 1).  Returns [K, 3] for B == 1, else [B, K, 3].
    """

    def __init__(self, input_size, conf_threshold: float, pred: bool = True):
        self.input_size = input_size[-1] if hasattr(input_size, "__len__") \
            else input_size
        self.conf_threshold = float(conf_threshold)
        self.pred = pred

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.dim() == 3:
            x = x[None]
        joints = decode_sbp_fast(x, int(self.input_size),
                                 self.conf_threshold, self.pred)
        return joints[0] if joints.shape[0] == 1 else joints


# --------------------------------------------------------------------------
# SPM
# --------------------------------------------------------------------------

def _spm_peak_nms(heatmap: torch.Tensor, conf_threshold: float,
                  dist_threshold: float, max_persons: int) -> torch.Tensor:
    """heatmap [B, H, W] (after sigmoid) -> roots [B, M, 3] (x, y, conf)
    in map pixels, best first; empty slots (-1, -1, -1)."""
    b, h, w = heatmap.shape
    dev = heatmap.device
    flat = heatmap.reshape(b, h * w).to(torch.float32)
    ys = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    active = flat > conf_threshold
    neg_inf = torch.full((), -math.inf, device=dev)
    rows = []
    for _ in range(int(max_persons)):
        vals = torch.where(active, flat, neg_inf)
        idx = torch.argmax(vals, dim=1, keepdim=True)  # first occurrence
        conf = torch.gather(vals, 1, idx)
        px = (idx % w).to(torch.float32)
        py = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
        found = conf > conf_threshold                  # [B, 1]
        rows.append(torch.where(found, torch.cat([px, py, conf], 1), -1.0))
        d = torch.sqrt((xs - px) ** 2 + (ys - py) ** 2)
        active = active & ~(found & (d <= dist_threshold))
    return torch.stack(rows, dim=1)


def _spm_keypoints(roots: torch.Tensor, displacements: torch.Tensor,
                   dist_threshold: float) -> torch.Tensor:
    """roots [B, M, 3], displacements [B, 2K, S, S] -> keypoints
    [B, M, K, 3] (x, y, root conf) in map pixels.  The field is read at
    (clip(int(y)), clip(int(x))) of each root (an empty slot reads pixel
    (0, 0) and is zeroed); a keypoint closer than ``dist_threshold`` to its
    root (strict <) and every keypoint of an empty slot are all-zero rows.
    z = sqrt(2) * S in fp32."""
    b, two_k, s, _ = displacements.shape
    k = two_k // 2
    z = float(np.float32(np.sqrt(np.float32(2.0))) * np.float32(s))
    x, y, conf = roots.unbind(-1)                      # [B, M]
    xi = x.to(torch.int64).clamp(0, s - 1)
    yi = y.to(torch.int64).clamp(0, s - 1)
    at = (yi * s + xi)[:, None, :].expand(b, two_k, -1)
    field = torch.gather(displacements.reshape(b, two_k, s * s), 2, at)
    field = field.view(b, k, 2, -1)                    # [B, K, 2, M]
    kx = field[:, :, 0].transpose(1, 2) * z + x[..., None]   # [B, M, K]
    ky = field[:, :, 1].transpose(1, 2) * z + y[..., None]
    d = torch.sqrt((x[..., None] - kx) ** 2 + (y[..., None] - ky) ** 2)
    keep = (d >= dist_threshold) & (conf >= 0)[..., None]
    joints = torch.stack([kx, ky, conf[..., None].expand_as(kx)], -1)
    return torch.where(keep[..., None], joints, 0.0)


def decode_spm_batch(logits: torch.Tensor, input_size: int, sigma: float,
                     conf_threshold: float, pred: bool = True,
                     max_persons: int = 30
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, 1+2K, S, S] -> (roots [B, M, 3], keypoints [B, M, K, 3])
    in input pixels; ``pred`` applies sigmoid (root) and tanh (fields).
    Empty root slots are (-1, -1, -1)."""
    x = logits.to(torch.float32)
    dist_threshold = (6 * sigma + 2) / 2
    if pred:
        heatmap, disp = torch.sigmoid(x[:, 0]), torch.tanh(x[:, 1:])
    else:
        heatmap, disp = x[:, 0], x[:, 1:]
    roots = _spm_peak_nms(heatmap, float(conf_threshold),
                          float(dist_threshold), max_persons)
    joints = _spm_keypoints(roots, disp, float(dist_threshold))
    scale = int(input_size) / heatmap.shape[-1]
    valid = roots[..., 2:] >= 0
    roots = torch.cat([roots[..., :2] * scale, roots[..., 2:]], -1)
    roots = torch.where(valid, roots, -1.0)
    joints = torch.cat([joints[..., :2] * scale, joints[..., 2:]], -1)
    return roots, joints


def decode_spm(x: torch.Tensor, input_size: int, sigma: float,
               conf_threshold: float, pred: bool = True,
               max_persons: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sample [1+2K, S, S] -> (roots [M, 3], keypoints [M, K, 3])."""
    roots, joints = decode_spm_batch(x[None], input_size, sigma,
                                     conf_threshold, pred, max_persons)
    return roots[0], joints[0]


class DecodeSPM:
    """Reference-compatible SPM decoder (utils/spm_utils.py:203-250): one
    sample ([1+2K, S, S], or the first of a batch) -> numpy (roots [n, 3],
    keypoints [n, K, 3]) with the empty slots stripped on the host."""

    def __init__(self, input_size: int, sigma: float, conf_threshold: float,
                 pred: bool = True, max_persons: int = 30):
        self.input_size = int(input_size)
        self.sigma = sigma
        self.conf_threshold = float(conf_threshold)
        self.pred = pred
        self.max_persons = max_persons

    def __call__(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.dim() == 4:
            x = x[0]
        roots, joints = decode_spm(x, self.input_size, self.sigma,
                                   self.conf_threshold, self.pred,
                                   self.max_persons)
        roots = roots.cpu().numpy()
        joints = joints.cpu().numpy()
        keep = roots[:, 2] >= 0
        return roots[keep], joints[keep]
