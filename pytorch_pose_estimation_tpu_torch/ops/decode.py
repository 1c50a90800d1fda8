"""SBP heatmap -> joints decoding.

Counterpart of pytorch_pose_estimation_tpu/ops/decode.py (SBP part).  Per
(b, k) map: sigmoid (when ``pred``), max over H x W, the first row-major
index holding it, a strict ``conf > threshold`` test, then
x = (idx % W) * s and y = (idx // W) * s with s = input_w / W; a map whose
peak fails the test gives the sentinel (-s, -s, -1), scaled as the reference
scales it (utils/sbp_utils.py:103-118).  Logits are NCHW: [B, K, H, W].

``decode_sbp_batch`` is the plain PyTorch version; ``decode_sbp_fast``
launches the CUDA kernel K2 (``ops/kernels.py``) for a CUDA tensor and runs
the plain version for a CPU tensor.  SPM decoding comes with the SPM slice.
"""

from __future__ import annotations

from typing import Sequence, Union

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
