"""SBP detector: Simple Baselines for Human Pose Estimation.

Counterpart of pytorch_pose_estimation_tpu/models/sbp.py (reference:
models/detector/sbp.py:10-49): darknet19 features (1024 ch, stride 32) ->
3x [ConvTranspose k4 s2 p1 -> BN -> ReLU] (stride 32 -> 4) -> 1x1 conv (no
bias) to ``num_keypoints`` logit maps.  The sigmoid lives in the loss and
the decode.  Module names give the reference's state_dict keys
(``backbone_features_module.*``, ``deconv_N.{0,1}.*``, ``sbp_head.0.weight``),
the keys ``models/torch_import.py`` of the JAX package reads.

``remat=True`` recomputes the backbone in the backward pass instead of
keeping its activations (``torch.utils.checkpoint``, the JAX package's
``nn.remat``), in train mode.  The recomputation would update the BN running
statistics a second time; flax's remat drops what that pass computes, so the
port restores the backbone's BN buffers after it.

Shapes at a 256x192 input: [B, 3, 256, 192] -> [B, 1024, 8, 6] -> 16x12 ->
32x24 -> [B, 512, 64, 48] -> logits [B, K, 64, 48], always fp32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .darknet import OUT_CHANNELS, Darknet19
from .layers import DeconvBnRelu

DECONV_CHANNELS = 512


@contextlib.contextmanager
def _restoring_buffers(module: nn.Module):
    """Put ``module``'s buffers back as they were on entry."""
    saved = [b.clone() for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)


class PoseNet(nn.Module):
    """Darknet19 features -> 3 deconvs -> a 1x1 head (no bias) of
    ``out_channels`` logit maps, named ``head_name`` (the reference's
    state_dict key); SBP and SPM differ only in the head."""

    head_name = ""

    def __init__(self, out_channels: int, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.backbone_features_module = Darknet19(dtype=dtype)
        self.deconv_1 = DeconvBnRelu(OUT_CHANNELS, DECONV_CHANNELS, dtype)
        self.deconv_2 = DeconvBnRelu(DECONV_CHANNELS, DECONV_CHANNELS, dtype)
        self.deconv_3 = DeconvBnRelu(DECONV_CHANNELS, DECONV_CHANNELS, dtype)
        setattr(self, self.head_name, nn.Sequential(
            nn.Conv2d(DECONV_CHANNELS, out_channels, 1, bias=False)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] -> logits [B, out_channels, H/4, W/4] fp32."""
        backbone = self.backbone_features_module
        if self.remat and self.training and torch.is_grad_enabled():
            x = checkpoint(backbone, x, use_reentrant=False,
                           context_fn=lambda: (contextlib.nullcontext(),
                                               _restoring_buffers(backbone)))
        else:
            x = backbone(x)
        return self.logits(self.deconv_3(self.deconv_2(self.deconv_1(x))))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The 1x1 head on the last deconv's output: fp32 logits."""
        head = getattr(self, self.head_name)[0]
        x = F.conv2d(x.to(self.dtype), head.weight.to(self.dtype))
        # logits stay fp32 so loss and decode match the reference numerics
        return x.float()


class SBP(PoseNet):
    head_name = "sbp_head"

    def __init__(self, num_keypoints: int = 17,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__(num_keypoints, dtype, remat)
