"""SBP train and eval steps.

Counterpart of pytorch_pose_estimation_tpu/train/steps.py (``_sbp_targets``
and ``make_sbp_steps``).  Everything after the uint8 batch lands on the
device runs on the device.  The train step: augmentation, Gaussian targets
(kernel K1, no gradient), train-mode forward, loss, backward and the
optimizer update, returning the loss without a host sync.  The eval step:
normalization, targets (K1), forward, per-sample loss and decode (kernel
K2), so only K*3 floats per sample come back.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..losses import sbp_loss, sbp_loss_per_sample
from ..ops.decode import decode_sbp_fast
from ..ops.image import augment_batch_core, normalize_batch, sample_augment
from ..ops.targets import sbp_heatmaps_batch
from ..optim import ChainOptimizer


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


def make_sbp_steps(model: nn.Module, optimizer: ChainOptimizer,
                   input_size: Sequence[int], output_size: Tuple[int, int],
                   num_keypoints: int, sigma: float,
                   decode_conf_threshold: float,
                   augment: Optional[dict] = None):
    """Returns (train_step, eval_step).

    ``train_step(batch, gen=None, host_gen=None, draws=None, marker=None)
    -> loss`` (a 0-dim device tensor) updates ``model`` and ``optimizer``
    in place.  ``batch`` holds image uint8 [B,H,W,3], joints [B,K,2] and
    joints_vis [B,K] on the model's device.  The augmentation is drawn from
    ``gen`` (on that device) and ``host_gen`` (see ``sample_augment``), or
    given as ``draws``.  ``marker(name)``, if given, is called after each
    part: "augment", "targets", "forward_backward", "optimizer".

    ``augment`` overrides the JAX package's defaults: rotate_limit 40,
    scale_range (0.4, 1), ratio_range (0.4, 1.6), color_jitter
    (0.5, 0.2, 0.5, 0.1), clahe_prob 0, rotate_prob 0.5, jitter_prob 0.5,
    angle_groups 16; the images come out in the model's dtype."""
    ratio = output_size[0] / input_size[0]
    augment = augment or {}
    options = dict(
        rotate_limit=augment.get("rotate_limit", 40.0),
        scale_range=tuple(augment.get("scale_range", (0.4, 1.0))),
        ratio_range=tuple(augment.get("ratio_range", (0.4, 1.6))),
        jitter_params=tuple(augment.get("color_jitter",
                                        (0.5, 0.2, 0.5, 0.1))),
        clahe_prob=float(augment.get("clahe_prob", 0.0)),
        rotate_prob=float(augment.get("rotate_prob", 0.5)),
        jitter_prob=float(augment.get("jitter_prob", 0.5)),
        angle_groups=int(augment.get("angle_groups", 16)))
    out_hw = (int(input_size[0]), int(input_size[1]))
    dtype = getattr(model, "dtype", torch.float32)

    def train_step(batch: dict, gen: Optional[torch.Generator] = None,
                   host_gen: Optional[torch.Generator] = None,
                   draws=None, marker: Optional[Callable] = None):
        mark = marker or (lambda name: None)
        model.train()
        with torch.no_grad():
            if draws is None:
                draws = sample_augment(gen, batch["image"].shape[0], out_hw,
                                       host_gen=host_gen, **options)
            images, joints, vis = augment_batch_core(
                batch["image"], batch["joints"].to(torch.float32),
                batch["joints_vis"].to(torch.float32), draws, out_hw, dtype)
            mark("augment")
            target = _sbp_targets(joints, vis, ratio, output_size,
                                  num_keypoints, sigma)
            mark("targets")
        loss = sbp_loss(model(images), target)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mark("forward_backward")
        optimizer.step()
        mark("optimizer")
        return loss.detach()

    eval_step = make_sbp_eval_step(model, input_size, output_size,
                                   num_keypoints, sigma,
                                   decode_conf_threshold)
    return train_step, eval_step
