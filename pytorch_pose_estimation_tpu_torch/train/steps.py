"""SBP and SPM train and eval steps.

Counterpart of pytorch_pose_estimation_tpu/train/steps.py.  Everything
after the uint8 batch lands on the device runs on the device.  The SBP
train step: augmentation, Gaussian targets (kernel K1, no gradient),
train-mode forward, loss, backward and the optimizer update, returning the
loss without a host sync.  The SBP eval step: normalization, targets (K1),
forward, per-sample loss and decode (kernel K2), so only K*3 floats per
sample come back.

SPM's steps run no kernel: photometric augmentation (or, opt-in, SBP's
geometric one), the SPM targets, forward, loss and the peak-NMS decode are
torch ops.

Under a process group of N ranks (``parallel``) a train step's batch is
the rank's b rows of a global batch of B = N*b.  The step draws the
augmentation for the global batch from generators seeded alike on every
rank and keeps its rows (``replica_draws``); BatchNorm takes the global
batch's statistics; after the backward one all-reduce averages the
gradients and the loss over the ranks (``parallel.average_gradients``),
so the optimizer sees the global batch's mean gradient and every rank
returns the global loss.  With one rank the step is unchanged.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..losses import (sbp_loss, sbp_loss_per_sample, spm_loss,
                      spm_loss_per_sample)
from ..ops.decode import decode_sbp_fast, decode_spm_batch
from ..ops.image import (augment_batch_core, normalize_batch, replica_draws,
                         sample_augment, sample_photometric,
                         spm_photometric_core)
from ..ops.targets import sbp_heatmaps_batch, spm_target
from ..optim import ChainOptimizer
from ..parallel import mesh
from ..tracing import span


def _backward_and_update(model: nn.Module, optimizer: ChainOptimizer,
                         loss: torch.Tensor, mark: Callable) -> torch.Tensor:
    """Backward, the ranks' gradient all-reduce (none with one rank) and
    the update; returns the (global) loss, detached."""
    with span("train.backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    mark("forward_backward")
    if mesh.world_size() > 1:
        with span("train.all_reduce"):
            loss, = mesh.average_gradients(model.parameters(), loss)
        mark("all_reduce")
    with span("train.optimizer"):
        optimizer.step()
    mark("optimizer")
    return loss.detach()


def _global_batch(batch: dict) -> int:
    """The global batch size B = world * this rank's rows."""
    return batch["image"].shape[0] * mesh.world_size()


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
    joints_vis [B,K] on the model's device (under N ranks, this rank's
    rows of the global batch).  The augmentation of the global batch is
    drawn from ``gen`` (on that device) and ``host_gen`` (see
    ``sample_augment``), or given as ``draws``.  ``marker(name)``, if
    given, is called after each part: "augment", "targets",
    "forward_backward", ("all_reduce" under N ranks), "optimizer".
    Under a ``tracing.recording()`` the step is the span ``train.step``
    over ``train.draw``, ``train.augment``, ``train.targets``,
    ``train.forward``, ``train.backward``, (``train.all_reduce``) and
    ``train.optimizer``; each marker call follows its span's end.

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
        with span("train.step"):
            model.train()
            with torch.no_grad():
                with span("train.draw"):
                    if draws is None:
                        draws = sample_augment(gen, _global_batch(batch),
                                               out_hw, host_gen=host_gen,
                                               **options)
                    draws = replica_draws(draws, mesh.rank(),
                                          mesh.world_size())
                with span("train.augment"):
                    images, joints, vis = augment_batch_core(
                        batch["image"], batch["joints"].to(torch.float32),
                        batch["joints_vis"].to(torch.float32), draws,
                        out_hw, dtype)
                mark("augment")
                with span("train.targets"):
                    target = _sbp_targets(joints, vis, ratio, output_size,
                                          num_keypoints, sigma)
                mark("targets")
            with span("train.forward"):
                loss = sbp_loss(model(images), target)
            return _backward_and_update(model, optimizer, loss, mark)

    eval_step = make_sbp_eval_step(model, input_size, output_size,
                                   num_keypoints, sigma,
                                   decode_conf_threshold)
    return train_step, eval_step


# --------------------------------------------------------------------------
# SPM
# --------------------------------------------------------------------------

def _spm_targets(joints: torch.Tensor, centers: torch.Tensor, ratio: float,
                 output_size: int, num_keypoints: int, sigma: float
                 ) -> torch.Tensor:
    """joints [B,P,K,2] and centers [B,P,1,2] in input px -> targets
    [B, 1+2K, S, S]; the points are floored at the output resolution, as
    the reference casts them to int64 (dataset/spm_coco_dataset.py:73)."""
    j = torch.floor(joints.to(torch.float32) * ratio)
    c = torch.floor(centers.to(torch.float32) * ratio)
    return spm_target(c, j, output_size, num_keypoints, sigma)


def make_spm_eval_step(model: nn.Module, input_size: int, output_size: int,
                       num_keypoints: int, sigma: float,
                       decode_conf_threshold: float, max_persons: int = 30
                       ) -> Callable:
    """Returns ``eval_step(batch) -> (per-sample losses [B], (roots
    [B, M, 3], keypoints [B, M, K, 3]) in input pixels)``.  ``batch``:
    image uint8 [B, S, S, 3], joints [B, P, K, 2], centers [B, P, 1, 2]
    on the model's device.  The model must be in eval mode."""
    ratio = int(output_size) / int(input_size)

    @torch.inference_mode()
    def eval_step(batch: dict):
        images = normalize_batch(batch["image"])
        target = _spm_targets(batch["joints"], batch["centers"], ratio,
                              output_size, num_keypoints, sigma)
        logits = model(images)
        losses = spm_loss_per_sample(logits, target)
        decoded = decode_spm_batch(logits, int(input_size), float(sigma),
                                   float(decode_conf_threshold), True,
                                   int(max_persons))
        return losses, decoded

    return eval_step


def make_spm_steps(model: nn.Module, optimizer: ChainOptimizer,
                   input_size: int, output_size: int, num_keypoints: int,
                   sigma: float, decode_conf_threshold: float,
                   augment: Optional[dict] = None, max_persons: int = 30):
    """Returns (train_step, eval_step) with the SBP steps' signatures,
    markers and spans; ``batch`` holds image uint8 [B,S,S,3], joints
    [B,P,K,2] and centers [B,P,1,2] (input px, (0, 0) for an absent
    point).

    By default the train step's augmentation is photometric, as the
    reference's SPM transform list (rotate and crop commented out,
    dataset/spm_coco_dataset.py:228-241): ``sample_photometric`` (from
    ``augment``: color_jitter (0.5, 0.2, 0.5, 0.1), jitter_prob 0.5,
    clahe_prob 0) and ``spm_photometric_core`` in the model's dtype.  The
    draws are ``PhotometricDraws``.

    ``augment={'geometric': True}``: SBP's rotate + crop + jitter
    (``sample_augment``, ``augment_batch_core``; draws ``AugmentDraws``)
    with rotate_limit 30, scale_range (0.6, 1), ratio_range (0.75, 1.33)
    unless given, rotate_prob and jitter_prob 0.5 and 16 angle groups
    whatever ``augment`` says, and fp32 images, as the JAX step calls
    ``augment_batch``.  Every person's joints and center ride one
    per-sample transform; points that leave the frame become (0, 0)."""
    ratio = int(output_size) / int(input_size)
    s = int(input_size)
    augment = augment or {}
    jitter = tuple(augment.get("color_jitter", (0.5, 0.2, 0.5, 0.1)))
    clahe_prob = float(augment.get("clahe_prob", 0.0))
    geometric = bool(augment.get("geometric", False))
    if geometric:
        options = dict(
            rotate_limit=augment.get("rotate_limit", 30.0),
            scale_range=tuple(augment.get("scale_range", (0.6, 1.0))),
            ratio_range=tuple(augment.get("ratio_range", (0.75, 1.33))),
            jitter_params=jitter, clahe_prob=clahe_prob)
    else:
        options = dict(jitter_params=jitter, clahe_prob=clahe_prob,
                       jitter_prob=float(augment.get("jitter_prob", 0.5)))
    dtype = getattr(model, "dtype", torch.float32)

    def augment_geometric(batch: dict, draws):
        b = batch["image"].shape[0]
        joints = batch["joints"].to(torch.float32)
        p, k = joints.shape[1], joints.shape[2]
        pts = torch.cat([joints.reshape(b, p * k, 2),
                         batch["centers"].to(torch.float32).reshape(b, p, 2)],
                        1)
        valid = (~((pts[..., 0] <= 0) & (pts[..., 1] <= 0))).to(torch.float32)
        images, pts, valid = augment_batch_core(batch["image"], pts, valid,
                                                draws, (s, s))
        pts = torch.where(valid[..., None] >= 1, pts,
                          torch.zeros((), device=pts.device))
        return (images, pts[:, :p * k].reshape(b, p, k, 2),
                pts[:, p * k:].reshape(b, p, 1, 2))

    def train_step(batch: dict, gen: Optional[torch.Generator] = None,
                   host_gen: Optional[torch.Generator] = None,
                   draws=None, marker: Optional[Callable] = None):
        mark = marker or (lambda name: None)
        with span("train.step"):
            model.train()
            with torch.no_grad():
                with span("train.draw"):
                    b = _global_batch(batch)
                    if draws is None and geometric:
                        draws = sample_augment(gen, b, (s, s),
                                               host_gen=host_gen, **options)
                    elif draws is None:
                        draws = sample_photometric(gen, b, host_gen=host_gen,
                                                   **options)
                    draws = replica_draws(draws, mesh.rank(),
                                          mesh.world_size())
                with span("train.augment"):
                    if geometric:
                        images, joints, centers = augment_geometric(batch,
                                                                    draws)
                    else:
                        images = spm_photometric_core(batch["image"], draws,
                                                      dtype)
                        joints, centers = batch["joints"], batch["centers"]
                mark("augment")
                with span("train.targets"):
                    target = _spm_targets(joints, centers, ratio,
                                          output_size, num_keypoints, sigma)
                mark("targets")
            with span("train.forward"):
                loss = spm_loss(model(images), target)
            return _backward_and_update(model, optimizer, loss, mark)

    eval_step = make_spm_eval_step(model, input_size, output_size,
                                   num_keypoints, sigma,
                                   decode_conf_threshold, max_persons)
    return train_step, eval_step
