#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pytorch_pose_estimation_tpu_torch) on one
NVIDIA GPU (written for an H100) and check it, end to end.

    python3 chip_smoke.py

Phases, each printing its results; any failure raises and the script exits
non-zero, printing no result:

1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from csrc/ with nvcc (build/kernels/)
   and print each kernel's registers, shared memory and spills (ptxas);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (B=64, K=17, 64x48) and at the shapes that reach
   the kernels' other paths (63x47 maps and a view at an odd offset, which
   take scalar loads and stores; 51 maps; NaN); then times (CUDA events),
   bounds and the plain version's times at B=64 and B=256, and the
   kernel's time and share of its HBM bound at B=1024, where each tensor
   is 4x the L2; K2 also timed with the L2 flushed before each call; then
   both kernels at the PIS shape (B=256, K=11, 64x48): K1's error 0, K2's
   x and y identical, their times; then K3 (train-mode BN + ReLU, bf16 in
   and out) at each of the 42 BN shapes of the benchmark's cells (SBP at
   batch 256, SPM at 32): y and dx within one bf16 ulp of the plain
   version's, the forward's and the backward's time against their byte
   bounds, the plain version's time and the library yardstick's
   (torch's fp32 batch_norm and ReLU around the casts, forward and
   backward), and the sums over a step's 21 layers;
4. serve: full-width SBP (darknet19, 256x192 input, 36,606,368 parameters,
   seeded weights, bf16) through ``load_sbp_predictor``: batch 1, batch 1,
   batch 64, uint8; plus one fp32 forward on the card against the CPU;
5. eval: ``validate`` (eval step: K1 targets, forward, loss, K2 decode, then
   the OKS metric) on a seeded batch with a COCO-format annotation file;
   the launch counts of the kernels are set to 0 before phase 4 and read
   after phase 5 (K1 and K2 launched, K3 not at all); then K1 stamps and
   K2 decodes the targets (GT probe), which must give back
   trunc(joint * ratio) * 4, and their AP is printed;
6. train, at the same full width (bf16, batch 256, sgd nesterov under
   yolo_lr, device CLAHE, the port's host loader over seeded crops in
   memory): a. ``Trainer(cfg, dm).fit()`` for one epoch of 20 steps, its
   validation and checkpoints, then a new ``Trainer`` resumed from ``last``
   for a second epoch, with the launch counts set to 0 before and read
   after (K1 once per train and per eval step, K2 once per eval step, K3
   forward and backward 21 times per train step, one a BN layer, and
   never in the validations); the train step's time by host clock and
   one step split by CUDA events;
   b. one fp32 train step (TF32 off) on the card against the same step on
   the CPU, same weights and draws, batch 2, beside the CPU's step with
   every weight moved by one ulp; c. 30 steps on one batch without
   augmentation at a constant lr: the loss must fall;
7. SPM at full width (configs/spm_coco.yaml: darknet19, 512x512 input,
   128x128 maps, 1 + 2K = 35 channels, 36,615,584 parameters, sigma 1,
   30 persons, batch 32, bf16; seeded weights and multi-person images made
   in memory; CLAHE on the device), with the launch counts set to 0 before
   and read after: neither K1 nor K2 may launch in it, K3 not in a-c and
   21 times forward and backward per train step of d's fits.  a. serve:
   ``load_for_inference`` + ``decode_spm_batch``, batch 1, 1 and 32, and
   the fp32 forward on the card against the CPU; b. eval: ``validate``
   (kind spm) on 32 seeded images with a COCO-format file, then the eval
   step and the decode alone by host clock; c. GT probe: targets of known
   persons decoded with pred=False give back every root at
   floor(center/4)*4 and every joint within 1e-3 px of floor(joint/4)*4;
   d. train: ``Trainer(kind="spm").fit()`` for 10 steps at batch 32 and a
   resumed epoch, the step's time and split, one fp32 step at 256x256 on
   the card against the CPU, 30 steps on a fixed batch (the loss must fall
   below a quarter), and one step with ``augment_geometric``: its time
   and peak memory;
8. PIS at full width (configs/sbp_pis.yaml: darknet19 SBP with an
   11-channel head, 256x192, 64x48 maps, sigma 2, batch 256, bf16, sgd
   nesterov under yolo_lr with burn-in 1000, CLAHE on the device, seeded
   11-joint crops in memory), the launch counts set to 0 before: a.
   ``saving_weights`` of phase 6's SBP ``last`` as ``model_pretrained``
   (the backbone must be the donor's, the rest the PIS model's own init);
   b. ``Trainer(kind="pis").fit()`` for 10 steps with validation through
   ``SBPmAPPIS`` (51 numbers per result) and a resumed epoch, K1 once per
   train and eval step, K2 once per eval step and K3 21 times forward and
   backward per train step, then the step's time and
   split; c. the predictor at batch 1, 1 and 64 (joints [B, 11, 3], K2 once
   a call); d. the GT probe at K=11; e. both behaviour harness functions
   on 64 labelled samples each, whose confusion counts from K2's joints
   must equal those of the plain decode of the same logits on the CPU;
9. the darknet19 classifier (configs/darknet19_classifier.yaml: 64x64,
   200 classes, batch 256, bf16, sgd nesterov lr 0.1 under
   cosine_annealing_warm_restarts; seeded images and labels in memory):
   ``train_classifier.train`` for 10 steps with validation and
   checkpoints, K3 19 times forward and backward per train step (its 19
   BN layers) and never in the validation; the step's time, split,
   images/s and peak memory; one fp32 step on the card against the CPU
   with the same weights and dropout mask; 30 steps on a fixed batch with
   dropout (the loss must fall); an SBP ``Trainer`` whose
   ``backbone_pretrained`` is the classifier's ``last`` (all 18 convs and
   their BN equal); neither K1 nor K2 may launch in it;
10. the device cache and the native loader, from JPEG files on disk
   (``tests/synth_fixture.py``, which needs cv2): a. build the port's
   native loader with g++ and say whether it built (the first line of
   g++'s error if not); b. ``build_device_cache`` of 800 train images
   (about 1,600 SBP instances at 256x192, about 236 MB, 6 steps an epoch at
   batch 256): its time, bytes and memo, then again from the memo alone
   (the decoder broken), equal arrays on the card; c. ``Trainer.fit`` at
   phase 6's config with ``cache_device: True`` and no ``clahe`` key, 2
   epochs with validation on 32 val images: CLAHE moved to the device,
   epoch 0 fed the cache's rows at ``epoch_indices(0)``, K1 once per train
   and eval step, K2 once per eval step, finite losses, each epoch's
   img/s; d. the streaming fit, one epoch, with cv2 and (if 10a built)
   the native loader, their img/s beside the loader's alone, and the two
   decoders' pixels on one val batch (mean difference under 2 levels); e.
   SPM with ``cache_device`` at
   512x512, batch 32, 64 images, one epoch: the memo holds image, joints
   and centers, and no launch of K1 or K2;
11. data parallelism (``parallel``) on the one card: a. world 1 under a
   real NCCL group (torchrun's environment set here): two steps of
   ``Trainer.fit`` give losses and parameters bitwise equal to the same
   run without a group (cuDNN deterministic for the pair); then two ranks,
   both on cuda:0 over gloo (NCCL refuses two ranks on one card), started
   by ``parallel.launch``: b. one fp32 train step (TF32 off) of
   full-width SBP at the global batch 256, 128 rows a rank, against the
   one-process step on the card from the same weights and draws (loss
   1e-5, update 0.1 of its norm, BN statistics 3e-4, phase 6b's bounds),
   the ranks' parameters bitwise equal, then each rank's step time and
   peak memory (two ranks sharing one card: not a scaling figure); c. the
   cached ``Trainer.fit`` (fp32, so that the AP comparison sees no
   batch-size-dependent bf16 rounding) on phase 10's JPEG set, each rank
   holding half of the padded cache, 2 epochs and then a resumed epoch
   ('auto'): epoch 0's rows on each rank equal the JAX package's 2-device
   cache order recomputed here with numpy, K1 launches once per train and
   eval step and K2 once per eval step on each rank, one checkpoint writer
   (rank 0), the ranks' final states bitwise equal, and the last
   (val_loss, val_mAP) equals a one-process ``validate`` of rank 0's final
   weights (loss 1e-6, AP exactly); d. with two or more cards, 11b again
   over NCCL with a card per rank, else "skipped: 1 card";
12. the port learns: tests/test_convergence_e2e.py's recipe
   (``tools.convergence``: configs/sbp_coco.yaml at 128x96 in, 32x24 maps,
   batch 16, fp32, ``cache_device``, no CLAHE, mild augmentation, burn-in
   10) on 16 synthetic images, the same set for train and val, in one
   process (31 instances, 1 step an epoch), in rounds of 4 epochs (seed 7
   + round), validated every ``LEARN_VAL_EVERY`` rounds, at most
   ``LEARN_ROUNDS``: the APs, the round whose validation reached 0.55
   (else the phase fails), the seconds, and the launch counts (set to 0
   just before, read just after: K1 once per train and eval step, K2 once
   per eval step);
13. SPM at reference scale: configs/spm_synth_ref.yaml's corpus
   (``tools.spm_ref``: 5,000 train images of 640x512 with 27,656
   instances, 500 val with 2,774; the four counts checked) and its recipe
   (``tools.spm_ref.SPM_SYNTH_REF``: 512 -> 128, batch 32, bf16,
   ``augment_geometric``, ``cache_device`` with CLAHE in the step,
   ``max_persons`` 10) through ``train_spm.train`` for 2 epochs (312
   steps), validated after each on the 500 val images: the device cache's
   rows (5,000), bytes and build time, 156 steps an epoch, each epoch's
   images/s, each validation's seconds, the peak memory, finite losses, a
   val_loss at epoch 1 below
   epoch 0's, and 0 launches of K1 and K2 (set to 0 just before the fit,
   read just after); then ``test_spm.test`` of the phase's ``last`` gives
   epoch 1's val_loss (1e-4) and AP@.5 (exactly) again; the memo re-read
   with the decoder broken; the geometric train step alone on a cached
   batch, by host clock and split by CUDA events.  Only the epochs are cut
   (from 200); the corpus and the recipe are the run's;
14. height-sharded inference (``parallel.spatial``), two ranks both on
   cuda:0 over gloo, batch 1, weights seeded and calibrated (BN running
   statistics from 16 seeded images, the head scaled so that the logits lie
   within +-1 there) and saved, so that every process loads the same file:
   a. SBP at 256x192 in fp32 (TF32 off): the gathered logits against the
   one-process ``load_for_inference`` logits (rtol 2e-4, atol 2e-5,
   tests/test_parallel.py's), and K2 (``decode_sbp_fast`` on the card) on
   the gathered logits against the one-process ``load_sbp_predictor``'s
   joints, a channel whose top two sigmoid values lie within 1e-5 allowed
   to differ (counted and printed); b. SPM at 512x512 in fp32: the logits
   as in a, and ``decode_spm_batch``'s roots at the one-process decode's
   pixels and its joints within what the logit tolerance allows; c. SBP
   in bf16 (the default):
   the largest logit gap over the largest logit and the share of K2's
   joints that agree (figures, not gates); d. with two or more cards, a
   again over NCCL with a card per rank, else "skipped: 1 card".  Printed:
   the one-process forward's ms, each rank's sharded forward ms and the ms
   of its exchanges, and the halo bytes a forward sends (two ranks sharing
   one card: not a scaling figure).  The launch counts are set to 0 just
   before the phase and read just after;
15. the spm_synth_hard recipe (``tools.spm_ref.SPM_SYNTH_HARD``:
   configs/spm_synth_hard.yaml's values, 256 -> 64, batch 32, bf16,
   ``augment_geometric``, ``cache_images``, ``max_persons`` 10) on its
   corpus (``make_dataset`` with ``tools.spm_ref.HARD_CORPUS``: 5-8
   persons an image, checked) cut to 64 train and 16 val images, through
   ``train_spm.train`` for 2 epochs (4 steps), validated after each: each
   epoch's images/s, each validation's seconds, the peak memory, finite
   losses, a train loss at epoch 1 below epoch 0's (val_loss is printed:
   at full lr it rises tenfold over these steps, in the JAX package's
   run of the same fit too, tests/spm_hard_witness.py) and 0 launches of
   K1 and K2 (set to 0 just before the fit, read just after); ``test_spm.test``
   of ``last`` gives epoch 1's val_loss (1e-4) and AP@.5 (exactly) again;
   then the geometric train step alone at 256x256 on a batch of the host
   loader, by host clock and split by CUDA events.  The images and the
   epochs are cut, and yolo_lr's burn-in with them (300 of 2,000 steps,
   1 of 4: at 300 the lr stays under 1e-10); the rest is the run's;
16. the JAX package's per-example image ops in the port, on the card
   against the CPU with the same draws: ``sample_train_affine``'s core
   (64 matrices), ``affine_warp`` of 64 images at 256x192 each by its own
   matrix's inverse, ``rotate_shear3`` of the batch of 64 and
   ``color_jitter`` of one image: the largest gap of each (at most 1e-5)
   and its device time; then ``save_params`` of the full-width SBP on the
   card and ``restore_params`` (bitwise the saved state_dict), and the
   predictor from the file (``load_sbp_predictor``) gives the saved
   model's joints on 64 images exactly, with the launch counts set to 0
   just before and read just after (K2 twice).

The last three lines of standard output: the card's name and power limit,
one JSON object describing each kernel (K1 and K2: launches summed over
phases 4-10 and 12, each rank's launches in 11c, and phases 12's, 13's,
14's, 15's and 16's alone; K3: its forward and backward launches in the
fits of phases 6-9 and in phases 4-5 and 7a-c, each with its train
steps, and per cell its times summed over a step's 21 layers),
and ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``.  The configs are written inline with the values of
configs/sbp_coco.yaml, spm_coco.yaml, sbp_pis.yaml,
darknet19_classifier.yaml, spm_synth_ref.yaml and spm_synth_hard.yaml, so
PyYAML is not needed; phases 1-9 make their data in memory, phases 10,
12, 13 and 15 write JPEG files with cv2.  Imports nothing of
JAX.
"""

import contextlib
import datetime
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pytorch_pose_estimation_tpu_torch import (optim, parallel,
                                               pis_falling_down_test_code,
                                               pis_handle_test_code,
                                               saving_weights, test_spm,
                                               train_classifier, train_spm)
from pytorch_pose_estimation_tpu_torch.data import (HostLoader,
                                                    SBPCOCODataModule,
                                                    SPMCOCODataModule,
                                                    native_loader)
from pytorch_pose_estimation_tpu_torch.eval import SBPmAPCOCO, SBPmAPPIS
from pytorch_pose_estimation_tpu_torch.models import (count_params,
                                                      load_state_dict_file)
from pytorch_pose_estimation_tpu_torch.models.darknet import (
    STAGE_NAMES, dropout_mask_shape, sample_dropout_mask)
from pytorch_pose_estimation_tpu_torch.ops import decode as decode_ops
from pytorch_pose_estimation_tpu_torch.ops import image as image_ops
from pytorch_pose_estimation_tpu_torch.ops import kernels
from pytorch_pose_estimation_tpu_torch.ops import targets as target_ops
from pytorch_pose_estimation_tpu_torch.ops.image import (normalize_batch,
                                                         sample_augment,
                                                         sample_photometric)
from pytorch_pose_estimation_tpu_torch.train import checkpoint
from pytorch_pose_estimation_tpu_torch.train import trainer as trainer_module
from pytorch_pose_estimation_tpu_torch.pis import (HANDLE_ROI, NEG_MAX,
                                                   POS_MIN, FallingDown,
                                                   HandleGrip)
from pytorch_pose_estimation_tpu_torch.profile_train_step import spm_people
from pytorch_pose_estimation_tpu_torch.tools import convergence, spm_ref
from pytorch_pose_estimation_tpu_torch.train import (Trainer,
                                                     build_device_cache,
                                                     build_model,
                                                     load_for_inference,
                                                     load_model,
                                                     load_sbp_predictor,
                                                     make_sbp_steps,
                                                     make_spm_eval_step,
                                                     make_spm_steps,
                                                     validate)
from pytorch_pose_estimation_tpu_torch.train.steps import (_sbp_targets,
                                                           _spm_targets)

# configs/sbp_coco.yaml, the fields the serving and eval path reads
CFG = {
    "input_size": [256, 192], "output_size": [64, 48], "num_keypoints": 17,
    "sigma": 2, "conf_threshold": 0.25, "batch_size": 64,
    "precision": "bf16", "seed": 0,
}
# configs/sbp_coco.yaml's training fields (phase 6); validation and
# checkpoints every epoch, CLAHE on the device
TRAIN_CFG = dict(
    CFG, model="simple-baselines-pose", dataset_name="coco-keypoints",
    batch_size=256, epochs=1, save_freq=1, clahe="device", optimizer="sgd",
    optimizer_options={"lr": 1e-3, "momentum": 0.9, "weight_decay": 5e-3,
                       "nesterov": True},
    scheduler="yolo_lr",
    scheduler_options={"burn_in": 2000, "steps": [105000], "scales": [0.1]},
    trainer_options={"check_val_every_n_epoch": 1,
                     "num_sanity_val_steps": 0})
TRAIN_STEPS = 20  # per epoch, at batch 256
B, K, H, W = 64, 17, 64, 48
BIG = 1024  # B at which each tensor (214 MB) is 4x the 50 MB L2
# H100 SXM data sheet: HBM rate, fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per element, counted high (K1 takes the exp only inside
# the window); the byte bound is the larger either way
K1_OPS_PER_ELEM = 20  # window (4 rint, 4 compares), 2 squares, exp, div, ...
K2_OPS_PER_ELEM = 5   # sigmoid (neg, exp, add, div) and one compare


def device_ms(fn, iters=100):
    """Device time per call: the calls are queued behind a sleep kernel, so
    the host's launch overhead does not open gaps between them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(ok, message):
    """A failed check stops the run (asserts would vanish under -O)."""
    if not ok:
        raise RuntimeError(message)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; it needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}); nvidia-smi: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card


def phase_build():
    secs = kernels.build_kernels()
    print(f"build: kernels built and loaded in {secs:.2f} s")
    for line in kernels.ptxas_report():
        print(f"build: {line}")


def share(b, bnd, ms):
    """The share of the HBM bound, stated only at B=1024: at the main
    path's sizes the data may sit in L2, and a kernel faster than its
    bound read from L2 what the bound counts from HBM."""
    if b != BIG:
        return "share stated at B=1024 only"
    if bnd > ms:
        return "the HBM bound does not bind at this size (data in L2)"
    return f"{bnd / ms:.1%} of the HBM bound"


# the map's edges: corners, coordinates past the map (clipped), fractional
# ones just inside, negatives on one axis only (invisible)
EDGES = [[0, 0], [47, 63], [47.9, 63.9], [48.5, 64.5], [100, 2], [0.5, 63.5],
         [-0.5, 10], [10, -3], [0, 0.99]]


def _joints(gen, b, k, h, w):
    j = torch.rand(b, k, 2, generator=gen) * torch.tensor(
        [w + 20.0, h + 20.0]) - 10.0
    j[torch.rand(b, k, generator=gen) < 0.3] = -1.0
    j[0, :len(EDGES)] = torch.tensor(EDGES)
    return j.cuda()


def phase_k1(gen):
    """K1 against the plain version at sigma 2 (error 0) and 1.5 (half-to-
    even window bounds; 1e-6: expf and the division may differ by an ulp
    of values <= 1), on 64x48 maps (16-byte stores) and 63x47 maps (H*W
    odd: scalar stores), with the edge joints in the first sample."""
    err = 0.0
    for h, w in ((H, W), (63, 47)):
        joints = _joints(gen, B, K, h, w)
        for sigma, tol in ((2.0, 0.0), (1.5, 1e-6)):
            got = kernels.sbp_heatmaps_cuda(joints, (h, w), sigma)
            want = target_ops.sbp_heatmaps(joints, (h, w), K, sigma)
            e = float((got - want).abs().max())
            print(f"K1 {h}x{w} sigma={sigma}: max abs err {e:.3g} vs plain "
                  f"(max value {float(got.max()):.4f})")
            check(e <= tol, f"K1 disagrees with its plain version at "
                  f"{h}x{w}, sigma {sigma}: {e}")
            err = max(err, e)
    rows = {}
    for b in (B, 256, BIG):
        j = _joints(gen, b, K, H, W)
        ms = device_ms(lambda: kernels.sbp_heatmaps_cuda(j, (H, W), 2.0))
        n = b * K * H * W
        bnd, by = bound_ms(b * K * 2 * 4 + n * 4, n * K1_OPS_PER_ELEM)
        plain = None
        if b < BIG:  # the plain version's temporaries need not be timed
            plain = device_ms(
                lambda: target_ops.sbp_heatmaps(j, (H, W), K, 2.0), iters=20)
        print(f"K1 B={b}: kernel {ms * 1e3:.2f} us, bound {bnd * 1e3:.2f} us "
              f"({by}), {share(b, bnd, ms)}"
              + (f"; plain {plain * 1e3:.2f} us" if plain else ""))
        rows[b] = (ms, plain, bnd, by)
    return err, rows


def _decode_cases(gen, b, h, w, k=K):
    """(name, logits, threshold, pred) on [b, k, h, w] maps."""
    rand = (torch.randn(b, k, h, w, generator=gen) * 3).cuda()
    ties = torch.full((b, k, h, w), -5.0, device="cuda")
    ties[:, 0] = 30.0  # saturates to 1.0 everywhere: index 0 wins
    flat = ties.view(b, k, h * w)
    flat[:, 1, 100] = 25.0  # ties with 20.0 at index 50 after the sigmoid
    flat[:, 1, 50] = 20.0
    ties[:, 2] = -20.0  # nothing clears the threshold: sentinel
    below = torch.zeros(b, k, h, w, device="cuda")  # 0.5 < 0.9
    stamped = kernels.sbp_heatmaps_cuda(_joints(gen, b, k, h, w), (h, w), 2.0)
    nan = rand.clone()
    nan.view(b, k, h * w)[0, 3, h * w // 2 + 1] = float("nan")
    return [("random x3", rand, 0.25, True),
            ("saturated ties", ties, 0.25, True),
            ("all below threshold", below, 0.9, True),
            ("pred=False on K1 targets", stamped, 0.99, False),
            ("NaN mid-map", nan, 0.25, True)]


def _at_offset_1(x):
    """The same values as a contiguous view one float into its storage:
    every map starts off a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, device=x.device)
    buf[1:].copy_(x.flatten())
    view = buf[1:].view(x.shape)
    check(view.is_contiguous() and view.data_ptr() % 16 != 0,
          "the offset view is not a misaligned contiguous tensor")
    return view


def _decode_check(gen, b, h, w, offset, k=K):
    """Every case on one layout: x and y identical to the plain version,
    conf within 1e-6 (both compute the sigmoid as 1/(1+expf(-x)))."""
    label = f"B={b} K={k} {h}x{w}" + (" at offset 1" if offset else "")
    err = 0.0
    cases = _decode_cases(gen, b, h, w, k)
    s = np.float32(192 / w)
    for name, logits, thr, pred in cases:
        if offset:
            logits = _at_offset_1(logits)
        got = kernels.decode_sbp_cuda(logits, 192, thr, pred)
        want = decode_ops.decode_sbp_batch(logits, 192, thr, pred)
        xy_same = bool(torch.equal(got[..., :2], want[..., :2]))
        e = float((got - want).abs().max())
        found = int((got[..., 2] >= 0).sum())
        print(f"K2 {label} {name}: x/y identical {xy_same}, max abs err "
              f"{e:.3g}, {found}/{b * k} found")
        check(xy_same and e <= 1e-6, f"K2 disagrees on {label} {name}: {e}")
        err = max(err, e)
        if name == "saturated ties":
            check(torch.equal(got[0, :3].cpu(), torch.tensor(
                [[0.0, 0.0, 1.0],
                 [np.float32(50 % w) * s, np.float32(50 // w) * s, 1.0],
                 [-s, -s, -1.0]])), "K2 broke a tie against the first index")
        if name == "NaN mid-map":
            # NaN wins the map as in torch.argmax, and fails the threshold
            clean = kernels.decode_sbp_cuda(cases[0][1], 192, thr, pred)
            check(float(clean[0, 3, 2]) > thr and torch.equal(
                got[0, 3].cpu(), torch.tensor([-s, -s, -1.0])),
                "K2 let a finite value win over a NaN")
    return err


def cold_ms(fn, flush, iters=20):
    """Device time of one call, timed alone between two events; before
    each call a zero_() of ``flush`` (256 MB: evicts the 50 MB L2) unless
    it is None, then a sleep kernel that covers the host's enqueue."""
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in events:
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def phase_k2(gen):
    """K2 against the plain version on every layout the kernel takes: the
    main path's (16-byte loads), 63x47 maps and a view at an odd offset
    (scalar loads), and B=3 (51 maps).  Then times."""
    err = max(_decode_check(gen, b, h, w, off) for b, h, w, off in (
        (B, H, W, 0), (B, 63, 47, 0), (B, H, W, 1), (3, H, W, 0)))
    rows, agree = {}, []
    cuda_gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, device="cuda")  # 256 MB
    # the single-call method's own cost per call, read on an empty kernel:
    # the launch latency that back-to-back calls hide
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    overhead = cold_ms(empty, None) - device_ms(empty)
    print(f"K2 single-call timing overhead: {overhead * 1e3:.2f} us per call "
          f"(an empty kernel timed alone, less back to back)")
    for b in (B, 256, BIG):
        x = torch.randn(b, K, H, W, generator=cuda_gen, device="cuda") * 3
        ms = device_ms(lambda: kernels.decode_sbp_cuda(x, 192, 0.25))
        n = b * K * H * W
        bnd, by = bound_ms(n * 4 + b * K * 3 * 4, n * K2_OPS_PER_ELEM)
        line = (f"K2 B={b}: kernel {ms * 1e3:.2f} us, bound "
                f"{bnd * 1e3:.2f} us ({by}), {share(b, bnd, ms)}")
        plain = None
        if b < BIG:
            plain = device_ms(
                lambda: decode_ops.decode_sbp_batch(x, 192, 0.25), iters=20)
            composite = device_ms(
                lambda: torch.sigmoid(x).flatten(2).max(2), iters=20)
            line += (f"; plain {plain * 1e3:.2f} us, yardstick "
                     f"torch.sigmoid(x).flatten(2).max(2) "
                     f"{composite * 1e3:.2f} us (not one call)")
        print(line)
        rows[b] = (ms, plain, bnd, by)
        if b in (B, BIG):
            fn = lambda: kernels.decode_sbp_cuda(x, 192, 0.25)  # noqa: E731
            cold = cold_ms(fn, flush) - overhead
            alone = cold_ms(fn, None) - overhead
            print(f"K2 B={b} cold: kernel {cold * 1e3:.2f} us with the L2 "
                  f"flushed before each call, {share(b, bnd, cold)}; "
                  f"{alone * 1e3:.2f} us by the same method without the "
                  f"flush (warm, back to back: {ms * 1e3:.2f} us); both "
                  f"less the overhead")
            agree.append((b, alone, ms))
    # the single-call method must read a warm call as the warm method does,
    # within a quarter or 3 us: a call alone still carries about 2 us of
    # ramp that back-to-back calls overlap (1.8 us at B=64 on an H100)
    for b, alone, ms in agree:
        check(abs(alone - ms) <= max(0.25 * ms, 0.003),
              f"K2 B={b}: a call timed alone ({alone * 1e3:.2f} us) "
              f"disagrees with the warm time ({ms * 1e3:.2f} us)")
    return err, rows


def phase_k11(gen):
    """Both kernels at the PIS shape (B=256, K=11, 64x48): K1 against its
    plain version at sigma 2 (error 0), K2 on every decode case (x and y
    identical, conf within 1e-6); then their times, bounds and the plain
    versions' times.  Returns (K1 error, K2 error, rows)."""
    b = PIS_B
    joints = _joints(gen, b, PIS_K, H, W)
    got = kernels.sbp_heatmaps_cuda(joints, (H, W), 2.0)
    want = target_ops.sbp_heatmaps(joints, (H, W), PIS_K, 2.0)
    k1_err = float((got - want).abs().max())
    print(f"K1 B={b} K={PIS_K} {H}x{W} sigma=2: max abs err {k1_err:.3g} vs "
          f"plain")
    check(k1_err == 0.0, f"K1 disagrees with its plain version at K={PIS_K}")
    k2_err = _decode_check(gen, b, H, W, 0, PIS_K)
    x = torch.randn(b, PIS_K, H, W, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(2)) * 3
    n = b * PIS_K * H * W
    rows = {}
    for name, fn, plain, n_bytes, ops in (
            ("sbp_heatmaps_cuda",
             lambda: kernels.sbp_heatmaps_cuda(joints, (H, W), 2.0),
             lambda: target_ops.sbp_heatmaps(joints, (H, W), PIS_K, 2.0),
             b * PIS_K * 2 * 4 + n * 4, n * K1_OPS_PER_ELEM),
            ("decode_sbp_cuda",
             lambda: kernels.decode_sbp_cuda(x, 192, 0.25),
             lambda: decode_ops.decode_sbp_batch(x, 192, 0.25),
             n * 4 + b * PIS_K * 3 * 4, n * K2_OPS_PER_ELEM)):
        ms = device_ms(fn)
        plain_ms = device_ms(plain, iters=20)
        bnd, by = bound_ms(n_bytes, ops)
        rows[name] = (ms, plain_ms, bnd, by)
        print(f"{name} B={b} K={PIS_K}: kernel {ms * 1e3:.2f} us, bound "
              f"{bnd * 1e3:.2f} us ({by}), plain {plain_ms * 1e3:.2f} us")
    return k1_err, k2_err, rows


# K3 (csrc/bn_act.cu): bytes an element, the bf16 input read twice and the
# output written (forward); dy and x read twice and dx written (backward);
# fp32 operations an element, counted high (the statistics, the apply)
K3_FWD_BYTES, K3_BWD_BYTES = 6, 10
K3_FWD_OPS, K3_BWD_OPS = 8, 14
BN_ACT_COMMON = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "_bn_act_common.py")


def _load_path(name, path):
    """The module at ``path``, loaded by its path as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# K3's two wrappers; their launches are counted apart from K1's and K2's
# (``kernels.KERNELS``), set to 0 with them by ``_zero_launches``, and
# checked per phase against the BN layers of the model the phase trains
K3 = (kernels.bn_act_forward_cuda, kernels.bn_act_backward_cuda)
BN_LAYERS = 21  # SBP, PIS and SPM: 18 trunk blocks and 3 deconvolutions
CLS_BN_LAYERS = 19  # the classifier: 18 trunk blocks and its last conv
# per phase, K3's forward and backward launches and the train steps they
# came from (filled by the phases; the JSON line's ``bn_act_cuda`` row)
K3_LAUNCHES = {}


def _zero_launches():
    """K1's, K2's and K3's launch counts to 0."""
    for kern in kernels.KERNELS + K3:
        kern.launches = 0


def _k3_counts():
    return {"forward": K3[0].launches, "backward": K3[1].launches}


def check_k3(phase, train_steps, layers=BN_LAYERS):
    """K3 launched once forward and once backward per BN layer per train
    step since the counts were last set to 0, and never outside a train
    step; keeps the counts under ``phase``."""
    got = _k3_counts()
    want = layers * train_steps
    K3_LAUNCHES[phase] = dict(got, train_steps=train_steps)
    check(got == {"forward": want, "backward": want},
          f"{phase}: K3 launched {got}, want {want} each ({layers} BN "
          f"layers x {train_steps} train steps)")


def _library_bn_relu(x, w, b, rm, rv):
    """The library yardstick K3 replaced, never called by the port:
    torch's fp32 batch_norm and ReLU around the casts."""
    return torch.relu(torch.nn.functional.batch_norm(
        x.float(), rm, rv, w, b, True, 0.1, 1e-5)).to(torch.bfloat16)


def phase_k3():
    """K3 at each of the 42 BN shapes of the benchmark's cells (SBP at
    batch 256, SPM at 32, ReLU): y and dx against the plain version (at
    most one bf16 ulp apart, beside what fp32 ordering and the ReLU masks
    of a bf16 value at the threshold allow: tests/_bn_act_common.py's
    ``reference``); the forward's and the backward's device
    time against their byte bounds; the plain version's forward and
    backward; the library yardstick (torch's fp32 batch_norm and ReLU
    around the casts, its forward and its backward by autograd).  Returns
    per cell the summed times and bounds, and the largest shares of y's
    and dx's elements that are not bit-equal to the plain version's."""
    from pytorch_pose_estimation_tpu_torch.models.layers import (
        bn_act_backward_plain, bn_act_forward_plain)
    common = _load_path("_bn_act_common", BN_ACT_COMMON)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator("cuda").manual_seed(3)
    out, worst = {}, [0.0, 0.0]
    for cell in common.CELLS:
        tot = dict.fromkeys(("fwd", "bwd", "fwd_bound", "bwd_bound",
                             "plain", "lib_fwd", "lib_bwd"), 0.0)
        for i, shape in enumerate(common.cell_shapes(cell)):
            n, c = shape[0], shape[1]
            x = (torch.randn(shape, device="cuda", generator=gen) * 2
                 + 0.5).to(torch.bfloat16)
            dy = torch.randn(shape, device="cuda",
                             generator=gen).to(torch.bfloat16)
            w = torch.rand(c, device="cuda", generator=gen) + 0.5
            b = torch.randn(c, device="cuda", generator=gen) * 0.3
            rm, rv = torch.zeros(c, device="cuda"), torch.ones(c,
                                                               device="cuda")
            nbt = torch.zeros((), dtype=torch.int64, device="cuda")
            args = (w, b, rm, rv, nbt, 0.1, 1e-5, True)
            y, stats = kernels.bn_act_forward_cuda(x, *args)
            dx = kernels.bn_act_backward_cuda(dy, x, stats, True)[0]
            y_p, stats_p = bn_act_forward_plain(x, *args)
            dx_p = bn_act_backward_plain(dy, x, stats_p, True)[0]
            ref = common.reference(x, dy, w, b, 1e-5, True)
            gaps = (common.bf16_excess(y, y_p, ref["slack_y"]),
                    common.bf16_excess(dx, dx_p, ref["slack_dx"]))
            del ref
            check(gaps[0][0] == 0 and gaps[1][0] == 0,
                  f"K3 disagrees with its plain version at {cell} {shape}: "
                  f"{gaps}")
            worst = [max(worst[0], 1 - gaps[0][1]),
                     max(worst[1], 1 - gaps[1][1])]
            ms_f = device_ms(lambda: kernels.bn_act_forward_cuda(x, *args),
                             iters=20)
            ms_b = device_ms(
                lambda: kernels.bn_act_backward_cuda(dy, x, stats, True),
                iters=20)
            plain = device_ms(lambda: bn_act_backward_plain(
                dy, x, bn_act_forward_plain(x, *args)[1], True), iters=5)
            xr = x.detach().requires_grad_()
            wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
            lib_f = device_ms(lambda: _library_bn_relu(xr, wr, br, rm, rv),
                              iters=5)
            y_lib = _library_bn_relu(xr, wr, br, rm, rv)
            lib_b = device_ms(lambda: torch.autograd.grad(
                y_lib, (xr, wr, br), dy, retain_graph=True), iters=5)
            del y_lib
            numel = x.numel()
            bf, _ = bound_ms(numel * K3_FWD_BYTES, numel * K3_FWD_OPS)
            bb, _ = bound_ms(numel * K3_BWD_BYTES, numel * K3_BWD_OPS)
            for k, v in (("fwd", ms_f), ("bwd", ms_b), ("fwd_bound", bf),
                         ("bwd_bound", bb), ("plain", plain),
                         ("lib_fwd", lib_f), ("lib_bwd", lib_b)):
                tot[k] += v
            plan = kernels.bn_plan(n, c, shape[2] * shape[3], 1, sms)
            print(f"K3 {cell} {i + 1:2d}/21 {list(shape)}: fwd {ms_f:.4f} ms "
                  f"(bound {bf:.4f}, {bf / ms_f:.1%}), bwd {ms_b:.4f} ms "
                  f"(bound {bb:.4f}, {bb / ms_b:.1%}); plain {plain:.4f}, "
                  f"library fwd {lib_f:.4f} bwd {lib_b:.4f} ms; bit-equal "
                  f"y {gaps[0][1]:.4%}, dx {gaps[1][1]:.4%}; plan "
                  f"{tuple(plan)}")
        k3 = tot["fwd"] + tot["bwd"]
        bound = tot["fwd_bound"] + tot["bwd_bound"]
        lib = tot["lib_fwd"] + tot["lib_bwd"]
        print(f"K3 {cell}, the 21 layers of a step: fwd {tot['fwd']:.3f} + "
              f"bwd {tot['bwd']:.3f} = {k3:.3f} ms, bound {bound:.3f} ms "
              f"({bound / k3:.1%}); plain {tot['plain']:.3f} ms; library "
              f"{tot['lib_fwd']:.3f} + {tot['lib_bwd']:.3f} = {lib:.3f} ms")
        out[cell] = tot
    return out, worst


def phase_serve():
    """Three requests through the fused uint8 -> joints predictor."""
    predict = load_sbp_predictor(CFG, None)
    rng = np.random.RandomState(0)
    for n in (1, 1, 64):
        images = rng.randint(0, 256, (n, 256, 192, 3), dtype=np.uint8)
        before = kernels.decode_sbp_cuda.launches
        t0 = time.perf_counter()
        joints = predict(images)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(joints.shape == (n, K, 3) and joints.is_cuda,
              f"serve: joints {tuple(joints.shape)} on {joints.device}")
        check(bool(torch.isfinite(joints).all()), "serve: non-finite joints")
        check(kernels.decode_sbp_cuda.launches == before + 1,
              "serve: the request did not launch K2")
        print(f"serve: batch {n}: joints {tuple(joints.shape)} finite, "
              f"{dt * 1e3:.1f} ms host clock (first call includes set-up)")


def _eval_set(tmp, n_images, rng, k=K, name="person_keypoints_val.json"):
    """One seeded batch of person crops already at the input size, bbox
    [0, 0, 192, 256] (crop frame == image frame), and its COCO file (17
    keypoint slots; with k=11 the last 6 are zero, as in the PIS
    annotations)."""
    joints = np.stack([rng.uniform(0, 192, (n_images, k)),
                       rng.uniform(0, 256, (n_images, k))],
                      axis=-1).astype(np.float32)
    vis = (rng.rand(n_images, k) > 0.2).astype(np.float32)
    joints[vis == 0] = 0.0
    images, anns = [], []
    for i in range(n_images):
        kps = []
        for (x, y), v in zip(joints[i], vis[i]):
            kps += [float(x), float(y), 2 if v else 0]
        kps += [0, 0, 0] * (17 - k)
        images.append({"id": i + 1, "file_name": f"{i + 1:012d}.jpg",
                       "width": 192, "height": 256})
        anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1,
                     "iscrowd": 0, "area": 192.0 * 256.0,
                     "bbox": [0.0, 0.0, 192.0, 256.0], "keypoints": kps,
                     "num_keypoints": int(vis[i].sum())})
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    batch = {
        "image": rng.randint(0, 256, (n_images, 256, 192, 3),
                             dtype=np.uint8),
        "joints": joints, "joints_vis": vis,
        "bbox": np.tile(np.array([0, 0, 192, 256], np.float64),
                        (n_images, 1)),
        "image_id": np.arange(1, n_images + 1, dtype=np.int64),
        "category_id": np.ones(n_images, np.int64),
    }
    return path, batch


class _Batches:
    """A data module whose val loader yields prepared batches."""

    def __init__(self, batches):
        self.batches = batches

    def val_loader(self):
        return iter(self.batches)


def phase_eval(batch, cfg):
    model = load_model(cfg, None)
    before = (kernels.sbp_heatmaps_cuda.launches,
              kernels.decode_sbp_cuda.launches)
    val_loss, val_map = validate(cfg, _Batches([batch]), model,
                                 verbose=False)
    check(np.isfinite(val_loss) and 0.0 <= val_map <= 1.0,
          f"eval: val_loss {val_loss}, AP {val_map}")
    check(kernels.sbp_heatmaps_cuda.launches > before[0],
          "eval: validate did not launch K1")
    check(kernels.decode_sbp_cuda.launches > before[1],
          "eval: validate did not launch K2")
    print(f"eval: validate on {len(batch['image'])} instances: val_loss "
          f"{val_loss:.6f}, AP@.5 {val_map:.4f} (random weights)")


def gt_probe(batch, cfg, metric_cls=SBPmAPCOCO):
    """K1 stamps the eval batch's targets and K2 decodes them with
    pred=False: every visible joint must come back as trunc(joint*ratio)*4;
    the AP of those joints (``metric_cls``) must be ~1."""
    ratio = H / 256
    joints = torch.from_numpy(batch["joints"]).cuda()
    vis = torch.from_numpy(batch["joints_vis"]).cuda()
    k = joints.shape[1]
    maps = _sbp_targets(joints, vis, ratio, (H, W), k, 2.0)
    dec = decode_ops.decode_sbp_fast(maps, 192, 0.99, pred=False).cpu()
    j = batch["joints"]
    want = np.trunc(j * np.float32(ratio)) * 4
    seen = batch["joints_vis"] >= 1
    check(np.array_equal(dec[..., :2].numpy()[seen], want[seen]),
          "GT probe: a visible joint came back elsewhere")
    check(bool((dec[..., 2].numpy()[seen] == 1.0).all()),
          "GT probe: a stamped peak is not 1.0")
    check(bool((dec[..., 2].numpy()[~seen] == -1.0).all()),
          "GT probe: an invisible joint was found")
    metric = metric_cls(cfg["val_path"], cfg["input_size"], 0.25)
    metric.update_state_decoded(batch, dec)
    ap = metric.result(verbose=False)
    print(f"GT probe K={k}: K1 -> K2(pred=False) recovered all "
          f"{int(seen.sum())} visible joints exactly; their AP@.5 {ap:.4f} "
          f"({metric_cls.__name__})")
    check(ap > 0.99, f"GT probe: AP@.5 {ap}")


def fp32_cross_check(cfg, kind, shape):
    """One fp32 forward (TF32 off) on the card against the CPU, same seeded
    weights and a seeded uint8 input of ``shape`` (NHWC)."""
    cfg = dict(cfg, precision="fp32")
    x = normalize_batch(torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, shape, dtype=np.uint8)))
    with torch.inference_mode():
        model = load_model(cfg, None, "cuda", kind)
        gpu = model(x.cuda()).cpu()
        cpu = load_model(cfg, None, "cpu", kind)(x)
        # the same forward with TF32 on, printed for scale: the limit
        # below must sit under it
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = model(x.cuda()).cpu()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    diff = float((gpu - cpu).abs().max())
    scale = float(cpu.abs().max())
    tf32_diff = float((tf32 - cpu).abs().max())
    print(f"fp32 forward {kind}, card vs CPU: max |logit| {scale:.4g}, max "
          f"diff {diff:.3g} ({diff / scale:.3g} relative); with TF32 on "
          f"{tf32_diff / scale:.3g} relative")
    check(diff <= 1e-5 * scale,
          f"fp32 {kind} logits differ between card and CPU")


class _MemoryData:
    """A data module over seeded samples made in memory (cv2 is not
    assumed on the card host): the port's ``HostLoader`` collates them.
    ``train`` holds one array per batch key over the distinct samples; the
    train set is ``n_train`` records over them; the val set is one
    prepared batch (with its annotation file)."""

    def __init__(self, train, n_train, val_batch, batch_size):
        self.train = train
        self.n_unique = len(next(iter(train.values())))
        self.train_db = list(range(n_train))
        self.val = val_batch
        self.val_db = list(range(len(val_batch["image"])))
        self.batch_size = batch_size
        self.clahe_prob = 0.5  # host CLAHE; clahe: device turns it off

    def _train_sample(self, rec, index, epoch):
        return {k: v[rec % self.n_unique] for k, v in self.train.items()}

    def _val_sample(self, rec, index, epoch):
        return {k: v[rec] for k, v in self.val.items()}

    def train_loader(self):
        return HostLoader(self.train_db, self._train_sample, self.batch_size,
                          shuffle=True, seed=0, drop_last=True)

    def val_loader(self):
        return HostLoader(self.val_db, self._val_sample, self.batch_size)

    def first(self, n, device=None):
        """The first n training samples as a batch of tensors."""
        return {k: torch.from_numpy(v[:n]).to(device or "cpu")
                for k, v in self.train.items()}


def _recording(step, losses):
    """The trainer's train step, keeping each step's loss (a device
    scalar: no sync)."""
    def wrapped(*args, **kwargs):
        loss = step(*args, **kwargs)
        losses.append(loss)
        return loss
    return wrapped


def phase_train_fit(cfg, dm, save_dir, kind, steps):
    """Fit one epoch, validate, save; resume from ``last`` for a second
    epoch in a new Trainer.  Checks K3's launches over both fits (21 BN
    layers a train step, none in the validations).  Returns K1's and K2's
    launches over both fits and the resumed trainer."""
    cfg = dict(cfg, save_dir=save_dir)
    _zero_launches()
    losses = []
    t0 = time.perf_counter()
    first = Trainer(cfg, dm, kind=kind)
    first.train_step = _recording(first.train_step, losses)
    first.fit()
    ckpts = os.path.join(first.version_dir, "checkpoints")
    names = sorted(os.listdir(ckpts))
    want = sorted(["best", "last", f"epoch=0-step={steps}"])
    check(names == sorted(want + [n + ".meta.json" for n in want]),
          f"train {kind}: checkpoint files {names}")
    check(first.state.step == steps,
          f"train {kind}: {first.state.step} steps in the first epoch")
    second = Trainer(dict(cfg, epochs=2), dm, kind=kind)
    second.train_step = _recording(second.train_step, losses)
    second.fit(resume=os.path.join(ckpts, "last"))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {kern.__name__: kern.launches for kern in kernels.KERNELS}
    check_k3(f"train_{kind}", 2 * steps)
    check(second.state.step == 2 * steps,
          f"train {kind}: the resumed run ended at step {second.state.step}")
    losses = torch.stack(losses).float().cpu()
    check(len(losses) == 2 * steps and bool(torch.isfinite(losses).all()),
          f"train {kind}: losses {losses.tolist()}")
    print(f"train {kind}: fit 1 epoch + resumed fit 1 epoch, {2 * steps} "
          f"steps at batch {dm.batch_size} in {dt:.1f} s host clock (model "
          f"builds, validation and 6 checkpoint writes included); losses "
          f"{float(losses[0]):.4f} ... {float(losses[-1]):.4f}, all finite; "
          f"step continued {steps} -> {second.state.step}; launches "
          f"{launches}, K3 {_k3_counts()}")
    return launches, second


def host_ms(fn, n=10, warmup=3):
    """Milliseconds per call by host clock, synchronized, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def time_step(label, b, step):
    """A train step alone on a batch already on the card (``step(marker=
    None)`` runs one): steady state by host clock (synchronized) after
    warm-up, then one step split by CUDA events, and the peak device
    memory of these steps.  Returns (ms, split)."""
    torch.cuda.reset_peak_memory_stats()
    step_ms = host_ms(step)
    events = [torch.cuda.Event(enable_timing=True)]
    names = []

    def marker(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        names.append(name)

    torch.cuda.synchronize()
    events[0].record()
    step(marker=marker)
    torch.cuda.synchronize()
    split = {name: events[i].elapsed_time(events[i + 1])
             for i, name in enumerate(names)}
    print(f"train {label} step at batch {b}: {step_ms:.2f} ms "
          f"({b * 1e3 / step_ms:.0f} images/s), host clock over 10 steps "
          f"after 3 warm-up steps")
    print(f"train {label} step split (CUDA events, one step): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in split.items()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train {label}: peak device memory {peak:.2f} GiB over these "
          f"steps")
    return step_ms, split


def phase_train_timing(trainer, dm):
    """``time_step`` of the trainer's train step on its first batch."""
    batch = trainer._device_batch(next(iter(dm.train_loader())),
                                  trainer.keys)
    gen = torch.Generator("cuda").manual_seed(1)
    host_gen = torch.Generator().manual_seed(1)
    return time_step(trainer.kind, dm.batch_size,
                     lambda marker=None: trainer.train_step(
                         batch, gen, host_gen, marker=marker))


def _draws_to(draws, device):
    return type(draws)(**{k: v.to(device) if torch.is_tensor(v) else v
                          for k, v in vars(draws).items()})


def _update_gap(a, b) -> float:
    """|update a - update b| / |update b| over all parameters, each
    (state_dict after, state_dict before)."""
    names = [k for k in b[0] if k.endswith(("weight", "bias"))]
    ua = torch.cat([(a[0][k] - a[1][k]).flatten() for k in names])
    ub = torch.cat([(b[0][k] - b[1][k]).flatten() for k in names])
    return float((ua - ub).norm() / ub.norm())


def step_vs_cpu(label, shape, build, run):
    """One fp32 train step (TF32 off) on the card and on the CPU from the
    same seeded weights (``build()``; ``run(model, device) -> loss`` takes
    the step on that device).  For scale, the CPU's step again with every
    weight moved by about one fp32 ulp: at this init the update is
    ill-conditioned (the loss pushes every logit down, so the gradient into
    each train-mode BN is nearly constant per channel and its backward
    subtracts nearly all of it), and the card's rounding differs from the
    CPU's everywhere, not in one ulp once."""
    runs = {}
    for name, device in (("card", "cuda"), ("cpu", "cpu"),
                         ("cpu, weights +-1 ulp", "cpu")):
        model = build()
        if name.endswith("ulp"):
            noise = torch.Generator().manual_seed(5)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + 1.2e-7 * torch.randn(p.shape, generator=noise))
        model = model.to(device)
        start = {k: v.detach().clone().cpu()
                 for k, v in model.state_dict().items()}
        loss = run(model, device)
        runs[name] = (float(loss), ({k: v.detach().cpu() for k, v in
                                     model.state_dict().items()}, start))
    (gl, gsd), (cl, csd) = runs["card"], runs["cpu"]
    check(all(torch.equal(gsd[1][k], csd[1][k]) for k in gsd[1]),
          f"train {label} vs CPU: the seeded weights differ")
    loss_rel = abs(gl - cl) / abs(cl)
    gap = _update_gap(gsd, csd)
    ulp_gap = _update_gap(runs["cpu, weights +-1 ulp"][1], csd)
    stats = max(float((gsd[0][k] - csd[0][k]).abs().max()
                      / csd[0][k].abs().max())
                for k in csd[0] if k.endswith(("running_mean",
                                               "running_var")))
    print(f"train {label} vs CPU, fp32 (TF32 off), images {shape}: loss "
          f"{gl:.6f} card, {cl:.6f} CPU ({loss_rel:.2e} relative); the "
          f"parameters' update {gap:.2e} of its norm apart (the CPU's own "
          f"step with the weights moved by one ulp: {ulp_gap:.2e}); BN "
          f"running statistics {stats:.2e} of the largest value")
    # SBP limits: measured 3.9e-7, 2.35e-2 (one-ulp yardstick 3.3e-3) and
    # 6.0e-5 on an H100; a plain-momentum update would be ~90% apart
    check(loss_rel <= 1e-5 and gap <= 0.1 and stats <= 3e-4,
          f"train {label} vs CPU: the card's step disagrees with the CPU's")


def phase_train_vs_cpu(cfg, kind, batch, make_step, draws):
    """``step_vs_cpu`` of a pose model's train step: the same batch and
    draws (drawn once on the CPU), nesterov SGD with weight decay at a
    constant lr 1e-3."""
    cfg = dict(cfg, precision="fp32")

    def run(model, device):
        opt = optim.get_optimizer("sgd", list(model.parameters()), lr=1e-3,
                                  momentum=0.9, weight_decay=5e-3,
                                  nesterov=True)
        return make_step(model, opt)(
            {k: v.to(device) for k, v in batch.items()},
            draws=_draws_to(draws, device))

    step_vs_cpu(kind, tuple(batch["image"].shape),
                lambda: build_model(cfg, kind).train(), run)


def phase_train_learns(kind, batch, make_step):
    """30 steps on one fixed batch of 32 without augmentation at a
    constant lr 1e-3; the loss must fall below a quarter."""
    cfg = SPM_CFG if kind == "spm" else TRAIN_CFG
    model = build_model(cfg, kind).cuda().train()
    opt = optim.get_optimizer("sgd", list(model.parameters()), lr=1e-3,
                              momentum=0.9, weight_decay=5e-3, nesterov=True)
    step = make_step(model, opt)
    gen = torch.Generator("cuda").manual_seed(3)
    host_gen = torch.Generator().manual_seed(3)
    losses = torch.stack([step(batch, gen, host_gen) for _ in range(30)])
    first, last = float(losses[0]), float(losses[-1])
    print(f"train {kind} learns: fixed batch of {len(batch['image'])}, 30 "
          f"steps: loss {first:.4f} -> {last:.4f}")
    check(bool(torch.isfinite(losses).all()) and last < 0.25 * first,
          f"train {kind} learns: the loss did not fall below a quarter")


def phase_sbp_train(path, batch, rng, tmp):
    """Phase 6: SBP training at full width (see the module docstring)."""
    train_cfg = dict(TRAIN_CFG, val_path=path)
    dm = _MemoryData(
        {"image": rng.randint(0, 256, (512, 256, 192, 3), dtype=np.uint8),
         "joints": np.stack([rng.uniform(0, 192, (512, K)),
                             rng.uniform(0, 256, (512, K))],
                            -1).astype(np.float32),
         "joints_vis": (rng.rand(512, K) > 0.2).astype(np.float32)},
        TRAIN_STEPS * 256, batch, 256)
    launches, trainer = phase_train_fit(
        train_cfg, dm, os.path.join(tmp, "saved"), "sbp", TRAIN_STEPS)
    eval_steps = 2  # one val batch per validation, one validation a fit
    check(launches["sbp_heatmaps_cuda"] == 2 * TRAIN_STEPS + eval_steps,
          f"train: K1 launched {launches['sbp_heatmaps_cuda']} times for "
          f"{2 * TRAIN_STEPS} train and {eval_steps} eval steps")
    check(launches["decode_sbp_cuda"] == eval_steps,
          f"train: K2 launched {launches['decode_sbp_cuda']} times for "
          f"{eval_steps} eval steps")
    phase_train_timing(trainer, dm)
    last = os.path.join(trainer.version_dir, "checkpoints", "last")
    del trainer
    phase_train_vs_cpu(
        train_cfg, "sbp", dm.first(2),
        lambda m, o: make_sbp_steps(m, o, [256, 192], (64, 48), K, 2.0,
                                    0.25)[0],
        sample_augment(torch.Generator().manual_seed(2), 2, (256, 192),
                       clahe_prob=0.5))
    # augmentation off: identity crop (scale 1, ratio w/h), no rotation
    # and no jitter
    augment = {"rotate_prob": 0.0, "jitter_prob": 0.0,
               "scale_range": (1.0, 1.0), "ratio_range": (0.75, 0.75)}
    phase_train_learns(
        "sbp", dm.first(32, "cuda"),
        lambda m, o: make_sbp_steps(m, o, [256, 192], (64, 48), K, 2.0, 0.25,
                                    augment=augment)[0])
    return launches, last


# --------------------------------------------------------------------------
# phase 7: SPM
# --------------------------------------------------------------------------

# configs/spm_coco.yaml, the fields the SPM path reads; validation and
# checkpoints every epoch; CLAHE on the device (the config's host CLAHE
# needs cv2)
SPM_CFG = {
    "model": "single-stage-pose-machines", "dataset_name": "coco-keypoints",
    "input_size": 512, "output_size": 128, "num_keypoints": K, "sigma": 1,
    "conf_threshold": 0.5, "max_persons": 30, "batch_size": 32,
    "precision": "bf16", "seed": 0, "epochs": 1, "save_freq": 1,
    "clahe": "device", "optimizer": "sgd",
    "optimizer_options": {"lr": 1e-3, "momentum": 0.9, "weight_decay": 5e-3,
                          "nesterov": True},
    "scheduler": "yolo_lr",
    "scheduler_options": {"burn_in": 1565, "steps": [50080],
                          "scales": [0.1]},
    "trainer_options": {"check_val_every_n_epoch": 1,
                        "num_sanity_val_steps": 0}}
S_IN, S_OUT, S_B, S_P = 512, 128, 32, 30
SPM_STEPS = 10  # per epoch, at batch 32
SPM_PARAMS = 36_615_584  # SBP's 36,606,368 - 512 * 17 + 512 * 35


def _spm_decode(logits, pred=True, threshold=0.5):
    return decode_ops.decode_spm_batch(logits, S_IN, 1.0, threshold, pred,
                                       S_P)


def _spm_people(rng, n, size=None):
    return spm_people(rng, n, size or S_IN, S_P)


def _spm_eval_set(tmp, n, rng):
    """n seeded images at the input size (image frame == input frame), their
    persons, and a COCO-format annotation file of them."""
    joints, centers = _spm_people(rng, n)
    images, anns = [], []
    for i in range(n):
        images.append({"id": i + 1, "file_name": f"{i + 1:012d}.jpg",
                       "width": S_IN, "height": S_IN})
        for p in np.flatnonzero(centers[i, :, 0].any(-1)):
            present = joints[i, p].any(-1)
            kps = []
            for (x, y), v in zip(joints[i, p], present):
                kps += [float(x), float(y), 2 if v else 0]
            cx, cy = centers[i, p, 0]
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": 1, "iscrowd": 0, "area": 240.0 ** 2,
                         "bbox": [float(cx) - 120, float(cy) - 120, 240.0,
                                  240.0],
                         "keypoints": kps,
                         "num_keypoints": int(present.sum())})
    path = os.path.join(tmp, "person_keypoints_spm_val.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    batch = {
        "image": rng.randint(0, 256, (n, S_IN, S_IN, 3), dtype=np.uint8),
        "joints": joints, "centers": centers,
        "image_id": np.arange(1, n + 1, dtype=np.int64),
        "category_id": np.ones(n, np.int64),
        "image_size": np.full((n, 2), S_IN, np.int64),
    }
    return path, batch


def phase_spm_serve(cfg):
    """7a: three requests through ``load_for_inference`` + the decode, and
    the fp32 forward on the card against the CPU."""
    model, forward = load_for_inference(cfg, None, "spm")
    check(count_params(model) == SPM_PARAMS,
          f"serve spm: {count_params(model)} parameters")
    rng = np.random.RandomState(3)
    for n in (1, 1, S_B):
        images = rng.randint(0, 256, (n, S_IN, S_IN, 3), dtype=np.uint8)
        t0 = time.perf_counter()
        roots, joints = _spm_decode(forward(images))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(roots.shape == (n, S_P, 3) and joints.shape == (n, S_P, K, 3)
              and roots.is_cuda, f"serve spm: roots {tuple(roots.shape)}, "
              f"joints {tuple(joints.shape)} on {roots.device}")
        check(bool(torch.isfinite(roots).all() & torch.isfinite(joints).all()),
              "serve spm: non-finite output")
        print(f"serve spm: batch {n} at {S_IN}x{S_IN}: roots "
              f"{tuple(roots.shape)}, keypoints {tuple(joints.shape)}, "
              f"finite, {int((roots[..., 2] >= 0).sum())} persons found, "
              f"{dt * 1e3:.1f} ms host clock (first call includes set-up)")
    fp32_cross_check(SPM_CFG, "spm", (1, S_IN, S_IN, 3))


def phase_spm_eval(cfg, batch):
    """7b: ``validate(kind="spm")`` on the seeded set, then the eval step
    and the decode alone at B=32 by host clock."""
    model = load_model(cfg, None, kind="spm")
    val_loss, val_map = validate(cfg, _Batches([batch]), model,
                                 verbose=False, kind="spm")
    check(np.isfinite(val_loss) and 0.0 <= val_map <= 1.0,
          f"eval spm: val_loss {val_loss}, AP {val_map}")
    print(f"eval spm: validate on {len(batch['image'])} images: val_loss "
          f"{val_loss:.6f}, AP@.5 {val_map:.4f} (random weights)")
    eval_step = make_spm_eval_step(model, S_IN, S_OUT, K, 1.0, 0.5, S_P)
    dev = {k: torch.from_numpy(batch[k]).cuda()
           for k in ("image", "joints", "centers")}
    eval_ms = host_ms(lambda: eval_step(dev), n=5)
    with torch.inference_mode():
        logits = model(normalize_batch(dev["image"]))
    decode_ms = host_ms(lambda: _spm_decode(logits))
    print(f"eval spm at batch {S_B}: eval step (normalize, targets, "
          f"forward, loss, decode) {eval_ms:.2f} ms, decode_spm_batch alone "
          f"{decode_ms:.2f} ms; host clock, synchronized, after warm-up")


def spm_gt_probe():
    """7c: targets of known persons, 6 an image (fewer on a small map)
    with their roots 20 map px apart, decoded with pred=False: every root
    at floor(center/4)*4 with conf 1, every present joint within 1e-3 px of
    floor(joint/4)*4 (each placed 6-9.5 map px from its root), every absent
    one a zero row."""
    rng = np.random.RandomState(6)
    joints = np.zeros((S_B, S_P, K, 2), np.float32)
    centers = np.zeros((S_B, S_P, 1, 2), np.float32)
    side = np.arange(14, S_OUT - 13, 20)
    cells = np.stack(np.meshgrid(side, side), -1).reshape(-1, 2)
    m = min(6, len(cells))
    for i in range(S_B):
        c = cells[rng.choice(len(cells), m, replace=False)].astype(np.float32)
        centers[i, :m, 0] = c * 4 + rng.uniform(0, 4, (m, 2))
        angle = rng.uniform(0, 2 * np.pi, (m, K))
        radius = rng.uniform(6, 9.5, (m, K))
        j = c[:, None] + radius[..., None] * np.stack([np.cos(angle),
                                                       np.sin(angle)], -1)
        joints[i, :m] = j * 4
        joints[i, :m, :3] = 0.0  # absent
    target = _spm_targets(torch.from_numpy(joints).cuda(),
                          torch.from_numpy(centers).cuda(), S_OUT / S_IN,
                          S_OUT, K, 1.0)
    roots, kps = (t.cpu().numpy() for t in _spm_decode(target, pred=False))
    want_c = np.floor(centers[:, :m, 0] / 4) * 4
    want_j = np.floor(joints[:, :m] / 4) * 4
    err = 0.0
    for i in range(S_B):
        found = np.flatnonzero(roots[i, :, 2] >= 0)
        check(len(found) == m and (roots[i, found, 2] == 1.0).all(),
              f"GT probe spm: image {i}: roots {roots[i, found].tolist()}")
        for p in range(m):
            slot = found[(roots[i, found, :2] == want_c[i, p]).all(-1)]
            check(len(slot) == 1, f"GT probe spm: image {i}: the root at "
                  f"{want_c[i, p].tolist()} was not found exactly")
            got = kps[i, slot[0]]
            check((got[:3] == 0).all(), "GT probe spm: an absent joint came "
                  "back")
            check((got[3:, 2] == 1.0).all(), "GT probe spm: a joint was lost")
            err = max(err, float(np.abs(got[3:, :2] - want_j[i, p, 3:]).max()))
    check(err <= 1e-3, f"GT probe spm: joints {err} px off")
    print(f"GT probe spm: targets -> decode_spm_batch(pred=False) on "
          f"{S_B} images: all {m * S_B} roots exact, {14 * m * S_B} present "
          f"joints within {err:.3g} px, {3 * m * S_B} absent ones zero")


def phase_spm_geometric(dm):
    """One train step with ``augment_geometric`` at 512x512: its time by
    host clock and peak memory, at batch 32 or, if that does not fit, the
    largest power-of-two batch that does (printed)."""
    b = S_B
    while True:
        model = build_model(SPM_CFG, "spm").cuda().train()
        opt = optim.get_optimizer("sgd", list(model.parameters()), lr=1e-3,
                                  momentum=0.9, weight_decay=5e-3,
                                  nesterov=True)
        step, _ = make_spm_steps(model, opt, S_IN, S_OUT, K, 1.0, 0.5,
                                 augment={"geometric": True,
                                          "clahe_prob": 0.5})
        batch = dm.first(b, "cuda")
        gen = torch.Generator("cuda").manual_seed(4)
        host_gen = torch.Generator().manual_seed(4)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            ms = host_ms(lambda: step(batch, gen, host_gen), n=3, warmup=1)
            break
        except torch.cuda.OutOfMemoryError:
            total = torch.cuda.get_device_properties(0).total_memory
            print(f"train spm geometric: batch {b} does not fit in "
                  f"{total / 2 ** 30:.0f} GiB")
            del model, opt, step, batch
            torch.cuda.empty_cache()
            check(b > 1, "train spm geometric: not even batch 1 fits")
            b //= 2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train spm geometric step at batch {b}, {S_IN}x{S_IN}: {ms:.2f} "
          f"ms host clock over 3 steps after 1 warm-up; peak device memory "
          f"{peak:.2f} GiB")


def phase_spm(path, batch, rng, tmp):
    """Phase 7: SPM at full width.  Neither K1 nor K2 may launch in it;
    K3 only in the train steps."""
    cfg = dict(SPM_CFG, val_path=path)
    _zero_launches()
    phase_spm_serve(cfg)
    phase_spm_eval(cfg, batch)
    spm_gt_probe()
    check_k3("serve_eval_spm", 0)
    joints, centers = _spm_people(rng, 64)
    dm = _MemoryData(
        {"image": rng.randint(0, 256, (64, S_IN, S_IN, 3), dtype=np.uint8),
         "joints": joints, "centers": centers},
        SPM_STEPS * S_B, batch, S_B)
    _, trainer = phase_train_fit(cfg, dm, os.path.join(tmp, "saved_spm"),
                                 "spm", SPM_STEPS)
    phase_train_timing(trainer, dm)
    del trainer
    half = S_IN // 2  # the CPU's step at 512x512 would take minutes
    joints, centers = _spm_people(rng, 2, size=half)
    phase_train_vs_cpu(
        cfg, "spm",
        {"image": torch.from_numpy(rng.randint(0, 256, (2, half, half, 3),
                                               dtype=np.uint8)),
         "joints": torch.from_numpy(joints),
         "centers": torch.from_numpy(centers)},
        lambda m, o: make_spm_steps(m, o, half, half // 4, K, 1.0, 0.5)[0],
        sample_photometric(torch.Generator().manual_seed(2), 2,
                           clahe_prob=0.5))
    phase_train_learns(
        "spm", dm.first(S_B, "cuda"),
        lambda m, o: make_spm_steps(m, o, S_IN, S_OUT, K, 1.0, 0.5,
                                    augment={"jitter_prob": 0.0})[0])
    phase_spm_geometric(dm)
    launches = {kern.__name__: kern.launches for kern in kernels.KERNELS}
    print(f"spm launches (phase 7): {launches}")
    check(all(n == 0 for n in launches.values()),
          f"a kernel launched on the SPM path: {launches}")

# --------------------------------------------------------------------------
# phase 8: PIS
# --------------------------------------------------------------------------

PIS_K, PIS_B = 11, 256
PIS_STEPS = 10  # per epoch, at batch 256
# configs/sbp_pis.yaml, the fields the PIS path reads; validation and
# checkpoints every epoch, CLAHE on the device
PIS_CFG = dict(TRAIN_CFG, dataset_name="pis", num_keypoints=PIS_K,
               scheduler_options={"burn_in": 1000, "steps": [20000],
                                  "scales": [0.1]})
BACKBONE = "backbone_features_module."


def _counts():
    return {kern.__name__: kern.launches for kern in kernels.KERNELS}


def _delta(before):
    return {k: n - before[k] for k, n in _counts().items()}


def phase_pis_surgery(cfg, sbp_last, out):
    """8a: ``saving_weights`` of phase 6's SBP ``last``, read as the PIS
    model's ``model_pretrained``: the backbone must equal the donor's, the
    deconvolutions and the 11-channel head must be the PIS model's own
    init."""
    out = saving_weights.main(["--ckpt", sbp_last, "--out", out])
    donor = load_state_dict_file(sbp_last)
    fresh = build_model(cfg, "pis").state_dict()
    warm = Trainer(dict(cfg, model_pretrained=out), None, kind="pis",
                   logging=False).model.state_dict()
    bb = [k for k in warm if k.startswith(BACKBONE)]
    check(len(bb) == 18 * 6 and all(
        torch.equal(warm[k].cpu(), donor[k].cpu()) for k in bb),
        "PIS surgery: the backbone is not the donor's")
    rest = [k for k in warm if not k.startswith(BACKBONE)]
    check(all(torch.equal(warm[k].cpu(), fresh[k]) for k in rest),
          "PIS surgery: a deconvolution or the head is not the fresh init")
    check(not torch.equal(fresh["deconv_1.0.weight"],
                          donor["deconv_1.0.weight"].cpu())
          and warm["sbp_head.0.weight"].shape[0] == PIS_K,
          "PIS surgery: the head or the deconvolutions came from the donor")
    print(f"PIS surgery: saving_weights kept {len(bb)} backbone tensors of "
          f"the SBP model; the PIS Trainer's backbone equals them, its "
          f"deconvolutions and {PIS_K}-channel head are its own")
    return out


def phase_pis_serve(cfg, ckpt):
    """8c: the fused predictor at batch 1, 1 and 64: joints [B, 11, 3],
    one K2 launch a call."""
    predict = load_sbp_predictor(cfg, ckpt)
    rng = np.random.RandomState(8)
    for n in (1, 1, 64):
        images = rng.randint(0, 256, (n, 256, 192, 3), dtype=np.uint8)
        before = _counts()
        t0 = time.perf_counter()
        joints = predict(images)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(joints.shape == (n, PIS_K, 3) and joints.is_cuda and
              bool(torch.isfinite(joints).all()),
              f"serve pis: joints {tuple(joints.shape)}")
        check(_delta(before) == {"sbp_heatmaps_cuda": 0,
                                 "decode_sbp_cuda": 1},
              f"serve pis: launches {_delta(before)} for one request")
        print(f"serve pis: batch {n}: joints {tuple(joints.shape)} finite, "
              f"{dt * 1e3:.1f} ms host clock (first call includes set-up)")


class _LabelledVal:
    """A data module for the behaviour harnesses: ``val_db`` records whose
    image path holds the class two components up, and a val loader of
    seeded crops with their bboxes in the camera frame."""

    def __init__(self, labels, bboxes, rng, batch_size):
        self.val_db = [{"image_path": os.path.join("/pis", lab,
                                                   f"{i:06d}.jpg")}
                       for i, lab in enumerate(labels)]
        self.images = rng.randint(0, 256, (len(labels), 256, 192, 3),
                                  dtype=np.uint8)
        self.bboxes = np.asarray(bboxes, np.float64)
        self.batch_size = batch_size

    def val_loader(self):
        return HostLoader(
            list(range(len(self.val_db))),
            lambda rec, index, epoch: {"image": self.images[rec],
                                       "bbox": self.bboxes[rec]},
            self.batch_size)


def _behaviour_sets(rng, n):
    """Seeded joints labelled by the rules themselves: right wrists about
    the handle line of a 2560x1440 camera (grip / no_grip), and noses over
    shoulder centers tilted by up to 40 degrees or lying within 10 degrees
    of horizontal (normal / fallen); each person's bbox 288x384 around
    them."""
    grip = HandleGrip(HANDLE_ROI)
    wrists = np.stack([rng.uniform(1100, 1700, n), rng.uniform(1000, 1400, n)],
                      -1)
    handle = (["grip" if grip.get_handle_grip_result(w) else "no_grip"
               for w in wrists],
              [[x - 144, y - 192, 288, 384] for x, y in wrists])
    upright = rng.rand(n) < 0.5
    theta = np.where(upright, rng.uniform(-40, 40, n),
                     rng.choice([-1, 1], n) * rng.uniform(80, 100, n))
    rule = FallingDown(NEG_MAX, POS_MIN)
    labels, boxes = [], []
    for t in np.deg2rad(theta):
        center = rng.uniform(300, 900, 2)
        nose = center + 100 * np.array([np.sin(t), -np.cos(t)])
        labels.append("normal" if rule.get_falling_down_result(nose, center)
                      else "fallen")
        boxes.append([center[0] - 144, center[1] - 192, 288, 384])
    return handle, (labels, boxes)


def phase_pis_harness(cfg, ckpt, rng):
    """8e: both behaviour harness functions over 64 labelled samples each,
    once with the joints K2 decodes on the card and once with the plain
    decode of the same logits on the CPU: the confusion counts must be
    equal."""
    _, forward = load_for_inference(cfg, ckpt, "pis")
    logits = []

    def on_card(images):
        out = forward(images)
        logits.append(out.cpu())
        return decode_ops.decode_sbp_fast(out, 192, 0.25, True)

    def on_cpu(images):
        return decode_ops.decode_sbp_batch(logits.pop(0), 192, 0.25, True)

    sets = _behaviour_sets(rng, 64)
    for harness, (labels, boxes) in zip(
            (pis_handle_test_code, pis_falling_down_test_code), sets):
        dm = _LabelledVal(labels, boxes, rng, 32)
        before = _counts()
        card = harness.evaluate(on_card, dm, cfg["input_size"], -2)
        calls = len(logits)
        check(_delta(before) == {"sbp_heatmaps_cuda": 0,
                                 "decode_sbp_cuda": calls},
              f"harness: launches {_delta(before)} for {calls} calls")
        cpu = harness.evaluate(on_cpu, dm, cfg["input_size"], -2)
        name = harness.__name__.rsplit(".", 1)[-1]
        print(f"harness {name}: (TP, TN, FP, FN) {tuple(map(int, card))} "
              f"with K2 on the card, {tuple(map(int, cpu))} with the plain "
              f"decode on the CPU; labels {labels.count(labels[0])} "
              f"'{labels[0]}' of {len(labels)}")
        check(tuple(card) == tuple(cpu) and sum(card) == len(labels),
              f"harness {name}: the card's counts differ from the CPU's")


def phase_pis(sbp_last, rng, tmp):
    """Phase 8: PIS at full width (see the module docstring).  Returns the
    kernels' launches over the phase."""
    _zero_launches()
    path, batch = _eval_set(tmp, B, rng, PIS_K,
                            "pis_person_keypoints_val.json")
    cfg = dict(PIS_CFG, val_path=path)
    cfg["model_pretrained"] = phase_pis_surgery(
        cfg, sbp_last, os.path.join(tmp, "pretrained_weights"))
    check(_counts() == {"sbp_heatmaps_cuda": 0, "decode_sbp_cuda": 0},
          "PIS surgery launched a kernel")
    dm = _MemoryData(
        {"image": rng.randint(0, 256, (512, 256, 192, 3), dtype=np.uint8),
         "joints": np.stack([rng.uniform(0, 192, (512, PIS_K)),
                             rng.uniform(0, 256, (512, PIS_K))],
                            -1).astype(np.float32),
         "joints_vis": (rng.rand(512, PIS_K) > 0.2).astype(np.float32)},
        PIS_STEPS * PIS_B, batch, PIS_B)
    launches, trainer = phase_train_fit(
        cfg, dm, os.path.join(tmp, "saved_pis"), "pis", PIS_STEPS)
    eval_steps = 2  # one val batch per validation, one validation a fit
    check(launches == {"sbp_heatmaps_cuda": 2 * PIS_STEPS + eval_steps,
                       "decode_sbp_cuda": eval_steps},
          f"train pis: launches {launches} for {2 * PIS_STEPS} train and "
          f"{eval_steps} eval steps")
    with open("results.json") as f:
        results = json.load(f)
    check(len(results) == B and all(len(r["keypoints"]) == 51
                                    for r in results),
          "train pis: SBPmAPPIS did not write 51 numbers per result")
    print(f"train pis: validation wrote {len(results)} results of 51 "
          f"numbers (11 joints and 6 zero ones)")
    before = _counts()
    phase_train_timing(trainer, dm)
    check(_delta(before) == {"sbp_heatmaps_cuda": 14, "decode_sbp_cuda": 0},
          f"train pis timing: launches {_delta(before)} for 14 steps")
    last = os.path.join(trainer.version_dir, "checkpoints", "last")
    del trainer
    phase_pis_serve(cfg, last)
    before = _counts()
    gt_probe(batch, cfg, SBPmAPPIS)
    check(_delta(before) == {"sbp_heatmaps_cuda": 1, "decode_sbp_cuda": 1},
          f"GT probe pis: launches {_delta(before)}")
    phase_pis_harness(cfg, last, rng)
    launches = _counts()
    print(f"pis launches (phase 8): {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 9: the darknet19 classifier
# --------------------------------------------------------------------------

# configs/darknet19_classifier.yaml, the fields train_classifier reads;
# validation and checkpoints every epoch
CLS_CFG = {
    "model": "darknet19", "dataset_name": "tiny-imagenet", "input_size": 64,
    "num_classes": 200, "epochs": 1, "check_val_every_n_epoch": 1,
    "batch_size": 256, "precision": "bf16", "seed": 0, "optimizer": "sgd",
    "optimizer_options": {"lr": 0.1, "momentum": 0.9, "weight_decay": 5e-4,
                          "nesterov": True},
    "scheduler": "cosine_annealing_warm_restarts",
    "scheduler_options": {"T_0": 10000, "T_mult": 2, "eta_min": 1e-4}}
CLS_STEPS = 10  # per epoch, at batch 256
CLS_N = 200


class _MemoryClasses:
    """ImageFolder-like data made in memory: ``n_train`` records over 512
    seeded 64x64 images with seeded labels, and 256 val images."""

    def __init__(self, rng, n_train, batch_size):
        self.images = rng.randint(0, 256, (768, 64, 64, 3), dtype=np.uint8)
        self.labels = rng.randint(0, CLS_N, 768).astype(np.int32)
        self.train_db = list(range(n_train))
        self.val_db = list(range(512, 768))
        self.batch_size = batch_size

    def _sample(self, i):
        return {"image": self.images[i], "label": self.labels[i]}

    def train_loader(self):
        return HostLoader(self.train_db,
                          lambda rec, index, epoch: self._sample(rec % 512),
                          self.batch_size, shuffle=True, seed=0,
                          drop_last=True)

    def val_loader(self):
        return HostLoader(self.val_db,
                          lambda rec, index, epoch: self._sample(rec),
                          self.batch_size)

    def first(self, n, device="cpu"):
        return (torch.from_numpy(self.images[:n]).to(device),
                torch.from_numpy(self.labels[:n]).to(device))


def phase_classifier_timing(state, dm):
    """``time_step`` of the classifier's train step at batch 256 on a batch
    already on the card, then its eval step."""
    step, eval_step = train_classifier.make_classifier_steps(
        state.model, state.optimizer, CLS_N)
    images, labels = dm.first(256, "cuda")
    gen = torch.Generator("cuda").manual_seed(1)
    time_step("classifier", 256, lambda marker=None: step(
        images, labels, gen, marker=marker))
    eval_ms = host_ms(lambda: eval_step(images, labels))
    print(f"eval classifier step at batch 256: {eval_ms:.2f} ms host clock")


def phase_classifier_vs_cpu(dm):
    """``step_vs_cpu`` of the classifier's step: the same batch of 8 and
    dropout mask (drawn on the CPU), nesterov SGD at lr 0.1; phase 6b's
    limits."""
    cfg = dict(CLS_CFG, precision="fp32")
    images, labels = dm.first(8)
    mask = sample_dropout_mask(torch.Generator().manual_seed(2),
                               dropout_mask_shape(8, 64, 64))

    def run(model, device):
        opt = optim.get_optimizer("sgd", list(model.parameters()), lr=0.1,
                                  momentum=0.9, weight_decay=5e-4,
                                  nesterov=True)
        step, _ = train_classifier.make_classifier_steps(model, opt, CLS_N)
        return step(images.to(device), labels.to(device),
                    mask=mask.to(device))[0]

    step_vs_cpu("classifier", tuple(images.shape),
                lambda: train_classifier.build_classifier(cfg, CLS_N), run)


def phase_classifier_learns(dm):
    """30 bf16 steps on one fixed batch of 64 at a constant lr 0.01, the
    dropout on: the mean loss of the last 5 steps must be below half that
    of the first 5."""
    model = train_classifier.build_classifier(CLS_CFG, CLS_N).cuda()
    opt = optim.get_optimizer("sgd", list(model.parameters()), lr=0.01,
                              momentum=0.9, weight_decay=5e-4, nesterov=True)
    step, _ = train_classifier.make_classifier_steps(model, opt, CLS_N)
    images, labels = dm.first(64, "cuda")
    gen = torch.Generator("cuda").manual_seed(3)
    losses = torch.stack([step(images, labels, gen)[0] for _ in range(30)])
    losses = losses.float().cpu()
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    print(f"train classifier learns: fixed batch of 64, 30 steps with "
          f"dropout: mean loss of the first 5 {first:.4f}, of the last 5 "
          f"{last:.4f}")
    check(bool(torch.isfinite(losses).all()) and last < 0.5 * first,
          "train classifier learns: the loss did not fall below half")


def phase_classifier(tmp, rng):
    """Phase 9: the darknet19 classifier (see the module docstring).
    Neither K1 nor K2 may launch in it; K3 only in the train steps."""
    _zero_launches()
    dm = _MemoryClasses(rng, CLS_STEPS * 256, 256)
    cfg = dict(CLS_CFG, save_dir=os.path.join(tmp, "saved_cls"))
    t0 = time.perf_counter()
    state = train_classifier.train(cfg, dm)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_k3("train_classifier", CLS_STEPS, CLS_BN_LAYERS)
    ckpts = os.path.join(tmp, "saved_cls", "darknet19_tiny-imagenet",
                         "version_0", "checkpoints")
    names = sorted(os.listdir(ckpts))
    want = sorted(["best", "last", f"epoch=0-step={CLS_STEPS}"])
    check(names == sorted(want + [n + ".meta.json" for n in want]) and
          state.step == CLS_STEPS, f"train classifier: {names}, step "
          f"{state.step}")
    with open(os.path.join(ckpts, "best.meta.json")) as f:
        meta = json.load(f)
    print(f"train classifier: train_classifier.train, {CLS_STEPS} steps at "
          f"batch 256 and a validation in {dt:.1f} s host clock (model "
          f"build and 3 checkpoint writes included); val_loss = 1 - top-1 "
          f"{meta['val_loss']:.4f}")
    phase_classifier_timing(state, dm)
    del state
    last = os.path.join(ckpts, "last")
    src = load_state_dict_file(last)
    phase_classifier_vs_cpu(dm)
    phase_classifier_learns(dm)
    warm = Trainer(dict(TRAIN_CFG, backbone_pretrained=last), None,
                   logging=False).model.state_dict()
    bb = [k for k in warm if k.startswith(BACKBONE)]
    same = sum(torch.equal(warm[k].cpu(), src[
        f"{STAGE_NAMES[int(k.split('.')[1])]}.{k.split('.', 2)[2]}"])
        for k in bb)
    print(f"warm start: an SBP Trainer with backbone_pretrained = the "
          f"classifier's last: {same} of {len(bb)} backbone tensors (18 "
          f"convs, their BN) equal the classifier's")
    check(len(bb) == 18 * 6 and same == len(bb),
          "warm start: the SBP backbone is not the classifier's")
    launches = _counts()
    print(f"classifier launches (phase 9): {launches}")
    check(all(n == 0 for n in launches.values()),
          f"a kernel launched on the classifier path: {launches}")


# --------------------------------------------------------------------------
# phase 10: the device cache and the native loader, from JPEG files
# --------------------------------------------------------------------------

CACHE_TRAIN, CACHE_VAL = 800, 32  # images: about 1,600 and 64 instances
SPM_CACHE_IMAGES = 64
EPOCH_LINE = re.compile(r"epoch (\d+): train_loss=\S+ \(([\d.]+) img/s\)")
SYNTH_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "synth_fixture.py")


def _synth_fixture():
    """This checkout's tests/synth_fixture.py (it imports cv2), loaded by
    its path: the script runs phase 10 from a temporary directory."""
    return _load_path("synth_fixture", SYNTH_FIXTURE)


class _Tee(io.TextIOBase):
    """Standard output, also kept in ``text`` (the Trainer's epoch lines
    carry its img/s)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _fit_printing(trainer, **kwargs):
    """``trainer.fit(**kwargs)``; returns the img/s of each epoch line."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        trainer.fit(**kwargs)
    return [float(m.group(2)) for m in EPOCH_LINE.finditer("".join(tee.text))]


def phase_native_build():
    """10a: build the port's native loader (g++, libjpeg) and say whether
    it built."""
    t0 = time.perf_counter()
    ok = native_loader.available()
    if ok:
        print(f"native loader: built by g++ and loaded in "
              f"{time.perf_counter() - t0:.2f} s")
    else:
        # the error is "...failed:", "$ <the g++ command>", then g++'s text
        lines = native_loader.build_error().strip().splitlines()
        text = [ln for ln in lines[2:] if ln.strip()] or lines
        print(f"native loader: NOT built: {text[0]}")
    return ok


def _sbp_data(root, cfg, use_native=None):
    dm = SBPCOCODataModule(
        cfg["train_path"], cfg["val_path"], cfg["input_size"],
        cfg["output_size"], K, cfg["sigma"], cfg["workers"],
        cfg["batch_size"], cfg["class_labels"], img_dir=root,
        use_native=use_native)
    dm.setup()
    return dm


def phase_cache_build(root, cfg):
    """10b: ``build_device_cache`` of the train set (val semantics), its
    time, bytes and memo; then again with the decoder broken: the memo
    must give the same arrays, on the card."""
    dm = _sbp_data(root, cfg)
    memo = cfg["train_path"] + ".devcache"
    b = cfg["batch_size"]
    t0 = time.perf_counter()
    cache = build_device_cache(dm, b, seed=0, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"cache: {len(dm.train_db)} instances of {CACHE_TRAIN} JPEG "
          f"images decoded ({'native' if dm.use_native else 'cv2'}, "
          f"{dm.workers} threads), stacked and uploaded in {dt:.2f} s; "
          f"{cache.nbytes() / 1e6:.1f} MB on the card, "
          f"{cache.steps_per_epoch} steps an epoch; memo {memo} "
          f"({sorted(os.listdir(memo))})")
    again_dm = _sbp_data(root, cfg)
    again_dm._loader = None  # a decode would raise
    t0 = time.perf_counter()
    again = build_device_cache(again_dm, b, seed=0, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    same = all(torch.equal(cache._data[k], again._data[k])
               for k in cache._data)
    on_card = all(t.is_cuda for c in (cache, again)
                  for t in c._data.values())
    print(f"cache: rebuilt from the memo alone in {dt:.2f} s: arrays equal "
          f"{same}, on the card {on_card}")
    check(same and on_card and cache.n_total == len(dm.train_db) and
          cache.steps_per_epoch == len(dm.train_db) // b,
          "cache: the memo did not give back the decoded arrays on the card")


def phase_cached_fit(root, cfg):
    """10c: ``Trainer.fit`` with ``cache_device: True`` and no ``clahe``
    key, 2 epochs with validation: CLAHE moved to the device, epoch 0's
    batches are the cache's rows at ``epoch_indices(0)``, K1 once per
    train and eval step and K2 once per eval step, finite losses.  Returns
    the launches and the epochs' img/s."""
    dm = _sbp_data(root, cfg)
    _zero_launches()
    trainer = Trainer(cfg, dm)
    check(dm.clahe_prob == 0.0 and trainer.augment.get("clahe_prob") == 0.5,
          f"cached fit: host CLAHE {dm.clahe_prob}, device CLAHE "
          f"{trainer.augment}")
    fed, losses = [], []
    step = trainer.train_step

    def recording(batch, *args, **kwargs):
        fed.append(batch)
        loss = step(batch, *args, **kwargs)
        losses.append(loss)
        return loss

    trainer.train_step = recording
    rates = _fit_printing(trainer)
    launches = _counts()
    cache = trainer._device_cache
    idx = torch.from_numpy(cache.epoch_indices(0).astype(np.int64)).cuda()
    same = all(torch.equal(fed[s][k], cache._data[k].index_select(0, idx[s]))
               for s in range(cache.steps_per_epoch) for k in fed[s])
    losses = torch.stack(losses).float().cpu()
    steps = 2 * cache.steps_per_epoch
    eval_steps = 2  # one val batch of 64 instances per validation
    print(f"cached fit: host CLAHE p={dm.clahe_prob}, device CLAHE "
          f"p={trainer.augment['clahe_prob']}; {len(fed)} steps, epoch 0 "
          f"fed the cache's rows at epoch_indices(0): {same}; losses "
          f"{float(losses[0]):.4f} ... {float(losses[-1]):.4f}; launches "
          f"{launches}; epochs {rates} img/s")
    check(same and len(fed) == steps and len(rates) == 2,
          "cached fit: the fed batches are not the cache's epoch 0 rows")
    check(bool(torch.isfinite(losses).all()), "cached fit: non-finite loss")
    check(launches == {"sbp_heatmaps_cuda": steps + eval_steps,
                       "decode_sbp_cuda": eval_steps},
          f"cached fit: launches {launches} for {steps} train and "
          f"{eval_steps} eval steps")
    return launches, rates


def phase_stream_fit(root, cfg, native_ok):
    """10d: the streaming fit (host loader, the config's host CLAHE), one
    epoch without validation, with cv2 and, when 10a built, the native
    loader, each beside its loader's rate alone (one epoch, no step);
    then the native and cv2 pixels of one val batch.  Returns the
    launches."""
    total = {name: 0 for name in _counts()}
    feeds = [("cv2", False)] + ([("native", True)] if native_ok else [])
    if not native_ok:
        print("stream fit: native arm skipped (10a: the loader did not "
              "build)")
    cfg = dict(cfg, cache_device=False, epochs=1,
               trainer_options={"check_val_every_n_epoch": 10,
                                "num_sanity_val_steps": 0})
    for name, use_native in feeds:
        dm = _sbp_data(root, cfg, use_native)
        t0 = time.perf_counter()
        n = sum(len(b["image"]) for b in dm.train_loader())
        feed = n / (time.perf_counter() - t0)
        before = _counts()
        trainer = Trainer(cfg, dm, logging=False)
        rates = _fit_printing(trainer)
        delta = _delta(before)
        print(f"stream fit ({name}, {dm.workers} threads, host CLAHE "
              f"p={dm.clahe_prob}): {rates} img/s; the loader alone (no "
              f"train step, one epoch) {feed:.1f} img/s; launches {delta}")
        steps = len(dm.train_db) // dm.batch_size
        check(len(rates) == 1 and delta == {"sbp_heatmaps_cuda": steps,
                                            "decode_sbp_cuda": 0},
              f"stream fit ({name}): launches {delta} for {steps} steps")
        for k, n in delta.items():
            total[k] += n
        del trainer
    if native_ok:
        a = next(iter(_sbp_data(root, cfg, True).val_loader()))["image"]
        b = next(iter(_sbp_data(root, cfg, False).val_loader()))["image"]
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        print(f"native vs cv2, one val batch {a.shape}: mean abs "
              f"difference {diff.mean():.4f}, max {int(diff.max())} levels")
        check(diff.mean() < 2.0, "native and cv2 pixels differ by 2 levels "
              "or more on average")
    return total


def phase_spm_cached(tmp, synth):
    """10e: SPM with ``cache_device`` at spm_coco.yaml's widths (512x512,
    batch 32) on 64 JPEG images, one epoch with validation: the memo holds
    image, joints and centers; no launch of K1 or K2."""
    root = os.path.join(tmp, "spm_jpeg")
    train = synth.make_dataset(root, "train2017", SPM_CACHE_IMAGES, seed=12)
    val = synth.make_dataset(root, "val2017", 8, seed=13)
    labels = synth.COCO_KP_NAMES
    cfg = dict(SPM_CFG, train_path=train, val_path=val, img_dir=root,
               workers=8, class_labels=labels, cache_device=True,
               save_dir=os.path.join(tmp, "saved_spm_cache"))
    cfg.pop("clahe")
    dm = SPMCOCODataModule(train, val, root, S_IN, S_OUT, K, 1, 8, S_B,
                           labels, max_persons=S_P)
    dm.setup()
    before = _counts()
    trainer = Trainer(cfg, dm, kind="spm")
    losses = []
    trainer.train_step = _recording(trainer.train_step, losses)
    rates = _fit_printing(trainer)
    delta = _delta(before)
    with open(os.path.join(train + ".devcache", "meta.json")) as f:
        meta = json.load(f)
    cache = trainer._device_cache
    print(f"spm cached fit: {cache.n_total} images, {cache.nbytes() / 1e6:.1f}"
          f" MB on the card, memo keys {meta['keys']}, {len(losses)} steps, "
          f"{rates} img/s, launches {delta}")
    check(meta["keys"] == ["centers", "image", "joints"] and
          all(t.is_cuda for t in cache._data.values()),
          f"spm cached fit: memo {meta}")
    check(len(losses) == SPM_CACHE_IMAGES // S_B and bool(
        torch.isfinite(torch.stack(losses)).all()),
          "spm cached fit: steps or losses")
    check(all(n == 0 for n in delta.values()),
          f"spm cached fit: a kernel launched: {delta}")


def phase_cache(tmp):
    """Phase 10 (see the module docstring).  Returns the launches of K1
    and K2 over the phase."""
    start = time.perf_counter()
    synth = _synth_fixture()
    native_ok = phase_native_build()
    root = os.path.join(tmp, "jpeg")
    t0 = time.perf_counter()
    train = synth.make_dataset(root, "train2017", CACHE_TRAIN, seed=10)
    val = synth.make_dataset(root, "val2017", CACHE_VAL, seed=11)
    print(f"corpus: {CACHE_TRAIN} train and {CACHE_VAL} val JPEG images "
          f"(320x400, 1-3 persons) written in {time.perf_counter() - t0:.1f}"
          f" s")
    cfg = {k: v for k, v in TRAIN_CFG.items() if k != "clahe"}
    cfg.update(train_path=train, val_path=val, img_dir=root, workers=8,
               class_labels=synth.COCO_KP_NAMES, cache_device=True, epochs=2,
               save_dir=os.path.join(tmp, "saved_cache"))
    phase_cache_build(root, cfg)
    launches, cached = phase_cached_fit(root, cfg)
    for k, n in phase_stream_fit(root, cfg, native_ok).items():
        launches[k] += n
    phase_spm_cached(tmp, synth)
    print(f"cache launches (phase 10): {launches}; cached fit epochs "
          f"{cached} img/s; phase 10 took {time.perf_counter() - start:.1f} s")
    return launches, cfg


# --------------------------------------------------------------------------
# phase 11: data parallelism, two ranks on the one card
# --------------------------------------------------------------------------

P_B = 256  # the global batch of 11b and 11c: 128 rows a rank
RANK_TIMEOUT = 600  # seconds a rank waits in one collective
TORCHRUN_ENV = {"MASTER_ADDR": "127.0.0.1", "RANK": "0", "WORLD_SIZE": "1",
                "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak_gib(device):
    if torch.device(device).type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _same_on_ranks(tensors):
    """Whether every rank holds bitwise rank 0's tensors (on the card
    under NCCL, which takes no host tensor)."""
    device = "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"
    flat = torch.cat([t.detach().reshape(-1).double().to(device)
                      for t in tensors])
    ref = flat.clone()
    torch.distributed.broadcast(ref, 0)
    ok = torch.tensor([float(torch.equal(ref, flat))], dtype=torch.float64,
                      device=device)
    torch.distributed.all_reduce(ok, op=torch.distributed.ReduceOp.MIN)
    return bool(ok.item())


def _memory_sbp(rng, n, hw, b):
    """``_MemoryData`` over ``n`` seeded crops of ``hw``, batch ``b``, no
    val set."""
    h, w = hw
    return _MemoryData(
        {"image": rng.randint(0, 256, (n, h, w, 3), dtype=np.uint8),
         "joints": np.stack([rng.uniform(0, w, (n, K)),
                             rng.uniform(0, h, (n, K))],
                            -1).astype(np.float32),
         "joints_vis": (rng.rand(n, K) > 0.2).astype(np.float32)},
        2 * b, {"image": []}, b)


def phase_world1_group(cfg):
    """11a: two steps of ``Trainer.fit`` (``cfg`` at batch 64) without a
    group and then as rank 0 of a one-rank NCCL group joined from
    torchrun's environment: the losses and parameters must be bitwise
    equal; cuDNN deterministic for the pair."""
    cfg = dict(cfg, batch_size=64)
    dm = _memory_sbp(np.random.RandomState(5), 64, cfg["input_size"], 64)
    torch.backends.cudnn.deterministic = True
    runs, backend = [], None
    try:
        for grouped in (False, True):
            if grouped:
                os.environ.update(TORCHRUN_ENV,
                                  MASTER_PORT=str(parallel.mesh.free_port()))
            losses = []
            trainer = Trainer(cfg, dm, logging=False)
            in_group = torch.distributed.is_initialized()
            trainer.train_step = _recording(trainer.train_step, losses)
            trainer.fit()
            runs.append((in_group, torch.stack(losses).cpu(),
                         {k: v.cpu() for k, v in
                          trainer.model.state_dict().items()}))
            del trainer
    finally:
        torch.backends.cudnn.deterministic = False
        if torch.distributed.is_initialized():
            backend = torch.distributed.get_backend()
            torch.distributed.destroy_process_group()
        for k in list(TORCHRUN_ENV) + ["MASTER_PORT"]:
            os.environ.pop(k, None)
    (g0, l0, s0), (g1, l1, s1) = runs
    same = torch.equal(l0, l1) and all(torch.equal(s0[k], s1[k]) for k in s0)
    print(f"11a world 1: without a group (group {g0}) and in a one-rank "
          f"{backend} group joined from torchrun's environment (group {g1})"
          f": losses {l0.tolist()} and {l1.tolist()}; losses and "
          f"parameters bitwise equal: {same}")
    check(not g0 and g1 and backend == "nccl" and same,
          "11a: a one-rank group changed the training")


def _p_step_build(cfg, device):
    """The fp32 SBP of ``cfg`` (TF32 off) on ``device`` and its train step
    (nesterov SGD at lr 1e-3), seeded."""
    cfg = dict(cfg, precision="fp32")
    model = build_model(cfg, "sbp").to(device).train()
    opt = optim.get_optimizer("sgd", list(model.parameters()), lr=1e-3,
                              momentum=0.9, weight_decay=5e-3, nesterov=True)
    step = make_sbp_steps(model, opt, cfg["input_size"],
                          tuple(cfg["output_size"]), K, float(cfg["sigma"]),
                          0.25)[0]
    return model, step


def _p_step(spec, rows):
    """The compared step (the global draws, this process's ``rows`` of the
    global batch); returns (loss, state after, state before, model,
    step, batch)."""
    device = spec["device"]
    model, step = _p_step_build(spec["cfg"], device)
    start = {k: v.detach().cpu().clone() for k, v in
             model.state_dict().items()}
    batch = {k: torch.from_numpy(rows(v)).to(device)
             for k, v in spec["batch"].items()}
    loss = float(step(batch, draws=_draws_to(spec["draws"], device)))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return loss, state, start, model, step, batch


def _rank_step(spec):
    """11b in a rank: the compared step on this rank's rows; rank 0 saves
    it; then 3 timed steps after one warm-up (host clock, synchronized)."""
    device = spec["device"]
    loss, state, start, _, step, batch = _p_step(spec, parallel.local_rows)
    same = _same_on_ranks(list(state.values()))
    if parallel.is_main():
        torch.save((loss, state, start), spec["out"])
    gen = torch.Generator(device).manual_seed(4)
    host_gen = torch.Generator().manual_seed(4)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    step(batch, gen, host_gen)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(3):
        step(batch, gen, host_gen)
    _sync(device)
    ms = (time.perf_counter() - t0) / 3 * 1e3
    split = {}
    if cuda:  # one more step, split by CUDA events at its markers
        events, names = [torch.cuda.Event(enable_timing=True)], []

        def marker(name):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            names.append(name)

        events[0].record()
        step(batch, gen, host_gen, marker=marker)
        torch.cuda.synchronize()
        split = {n: events[i].elapsed_time(events[i + 1])
                 for i, n in enumerate(names)}
    return {"same": same, "ms": ms, "split": split,
            "peak_gib": _peak_gib(device), "rows": len(batch["image"])}


def _cache_rows(cfg, rank, world, epoch):
    """The JAX package's cache order on a ``world``-device mesh, from its
    rule alone (numpy): ``rank``'s instances at each step of ``epoch``,
    and the padded count."""
    memo = cfg["train_path"] + ".devcache"
    n = len(np.load(os.path.join(memo, "joints.npy"), mmap_mode="r"))
    seed = int(cfg.get("seed", 0))
    order = np.random.RandomState(
        (seed * 2654435761 + 97) % (2 ** 32)).permutation(n)
    n_pad = -(-n // world) * world
    order = np.concatenate([order, order[:n_pad - n]])
    n_local, pb = n_pad // world, cfg["batch_size"] // world
    rng = np.random.RandomState((seed * 1000003 + epoch) % (2 ** 32))
    perms = [rng.permutation(n_local) for _ in range(world)]
    shard = order[rank * n_local:(rank + 1) * n_local]
    return [shard[perms[rank][s * pb:(s + 1) * pb]]
            for s in range(n_local // pb)], n_pad


def _capture_metrics(metrics):
    """Keep every metric that ``validate`` builds (rank 0's), so that its
    predictions can be compared, not only its AP."""
    build = trainer_module.build_metric
    trainer_module.build_metric = lambda *a, **kw: (
        metrics.append(build(*a, **kw)), metrics[-1])[1]


def _rank_fit(spec):
    """11c in a rank: the cached fit, 2 epochs, then a new Trainer resumed
    from 'auto' for a third; counts this rank's launches and checkpoint
    writes, keeps the fed batches, each validation's result and rank 0's
    last predictions."""
    cfg, device = spec["cfg"], spec["device"]
    dm = _sbp_data(cfg["img_dir"], cfg)
    writes, vals, fed, metrics = [], [], [], []
    save = checkpoint._save_atomic
    checkpoint._save_atomic = lambda obj, path: (writes.append(path),
                                                 save(obj, path))
    _capture_metrics(metrics)
    _zero_launches()
    t0 = time.perf_counter()
    trainers = [Trainer(cfg, dm, device=device),
                Trainer(dict(cfg, epochs=3), dm, device=device)]
    for tr in trainers:
        step, validate_fn = tr.train_step, tr.validate
        tr.train_step = lambda batch, *a, _s=step, **kw: (
            fed.append(batch), _s(batch, *a, **kw))[1]
        tr.validate = lambda *a, _v=validate_fn, **kw: (
            vals.append(_v(*a, **kw)), vals[-1])[1]
    trainers[0].fit()
    first_steps = len(fed)
    trainers[1].fit(resume="auto")
    _sync(device)
    dt = time.perf_counter() - t0
    launches = _counts()
    cache = trainers[0]._device_cache
    rows, n_pad = _cache_rows(cfg, parallel.rank(), parallel.world_size(), 0)
    memo = cfg["train_path"] + ".devcache"
    arrays = {k: np.load(os.path.join(memo, k + ".npy")) for k in fed[0]}
    epoch0 = all(torch.equal(fed[s][k].cpu(), torch.from_numpy(
        arrays[k][rows[s]])) for s in range(len(rows)) for k in fed[s])
    state = {k: v.detach().cpu() for k, v in
             trainers[1].model.state_dict().items()}
    same = _same_on_ranks(list(state.values()))
    if parallel.is_main():
        torch.save(state, spec["out"])
    return {"launches": launches, "steps": len(fed),
            "first_steps": first_steps,
            "global_step": trainers[1].global_step,
            "steps_per_epoch": cache.steps_per_epoch, "n_pad": n_pad,
            "n_total": cache.n_total, "mb": cache.nbytes() / 1e6,
            "epoch0_rows": epoch0, "epoch0_steps": len(rows),
            "writes": len(writes), "vals": vals, "same": same,
            "predictions": metrics[-1].result_list if metrics else None,
            "seconds": dt, "val_batches": len(dm.val_loader()),
            "peak_gib": _peak_gib(device)}


def _phase11_rank(spec):
    """One rank of 11b and 11c (11d: 11b alone)."""
    out = {"rank": parallel.rank(), "11b": _rank_step(spec["11b"])}
    if "11c" in spec:
        out["11c"] = _rank_fit(spec["11c"])
    return out


def _check_step(label, spec, ranks, one, shared):
    """11b's (or 11d's) ranks against the one-process step."""
    loss1, state1, start1 = one
    loss2, state2, start2 = torch.load(spec["out"], weights_only=True)
    check(all(torch.equal(start1[k], start2[k]) for k in start1),
          f"{label}: the seeded weights differ")
    loss_rel = abs(loss2 - loss1) / abs(loss1)
    gap = _update_gap((state2, start2), (state1, start1))
    stats = max(float((state2[k] - state1[k]).abs().max()
                      / state1[k].abs().max())
                for k in state1 if k.endswith(("running_mean",
                                               "running_var")))
    same = all(r["11b"]["same"] for r in ranks)
    print(f"{label}: {len(ranks)} ranks x {ranks[0]['11b']['rows']} rows vs"
          f" one process at batch {P_B}, fp32 (TF32 off): loss {loss2:.6f} "
          f"vs {loss1:.6f} ({loss_rel:.2e} relative); update {gap:.2e} of "
          f"its norm apart; BN running statistics {stats:.2e} of the "
          f"largest value; ranks' parameters bitwise equal: {same}")
    for r in ranks:
        b = r["11b"]
        split = ", ".join(f"{k} {v:.1f} ms" for k, v in b["split"].items())
        print(f"{label} rank {r['rank']}: train step {b['ms']:.1f} ms at "
              f"{b['rows']} rows ({b['rows'] * 1e3 / b['ms']:.0f} img/s of "
              f"this rank, {shared}), host clock over 3 steps after 1; one "
              f"step by CUDA events: {split}; peak memory "
              f"{b['peak_gib']:.2f} GiB")
    check(loss_rel <= 1e-5 and gap <= 0.1 and stats <= 3e-4 and same,
          f"{label}: the ranks' step disagrees with one process's")


def _check_fit(cfg, ranks, out, device):
    """11c's checks; returns each rank's launches."""
    fits = [r["11c"] for r in ranks]
    f0 = fits[0]
    steps = 3 * f0["steps_per_epoch"]
    evals = 3 * f0["val_batches"]
    want = {"sbp_heatmaps_cuda": steps + evals, "decode_sbp_cuda": evals}
    for r, f in zip(ranks, fits):
        print(f"11c rank {r['rank']}: {f['steps']} train steps "
              f"({f['first_steps']} in the first fit, then resumed to step "
              f"{f['global_step']}), its shard of the {f['n_total']}-instance"
              f" padded cache: {f['mb']:.1f} MB on the card; epoch 0's "
              f"{f['epoch0_steps']} batches are the JAX 2-device order's "
              f"rows: {f['epoch0_rows']}; launches {f['launches']} (want "
              f"{want}); checkpoint writes {f['writes']}; last (val_loss, "
              f"val_mAP) {f['vals'][-1]}; final states bitwise equal: "
              f"{f['same']}; {f['seconds']:.1f} s (Trainers, 3 epochs, "
              f"validations, checkpoints), peak memory {f['peak_gib']:.2f} "
              f"GiB")
        check(f["epoch0_rows"] and f["steps"] == steps and
              f["global_step"] == steps and f["same"] and
              f["n_total"] == f["n_pad"] and f["vals"] == f0["vals"],
              f"11c rank {r['rank']}: the cached fit on 2 ranks failed")
        check(f["launches"] == want,
              f"11c rank {r['rank']}: launches {f['launches']}, want {want}")
    check(f0["writes"] > 0 and all(f["writes"] == 0 for f in fits[1:]),
          f"11c: checkpoint writes per rank {[f['writes'] for f in fits]}")
    check(f0["predictions"] and all(f["predictions"] is None
                                    for f in fits[1:]),
          "11c: rank 0 alone must build the metric")
    dm = _sbp_data(cfg["img_dir"], cfg)
    model = build_model(cfg, "sbp")
    model.load_state_dict(torch.load(out, weights_only=True))
    metrics = []
    build = trainer_module.build_metric
    _capture_metrics(metrics)
    try:
        want_loss, want_map = validate(cfg, dm, model.to(device), device,
                                       verbose=False)
    finally:
        trainer_module.build_metric = build
    loss, ap = f0["vals"][-1]
    moved, score_gap = _prediction_gaps(metrics[0].result_list,
                                        f0["predictions"])
    n = len(f0["predictions"])
    print(f"11c: one-process validate of rank 0's final weights: "
          f"val_loss {want_loss:.8f} val_mAP {want_map:.6f}; 2 ranks: "
          f"{loss:.8f} {ap:.6f}; of the {n} predictions' {n * K} joints "
          f"{moved} decoded elsewhere, scores at most {score_gap:.2e} apart "
          f"(the eval step runs {-(-n // len(fits))} rows a rank against "
          f"{n} in one process: cuDNN's sums may round differently)")
    # the AP of random weights is 0, so the predictions are compared too:
    # a logit 1 ulp off moves a score by ~1e-7 and a joint only at a near
    # tie (ROADMAP Queue 3)
    check(abs(loss - want_loss) <= 1e-6 * abs(want_loss) and
          ap == want_map and score_gap <= 1e-5 and moved <= n * K // 100,
          "11c: the 2-rank validation differs from one process's")
    return [f["launches"] for f in fits]


def _prediction_gaps(want, got):
    """(joints whose (x, y) differ, the largest score difference) between
    two metrics' predictions of the same instances, in order."""
    check(len(want) == len(got) and all(
        (w["image_id"], w["category_id"]) == (g["image_id"],
                                              g["category_id"])
        for w, g in zip(want, got)), "11c: the predictions' instances differ")
    a = np.array([w["keypoints"] for w in want], np.float64).reshape(
        len(want), -1, 3)
    b = np.array([g["keypoints"] for g in got], np.float64).reshape(
        len(got), -1, 3)
    moved = int((a[..., :2] != b[..., :2]).any(-1).sum())
    scores = np.array([[w["score"], g["score"]] for w, g in zip(want, got)])
    return moved, float(np.abs(scores[:, 0] - scores[:, 1]).max(initial=0))


def phase_parallel(tmp, cache_cfg, device="cuda", ranks_on=("cuda:0",
                                                            "cuda:0")):
    """Phase 11 (see the module docstring) on phase 10's JPEG set
    (``cache_cfg``).  Returns each rank's launches in 11c."""
    start = time.perf_counter()
    if torch.device(device).type == "cuda":
        phase_world1_group(TRAIN_CFG)
    h, w = cache_cfg["input_size"]
    rng = np.random.RandomState(11)
    step_spec = {"device": device, "cfg": cache_cfg,
                 "batch": _memory_sbp(rng, P_B, (h, w), P_B).train,
                 "draws": sample_augment(torch.Generator().manual_seed(12),
                                         P_B, (h, w), clahe_prob=0.5),
                 "out": os.path.join(tmp, "p11b.pt")}
    loss, state, begin, *_ = _p_step(step_spec, lambda v: v)
    one = (loss, state, begin)
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    fit_cfg = dict(cache_cfg, precision="fp32", epochs=2,
                   save_dir=os.path.join(tmp, "saved_parallel"))
    spec = {"11b": step_spec,
            "11c": {"device": device, "cfg": fit_cfg,
                    "out": os.path.join(tmp, "p11c.pt")}}
    t0 = time.perf_counter()
    ranks = parallel.launch(
        _phase11_rank, list(ranks_on), "gloo", args=(spec,),
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    print(f"11b-c: 2 ranks on {ranks_on[0]} over gloo, started and run in "
          f"{time.perf_counter() - t0:.1f} s")
    _check_step("11b", step_spec, ranks, one,
                "two ranks sharing one card: not a scaling figure")
    launches = _check_fit(fit_cfg, ranks, spec["11c"]["out"], device)
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= 2:
        spec = {"11b": dict(step_spec, out=os.path.join(tmp, "p11d.pt"))}
        ranks = parallel.launch(
            _phase11_rank, ["cuda:0", "cuda:1"], "nccl", args=(spec,),
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
        _check_step("11d", spec["11b"], ranks, one, "one card a rank")
    else:
        print("11d NCCL across cards: skipped: 1 card")
    print(f"phase 11 took {time.perf_counter() - start:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 12: the port learns
# --------------------------------------------------------------------------

# The JAX test's cap is 20 rounds (convergence.MAX_ROUNDS), but the JAX
# test itself reads AP@.5 0.000 through its 20 rounds on the CPU, and the
# port on the card through 100 (2 ranks): the recipe sits on the
# all-background plateau (a train loss of about 22, the same to 4 decimals
# on every run) until about step 4,300 (one process: round 1,080).  The cap
# leaves room for that; a validation every LEARN_VAL_EVERY rounds (it
# changes nothing in the training) keeps the phase short.
LEARN_ROUNDS = 2500
LEARN_VAL_EVERY = 10


def phase_learns(tmp, device="cuda", max_rounds=LEARN_ROUNDS,
                 val_every=LEARN_VAL_EVERY):
    """Phase 12 (see the module docstring), with the launch counts set to
    0 just before the rounds and read just after.  Returns the
    launches."""
    start = time.perf_counter()
    root = os.path.join(tmp, "conv16")
    convergence.make_sets(root, SYNTH_FIXTURE)
    cfg = convergence.recipe_cfg(root)
    _zero_launches()
    out = io.StringIO()  # the Trainer's 4 epoch lines a round
    try:
        with contextlib.redirect_stdout(out):
            r = convergence.run_rounds(cfg, device, max_rounds,
                                       convergence.AP_THRESHOLD, val_every)
    finally:
        lines = out.getvalue().splitlines()
        print("\n".join(lines[:2] + ["..."] + lines[-12:]))
    launches = _counts()
    shown = list(zip(r["rounds"], r["aps"]))
    print("12: AP@.5 by round: " + ", ".join(
        f"{i} {ap:.3f}" for i, ap in sorted(dict(shown[::10] + shown[-5:])
                                            .items())))
    print(f"12: best AP@.5 {r['best']:.3f}, crossed "
          f"{convergence.AP_THRESHOLD} at round {r['crossed']} of at most "
          f"{max_rounds}, validated every {val_every} ({r['steps']} train "
          f"steps at batch {cfg['batch_size']}, one process on {device}); "
          f"launches {launches}; the rounds took {r['seconds']:.1f} s, "
          f"phase 12 {time.perf_counter() - start:.1f} s")
    check(r["crossed"] is not None and r["best"] >= convergence.AP_THRESHOLD,
          f"12: AP@.5 reached only {r['best']:.3f} in {max_rounds} rounds: "
          f"the port does not learn the recipe")
    evals = len(r["aps"]) * r["val_batches"]
    check(launches == {"sbp_heatmaps_cuda": r["steps"] + evals,
                       "decode_sbp_cuda": evals},
          f"12: launches {launches} for {r['steps']} train and {evals} eval "
          f"steps")
    return launches


# --------------------------------------------------------------------------
# phase 13: SPM at reference scale
# --------------------------------------------------------------------------

REF_EPOCHS = 2  # of configs/spm_synth_ref.yaml's 200
REF_LINES = re.compile(r"^(device cache: .*|epoch \d+: .*)$", re.M)


def _ref_fit(cfg, device):
    """``train_spm.train(cfg)``, its output captured; returns (state, the
    output, each validation's exact (val_loss, val_mAP), each
    validation's seconds, the fit's seconds)."""
    vals, val_s = [], []
    inner = trainer_module.validate

    def recording(*args, **kwargs):
        t0 = time.perf_counter()
        vals.append(inner(*args, **kwargs))
        val_s.append(time.perf_counter() - t0)
        return vals[-1]

    out = io.StringIO()
    trainer_module.validate = recording
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            state = train_spm.train(cfg, device=device)
        _sync(device)
    finally:
        trainer_module.validate = inner
    return state, out.getvalue(), vals, val_s, time.perf_counter() - t0


def _memo_only_data(cfg):
    """The recipe's SPM data module (as ``train_spm.train`` makes it) with
    its loader broken: a decode would raise."""
    dm = SPMCOCODataModule(
        cfg["train_path"], cfg["val_path"], cfg["img_dir"],
        cfg["input_size"], cfg["output_size"], K, cfg["sigma"],
        cfg["workers"], cfg["batch_size"], cfg["class_labels"],
        max_persons=cfg["max_persons"])
    dm.setup()
    dm._loader = None
    return dm


def phase_spm_ref(tmp, device="cuda"):
    """Phase 13 (see the module docstring).  Returns the launches of K1 and
    K2 over the fit."""
    start = time.perf_counter()
    root = os.path.join(tmp, "spm_ref")
    t0 = time.perf_counter()
    corpus = spm_ref.make_corpus(root, SYNTH_FIXTURE)
    print("13: corpus " + "; ".join(
        f"{split} {n:,} images, {inst:,} instances"
        for split, (_, n, inst) in corpus.items()) +
        f" (the recipe's counts), written in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = dict(spm_ref.SPM_SYNTH_REF, train_path=corpus["train2017"][0],
               val_path=corpus["val2017"][0], img_dir=root,
               epochs=REF_EPOCHS, save_dir=os.path.join(tmp, "saved_ref"),
               trainer_options={"check_val_every_n_epoch": 1,
                                "num_sanity_val_steps": 0})
    n_train, n_val = corpus["train2017"][1], corpus["val2017"][1]
    spe = n_train // cfg["batch_size"]
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    state, text, vals, val_s, dt = _ref_fit(cfg, device)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if device == "cuda" else float("nan")
    lines = REF_LINES.findall(text)
    print("\n".join(f"13: {ln}" for ln in lines))
    cache_line = next((ln for ln in lines if ln.startswith("device cache")),
                      "")
    rates = [float(m.group(2)) for m in EPOCH_LINE.finditer(text)]
    losses = [float(v) for v in re.findall(
        r"^epoch \d+: train_loss=(\S+)", text, re.M)]
    print(f"13: train_spm.train, {REF_EPOCHS} epochs ({state.step} steps at "
          f"batch {cfg['batch_size']}, {cfg['input_size']}x"
          f"{cfg['input_size']}, augment_geometric) with {len(vals)} "
          f"validations of {n_val} images in {dt:.1f} s host clock (cache "
          f"build, model build and checkpoints included); epochs {rates} "
          f"img/s; validations {[round(v, 2) for v in val_s]} s (JPEG "
          f"decode, eval steps, peak NMS, OKS metric); peak device memory "
          f"{peak:.2f} GiB; launches {launches}")
    check(f"device cache: {n_train} instances" in cache_line and
          f"{spe} steps/epoch" in cache_line,
          f"13: the cache line {cache_line!r}: want {n_train} rows, {spe} "
          f"steps an epoch")
    check(state.step == REF_EPOCHS * spe and len(rates) == REF_EPOCHS,
          f"13: {state.step} steps, {len(rates)} epoch lines")
    check(len(losses) == REF_EPOCHS and all(np.isfinite(losses)) and
          len(vals) == REF_EPOCHS and all(np.isfinite(v[0]) for v in vals),
          f"13: losses {losses}, validations {vals}")
    check(vals[-1][0] < vals[0][0],
          f"13: val_loss did not fall: {[v[0] for v in vals]}")
    check(all(n == 0 for n in launches.values()),
          f"13: a kernel launched on the SPM path: {launches}")

    last = os.path.join(cfg["save_dir"],
                        "single-stage-pose-machines_spm-synth-ref",
                        "version_0", "checkpoints", "last")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        got = test_spm.test(cfg, last, device)
    want = vals[-1]
    print(f"13: test_spm.test of last: val_loss={got[0]:.6f} "
          f"val_mAP={got[1]:.6f}; epoch {REF_EPOCHS - 1}'s validation "
          f"val_loss={want[0]:.6f} val_mAP={want[1]:.6f} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(abs(got[0] - want[0]) <= 1e-4 and got[1] == want[1],
          f"13: test_spm of last {got} is not epoch {REF_EPOCHS - 1}'s "
          f"validation {want}")

    t0 = time.perf_counter()
    cache = build_device_cache(_memo_only_data(cfg),
                               cfg["batch_size"],
                               keys=("image", "joints", "centers"),
                               device=device)
    _sync(device)
    print(f"13: cache re-read from the memo alone in "
          f"{time.perf_counter() - t0:.2f} s: {cache.n_total} rows, "
          f"{cache.nbytes() / 2 ** 30:.2f} GiB ({cache.nbytes():,} bytes) "
          f"on {device}")
    check(cache.n_total == n_train and all(
        t.device.type == torch.device(device).type
        for t in cache._data.values()), "13: the memo's rows")

    if device == "cuda":
        step, _ = make_spm_steps(state.model, state.optimizer,
                                 cfg["input_size"], cfg["output_size"], K,
                                 float(cfg["sigma"]), cfg["conf_threshold"],
                                 augment={"geometric": True,
                                          "clahe_prob": 0.5},
                                 max_persons=cfg["max_persons"])
        batch = next(iter(cache.epoch_batches(0)))
        gen = torch.Generator(device).manual_seed(13)
        host_gen = torch.Generator().manual_seed(13)
        del cache
        time_step("spm ref (augment_geometric, cached batch)",
                  cfg["batch_size"], lambda marker=None: step(
                      batch, gen, host_gen, marker=marker))
    print(f"phase 13 took {time.perf_counter() - start:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 14: height-sharded inference
# --------------------------------------------------------------------------

SPATIAL_RANKS = ("cuda:0", "cuda:0")
SPATIAL_RTOL, SPATIAL_ATOL = 2e-4, 2e-5  # tests/test_parallel.py's
TIE = 1e-5  # top-two sigmoid gap under which fp32 noise may flip argmax
SPATIAL_REPS = 10


def _calibrated_ckpt(cfg, kind, path, device):
    """Seeded weights whose BN running statistics are the batch statistics
    of 16 seeded images and whose head is scaled so that the logits lie
    within +-1 on them (at the init's statistics they shrink to ~1e-5),
    saved to ``path``."""
    model = build_model(dict(cfg, precision="fp32"), kind).to(device)
    size = cfg["input_size"]
    h, w = (size, size) if kind == "spm" else size
    images = np.random.RandomState(14).randint(0, 256, (16, h, w, 3),
                                               dtype=np.uint8)
    x = trainer_module._images(images, device)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for m in bns:
            m.momentum = 1.0
        model.train()(x)
        for m in bns:
            m.momentum = 0.1
        getattr(model, f"{kind}_head")[0].weight /= \
            model.eval()(x).abs().max()
    torch.save(model.state_dict(), path)
    return path


def _spatial_case(case, device):
    """One model's sharded forward in a rank: the gathered logits, the
    forward's ms (host clock, synchronized, over ``SPATIAL_REPS`` after
    one) and one forward's exchange statistics."""
    model = load_model(case["cfg"], case["ckpt"], device, case["kind"])
    x = trainer_module._images(case["images"], device)
    with torch.no_grad():
        rows = parallel.spatial_rows(x)
        parallel.spatial_forward(model, rows)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(SPATIAL_REPS):
            parallel.spatial_forward(model, rows)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3 / SPATIAL_REPS
        stats = {}
        logits = parallel.gather_spatial(
            parallel.spatial_forward(model, rows, stats))
    return {"logits": logits.cpu(), "ms": ms, "stats": stats,
            "rows": tuple(rows.shape)}


def _phase14_rank(spec):
    return {"rank": parallel.rank(),
            **{name: _spatial_case(case, spec["device"])
               for name, case in spec["cases"].items()}}


def _one_process(case, device):
    """The one-process ``load_for_inference`` logits and forward ms."""
    _, forward = load_for_inference(case["cfg"], case["ckpt"], case["kind"],
                                    device)
    logits = forward(case["images"])
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(SPATIAL_REPS):
        forward(case["images"])
    _sync(device)
    return logits, (time.perf_counter() - t0) * 1e3 / SPATIAL_REPS


def _logit_tol(want):
    """The logit tolerance at the largest logit: what it lets a sigmoid or
    tanh of a logit move, times their largest slope."""
    return SPATIAL_ATOL + SPATIAL_RTOL * float(want.abs().max())


def _logit_gap(label, got, want, gate=True):
    diff = (got - want).abs()
    scale = float(want.abs().max())
    bad = int((diff > SPATIAL_ATOL + SPATIAL_RTOL * want.abs()).sum())
    print(f"{label}: gathered logits {tuple(got.shape)} vs one process: max "
          f"|logit| {scale:.4g}, max diff {float(diff.max()):.3g} "
          f"({float(diff.max()) / scale:.3g} of the largest logit); "
          f"{bad} of {want.numel()} outside rtol {SPATIAL_RTOL} atol "
          f"{SPATIAL_ATOL}")
    if gate:
        check(bool(torch.isfinite(got).all()) and bad == 0,
              f"{label}: the gathered logits differ from one process's")
    return float(diff.max()) / scale


def _near_ties(logits):
    """Per (image, channel): whether its top two sigmoid values lie within
    ``TIE``."""
    top = torch.sigmoid(logits.flatten(2)).topk(2, dim=2).values
    return (top[..., 0] - top[..., 1]) < TIE


def _print_ranks(label, ranks, name, shared):
    for r in ranks:
        c = r[name]
        st = c["stats"]
        print(f"{label} rank {r['rank']}: rows {c['rows']}, sharded forward "
              f"{c['ms']:.2f} ms ({shared}); one forward: "
              f"{st['exchanges']} exchanges in "
              f"{st['exchange_s'] * 1e3:.2f} ms, {st['halo_bytes']:,} halo "
              f"bytes sent ({st['halo_bytes'] // 2:,} per boundary and "
              f"direction)")


def _check_sbp_decode(label, logits, ckpt_cfg, images, device):
    """K2 on the gathered logits against the one-process predictor's
    joints; returns (channels that differ, near ties among them)."""
    predict = load_sbp_predictor(ckpt_cfg["cfg"], ckpt_cfg["ckpt"], device)
    want = predict(images)
    before = kernels.decode_sbp_cuda.launches
    got = decode_ops.decode_sbp_fast(logits.to(device),
                                     int(ckpt_cfg["cfg"]["input_size"][1]),
                                     float(ckpt_cfg["cfg"]["conf_threshold"]),
                                     True)
    _sync(device)
    check(kernels.decode_sbp_cuda.launches == before + 1,
          f"{label}: K2 did not decode the gathered logits")
    moved = (got[..., :2] != want[..., :2]).any(-1).cpu()
    conf_gap = float((got[..., 2] - want[..., 2]).abs().max())
    ties = _near_ties(logits)
    n_ties = int(ties.sum())
    print(f"{label}: K2 on the gathered logits: {int(moved.sum())} of "
          f"{moved.numel()} joints at another pixel than the one-process "
          f"predictor's, {n_ties} channels are near ties (top two sigmoid "
          f"values within {TIE}); confidences at most {conf_gap:.3g} apart")
    check(bool((~moved | ties).all()) and
          conf_gap <= 0.25 * _logit_tol(logits),
          f"{label}: a joint that is not a near tie decoded elsewhere")
    return int(moved.sum()), n_ties


def phase_spatial(tmp, device="cuda", ranks_on=SPATIAL_RANKS, sbp_cfg=CFG,
                  spm_cfg=SPM_CFG):
    """Phase 14 (see the module docstring).  Returns the kernels'
    launches over the phase."""
    start = time.perf_counter()
    _zero_launches()
    bf16_cfg = dict(sbp_cfg, precision="bf16")
    sbp_cfg = dict(sbp_cfg, precision="fp32")
    spm_cfg = dict(spm_cfg, precision="fp32")
    s_in, width = spm_cfg["input_size"], int(sbp_cfg["input_size"][1])
    rng = np.random.RandomState(140)
    cases = {
        "sbp": {"cfg": sbp_cfg, "kind": "sbp",
                "ckpt": _calibrated_ckpt(sbp_cfg, "sbp", os.path.join(
                    tmp, "p14_sbp.pt"), device),
                "images": rng.randint(0, 256, (1, *sbp_cfg["input_size"], 3),
                                      np.uint8)},
        "spm": {"cfg": spm_cfg, "kind": "spm",
                "ckpt": _calibrated_ckpt(spm_cfg, "spm", os.path.join(
                    tmp, "p14_spm.pt"), device),
                "images": rng.randint(0, 256, (1, s_in, s_in, 3),
                                      np.uint8)}}
    cases["sbp_bf16"] = dict(cases["sbp"], cfg=bf16_cfg)
    one = {name: _one_process(case, device) for name, case in cases.items()}
    for name, (logits, ms) in one.items():
        print(f"14: one-process {name} forward at batch 1: {ms:.2f} ms host "
              f"clock over {SPATIAL_REPS} after one")
    t0 = time.perf_counter()
    ranks = parallel.launch(
        _phase14_rank, list(ranks_on), "gloo",
        args=({"device": device, "cases": cases},),
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    shared = "two ranks sharing one card: not a scaling figure"
    print(f"14: {len(ranks)} ranks on {ranks_on[0]} over gloo, started and "
          f"run in {time.perf_counter() - t0:.1f} s")

    # 14a
    _print_ranks("14a", ranks, "sbp", shared)
    logits = ranks[0]["sbp"]["logits"]
    check(all(torch.equal(r["sbp"]["logits"], logits) for r in ranks),
          "14a: the ranks' gathered logits differ")
    check(ranks[0]["sbp"]["stats"]["exchanges"] == 15,
          f"14a: {ranks[0]['sbp']['stats']['exchanges']} exchanges, want 15")
    _logit_gap("14a sbp fp32", logits, one["sbp"][0].cpu())
    _check_sbp_decode("14a", logits, cases["sbp"], cases["sbp"]["images"],
                      device)

    # 14b
    _print_ranks("14b", ranks, "spm", shared)
    logits = ranks[0]["spm"]["logits"]
    _logit_gap("14b spm fp32", logits, one["spm"][0].cpu())
    roots, joints = decode_ops.decode_spm_batch(
        logits.to(device), s_in, 1.0, spm_cfg["conf_threshold"], True, S_P)
    want_roots, want_joints = decode_ops.decode_spm_batch(
        one["spm"][0], s_in, 1.0, spm_cfg["conf_threshold"], True, S_P)
    found = want_roots[..., 2] >= 0
    same = torch.equal(roots[..., :2], want_roots[..., :2])
    score_gap = float((roots[..., 2] - want_roots[..., 2]).abs().max())
    joint_gap = float((joints - want_joints)[..., :2].abs().max())
    # a joint is root + tanh(logit) * sqrt(2) S map pixels, times s_in / S
    tol = _logit_tol(one["spm"][0])
    px = float(np.sqrt(2.0)) * s_in * tol
    print(f"14b: decode_spm_batch of the gathered logits: "
          f"{int(found.sum())} persons found, roots at the one-process "
          f"decode's pixels: {same}, their scores at most {score_gap:.3g} "
          f"apart; joints at most {joint_gap:.3g} px apart (the logit "
          f"tolerance allows {px:.3g})")
    check(int(found.sum()) > 0 and same and score_gap <= 0.25 * tol and
          joint_gap <= px, "14b: the SPM decode differs from one process's")

    # 14c
    _print_ranks("14c", ranks, "sbp_bf16", shared)
    logits = ranks[0]["sbp_bf16"]["logits"]
    rel = _logit_gap("14c sbp bf16 (a figure, not a gate)", logits,
                     one["sbp_bf16"][0].cpu(), gate=False)
    got = decode_ops.decode_sbp_fast(logits.to(device), width,
                                     bf16_cfg["conf_threshold"], True)
    want = decode_ops.decode_sbp_fast(one["sbp_bf16"][0], width,
                                      bf16_cfg["conf_threshold"], True)
    agree = float((got[..., :2] == want[..., :2]).all(-1).float().mean())
    print(f"14c: bf16: largest logit gap {rel:.3g} of the largest logit; "
          f"{agree:.1%} of K2's joints agree with one process's")

    # 14d
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= 2:
        ranks = parallel.launch(
            _phase14_rank, ["cuda:0", "cuda:1"], "nccl",
            args=({"device": device, "cases": {"sbp": cases["sbp"]}},),
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
        _print_ranks("14d", ranks, "sbp", "one card a rank")
        _logit_gap("14d sbp fp32 over NCCL", ranks[0]["sbp"]["logits"],
                   one["sbp"][0].cpu())
        _check_sbp_decode("14d", ranks[0]["sbp"]["logits"], cases["sbp"],
                          cases["sbp"]["images"], device)
    else:
        print("14d NCCL across cards: skipped: 1 card")
    launches = _counts()
    print(f"14: launches {launches}; phase 14 took "
          f"{time.perf_counter() - start:.1f} s")
    check(launches["decode_sbp_cuda"] > 0,
          "14: K2 never launched in phase 14")
    return launches


# --------------------------------------------------------------------------
# phase 15: the spm_synth_hard recipe
# --------------------------------------------------------------------------

HARD_EPOCHS = 2  # of configs/spm_synth_hard.yaml's 250
HARD_IMAGES = {"train2017": 64, "val2017": 16}  # of 256 and 48
# yolo_lr's burn-in rescaled to the phase's 4 steps as the recipe's is to
# its 2,000 (300: 15%, so 1).  With 300 the lr stays under 1e-10 in 4
# steps: no loss can fall (on the H100 the train loss went 349.76 to
# 355.49, val_loss 107.85 to 109.27, moved by BN's running statistics
# alone).  At full lr the train loss falls, while val_loss first rises
# tenfold, as in the recipe's own run (218 at epoch 4, 441 at 14, 21 at
# 29) and in the JAX package's run of this phase's fit on the CPU
# (tests/spm_hard_witness.py): the phase holds the train loss
HARD_BURN_IN = 1


def hard_config(tmp):
    """Phase 15's corpus under ``tmp`` and its config; returns (config,
    split -> (images, instances, fewest and most persons an image))."""
    root = os.path.join(tmp, "spm_hard")
    make_dataset = spm_ref.load_fixture(SYNTH_FIXTURE).make_dataset
    paths, counts = {}, {}
    for split, n in HARD_IMAGES.items():
        seed = spm_ref.HARD_SPLITS[split][1]
        paths[split] = make_dataset(root, split, n, seed=seed,
                                    **spm_ref.HARD_CORPUS)
        with open(paths[split]) as f:
            db = json.load(f)
        per_image = np.bincount([a["image_id"] for a in db["annotations"]])
        counts[split] = (len(db["images"]), len(db["annotations"]),
                         int(per_image[1:].min()), int(per_image.max()))
    cfg = dict(spm_ref.SPM_SYNTH_HARD, train_path=paths["train2017"],
               val_path=paths["val2017"], img_dir=root, epochs=HARD_EPOCHS,
               save_dir=os.path.join(tmp, "saved_hard"),
               trainer_options={"check_val_every_n_epoch": 1,
                                "num_sanity_val_steps": 0},
               scheduler_options=dict(
                   spm_ref.SPM_SYNTH_HARD["scheduler_options"],
                   burn_in=HARD_BURN_IN))
    return cfg, counts


def phase_spm_hard(tmp, device="cuda"):
    """Phase 15 (see the module docstring).  Returns the launches of K1 and
    K2 over the fit."""
    start = time.perf_counter()
    cfg, counts = hard_config(tmp)
    print("15: corpus " + "; ".join(
        f"{split} {n} images, {inst} instances, {lo}-{hi} an image"
        for split, (n, inst, lo, hi) in counts.items()))
    check(all(c[0] == HARD_IMAGES[s] and c[2] >= 5 and c[3] <= 8
              for s, c in counts.items()), f"15: the corpus {counts}")
    spe = HARD_IMAGES["train2017"] // cfg["batch_size"]
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    state, text, vals, val_s, dt = _ref_fit(cfg, device)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if device == "cuda" else float("nan")
    print("\n".join(f"15: {ln}" for ln in REF_LINES.findall(text)))
    rates = [float(m.group(2)) for m in EPOCH_LINE.finditer(text)]
    losses = [float(v) for v in re.findall(
        r"^epoch \d+: train_loss=(\S+)", text, re.M)]
    print(f"15: train_spm.train, {HARD_EPOCHS} epochs ({state.step} steps at "
          f"batch {cfg['batch_size']}, {cfg['input_size']}x"
          f"{cfg['input_size']}, augment_geometric, cache_images) with "
          f"{len(vals)} validations of {HARD_IMAGES['val2017']} images in "
          f"{dt:.1f} s host clock; epochs {rates} img/s; validations "
          f"{[round(v, 2) for v in val_s]} s; val_loss "
          f"{[round(v[0], 4) for v in vals]}; peak device memory "
          f"{peak:.2f} GiB; launches {launches}")
    check(state.step == HARD_EPOCHS * spe and len(rates) == HARD_EPOCHS,
          f"15: {state.step} steps, {len(rates)} epoch lines")
    check(len(losses) == HARD_EPOCHS and all(np.isfinite(losses)) and
          len(vals) == HARD_EPOCHS and all(np.isfinite(v[0]) for v in vals),
          f"15: losses {losses}, validations {vals}")
    check(losses[-1] < losses[0],
          f"15: the train loss did not fall: {losses}")
    check(all(n == 0 for n in launches.values()),
          f"15: a kernel launched on the SPM path: {launches}")

    last = os.path.join(cfg["save_dir"],
                        "single-stage-pose-machines_spm-synth-hard",
                        "version_0", "checkpoints", "last")
    with contextlib.redirect_stdout(io.StringIO()):
        got = test_spm.test(cfg, last, device)
    want = vals[-1]
    print(f"15: test_spm.test of last: val_loss={got[0]:.6f} "
          f"val_mAP={got[1]:.6f}; epoch {HARD_EPOCHS - 1}'s validation "
          f"val_loss={want[0]:.6f} val_mAP={want[1]:.6f}")
    check(abs(got[0] - want[0]) <= 1e-4 and got[1] == want[1],
          f"15: test_spm of last {got} is not epoch {HARD_EPOCHS - 1}'s "
          f"validation {want}")

    if device == "cuda":
        dm = SPMCOCODataModule(
            cfg["train_path"], cfg["val_path"], cfg["img_dir"],
            cfg["input_size"], cfg["output_size"], K, cfg["sigma"],
            cfg["workers"], cfg["batch_size"], cfg["class_labels"],
            max_persons=cfg["max_persons"])
        dm.setup()
        host_batch = next(iter(dm.train_loader()))
        batch = {k: trainer_module.to_device(host_batch[k],
                                             torch.device(device))
                 for k in trainer_module._KEYS["spm"]}
        step, _ = make_spm_steps(state.model, state.optimizer,
                                 cfg["input_size"], cfg["output_size"], K,
                                 float(cfg["sigma"]), cfg["conf_threshold"],
                                 augment={"geometric": True},
                                 max_persons=cfg["max_persons"])
        gen = torch.Generator(device).manual_seed(15)
        host_gen = torch.Generator().manual_seed(15)
        time_step("spm hard (augment_geometric, 256x256)",
                  cfg["batch_size"], lambda marker=None: step(
                      batch, gen, host_gen, marker=marker))
    print(f"phase 15 took {time.perf_counter() - start:.1f} s")
    return launches


IMAGE_B = 64  # phase 16's batch for affine_warp and rotate_shear3
IMAGE_AFFINE = dict(rotate_limit=40.0, scale_range=(0.4, 1.0),
                    ratio_range=(0.4, 1.6))
IMAGE_TOL = 1e-5


def _gap(card, cpu) -> float:
    return float((card.cpu().double() - cpu.double()).abs().max())


def phase_image_ops(tmp, device="cuda"):
    """Phase 16 (see the module docstring).  Returns the launches of K1 and
    K2 over the save_params round trip."""
    start = time.perf_counter()
    h, w = CFG["input_size"]
    gen = torch.Generator().manual_seed(16)
    imgs = torch.rand(IMAGE_B, 3, h, w, generator=gen)
    draws = [image_ops.sample_train_affine(gen, (h, w), **IMAGE_AFFINE)
             for _ in range(IMAGE_B)]

    def on(d, dev):
        return image_ops.TrainAffineDraws(
            **{k: v.to(dev) for k, v in vars(d).items()})

    def cores(dev):
        return torch.stack([image_ops.train_affine_core(on(d, dev), (h, w))
                            for d in draws])

    def warp(x, inv):
        return torch.stack([image_ops.affine_warp(x[i], inv[i], (h, w))
                            for i in range(len(x))])

    angle = draws[0].angle * math.pi / 180.0

    def rotate(x):
        return image_ops.rotate_shear3(x, angle.to(x.device), h / 2.0,
                                       w / 2.0)

    def jitter(x):
        return image_ops.color_jitter(torch.Generator().manual_seed(161), x)

    cpu_m = cores("cpu")
    inv = torch.stack([image_ops._invert(m) for m in cpu_m])
    x, inv_d = imgs.to(device), inv.to(device)
    results = {
        f"sample_train_affine's core, {IMAGE_B} matrices": (
            cores(device), cpu_m, float(cpu_m.abs().max()),
            lambda: cores(device)),
        f"affine_warp, {IMAGE_B} images {h}x{w}": (
            warp(x, inv_d), warp(imgs, inv), 1.0, lambda: warp(x, inv_d)),
        f"rotate_shear3, batch {IMAGE_B} {h}x{w}": (
            rotate(x), rotate(imgs), 1.0, lambda: rotate(x)),
        f"color_jitter, one {h}x{w} image": (
            jitter(x[0]), jitter(imgs[0]), 1.0, lambda: jitter(x[0])),
    }
    for label, (card, cpu, scale, fn) in results.items():
        gap = _gap(card, cpu) / scale
        ms = device_ms(fn, iters=10) if device == "cuda" else float("nan")
        print(f"16: {label}: card vs CPU largest gap {gap:.3g}"
              f"{' of the largest entry' if scale != 1.0 else ''}; "
              f"{ms:.3f} ms on the card (CUDA events)")
        check(card.shape == cpu.shape and bool(torch.isfinite(card).all())
              and gap <= IMAGE_TOL,
              f"16: {label}: card vs CPU gap {gap} > {IMAGE_TOL}")

    _zero_launches()
    model = load_model(CFG, None, device)
    want = model.state_dict()
    path = checkpoint.save_params(os.path.join(tmp, "sbp_params.pt"), want)
    restored = checkpoint.restore_params(path)
    check(list(restored) == list(want) and all(
        torch.equal(restored[k], v.cpu()) for k, v in want.items()),
        "16: restore_params did not give back the saved state_dict")
    images = np.random.RandomState(16).randint(0, 256, (IMAGE_B, h, w, 3),
                                                dtype=np.uint8)
    with torch.inference_mode():
        before = decode_ops.decode_sbp_fast(
            model(normalize_batch(torch.as_tensor(images, device=device))),
            w, float(CFG["conf_threshold"]), True)
    after = load_sbp_predictor(CFG, path, device)(images)
    launches = _counts()
    print(f"16: save_params -> restore_params of the full-width SBP "
          f"({len(want)} tensors, {os.path.getsize(path) / 2 ** 20:.1f} "
          f"MiB): bitwise equal; the predictor's joints [{IMAGE_B}, {K}, 3] "
          f"from the file equal the saved model's: "
          f"{bool(torch.equal(before, after))}; launches {launches}")
    check(torch.equal(before, after), "16: the predictor's joints from the "
          "restored file differ from the saved model's")
    if device == "cuda":
        check(launches == {"sbp_heatmaps_cuda": 0, "decode_sbp_cuda": 2},
              f"16: K2 did not decode both predictions: {launches}")
    print(f"phase 16 took {time.perf_counter() - start:.1f} s")
    return launches


def main():
    card = phase_device()
    phase_build()
    gen = torch.Generator().manual_seed(0)
    k1_err, k1_rows = phase_k1(gen)
    k2_err, k2_rows = phase_k2(gen)
    k1_err11, k2_err11, _ = phase_k11(gen)
    k1_err, k2_err = max(k1_err, k1_err11), max(k2_err, k2_err11)
    k3_rows, k3_err = phase_k3()

    rng = np.random.RandomState(0)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        path, batch = _eval_set(tmp, B, rng)
        cfg = dict(CFG, val_path=path)
        os.chdir(tmp)  # the metric writes results.json to the cwd
        try:
            _zero_launches()
            phase_serve()
            phase_eval(batch, cfg)
            launches = {kern.__name__: kern.launches
                        for kern in kernels.KERNELS}
            print(f"serve and eval launches: {launches}")
            check(all(n > 0 for n in launches.values()),
                  f"a kernel of the main path never launched: {launches}")
            check_k3("serve_eval_sbp", 0)
            gt_probe(batch, cfg)
            fp32_cross_check(CFG, "sbp", (1, 256, 192, 3))
            train_launches, sbp_last = phase_sbp_train(path, batch, rng, tmp)
            for name, n in train_launches.items():
                launches[name] += n
            print(f"main path launches (serve, eval, train): {launches}")
            spm_path, spm_batch = _spm_eval_set(tmp, S_B, rng)
            phase_spm(spm_path, spm_batch, rng, tmp)
            for name, n in phase_pis(sbp_last, rng, tmp).items():
                launches[name] += n
            phase_classifier(tmp, rng)
            cache_launches, cache_cfg = phase_cache(tmp)
            for name, n in cache_launches.items():
                launches[name] += n
            print(f"launches over phases 4-10 (SBP serve, eval and fit; "
                  f"SPM; PIS; classifier; cache): {launches}")
            rank_launches = phase_parallel(tmp, cache_cfg)
            learn_launches = phase_learns(tmp)
            for name, n in learn_launches.items():
                launches[name] += n
            print(f"launches over phases 4-10 and 12: {launches}")
            ref_launches = phase_spm_ref(tmp)
            spatial_launches = phase_spatial(tmp)
            hard_launches = phase_spm_hard(tmp)
            image_launches = phase_image_ops(tmp)
        finally:
            os.chdir(cwd)

    def row(name, source, replaces, err, rows):
        ms, plain, bnd, by = rows[B]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "launches_per_rank_11c": [r[name] for r in rank_launches],
                "launches_12": learn_launches[name],
                "launches_13": ref_launches[name],
                "launches_14": spatial_launches[name],
                "launches_15": hard_launches[name],
                "launches_16": image_launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bnd, "bound_by": by, "library_ms": None}

    report = {"kernels": [
        row("sbp_heatmaps_cuda",
            "pytorch_pose_estimation_tpu_torch/csrc/heatmap.cu",
            "pytorch_pose_estimation_tpu/ops/pallas/heatmap.py:54",
            k1_err, k1_rows),
        row("decode_sbp_cuda",
            "pytorch_pose_estimation_tpu_torch/csrc/decode.cu",
            "pytorch_pose_estimation_tpu/ops/pallas/decode.py:61",
            k2_err, k2_rows),
        {"name": "bn_act_cuda", "route": "cuda",
         "source": "pytorch_pose_estimation_tpu_torch/csrc/bn_act.cu",
         "replaces": None,
         "launches": K3_LAUNCHES,
         "unequal_share": {"y": k3_err[0], "dx": k3_err[1]},
         "ms": {c: r["fwd"] + r["bwd"] for c, r in k3_rows.items()},
         "plain_ms": {c: r["plain"] for c, r in k3_rows.items()},
         "bound_ms": {c: r["fwd_bound"] + r["bwd_bound"]
                      for c, r in k3_rows.items()},
         "bound_by": "bytes",
         "library_ms": {c: r["lib_fwd"] + r["lib_bwd"]
                        for c, r in k3_rows.items()}},
    ]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
