"""Profile a train step on one GPU at full width, seeded weights and
seeded uint8 images already on the card: SBP (darknet19, 256x192 input,
batch 256 by default), SPM (512x512 input, 30 persons, batch 32 by
default; bf16, sgd nesterov, device CLAHE) or the darknet19 classifier
(64x64 input, 200 classes, batch 256, bf16, sgd nesterov, dropout):

    python -m pytorch_pose_estimation_tpu_torch.profile_train_step \\
        [--kind sbp|spm|classifier] [--geometric] [--batch N] [--steps 5]

``--geometric`` gives SPM SBP's rotate + crop + jitter in fp32
(``augment_geometric``, as configs/spm_synth_ref.yaml).

Prints the card's name and power limit, the step time by host clock
(synchronized, after warm-up), each part's device and host time from the
step's ``tracing`` spans (draw, augment, targets, forward, backward,
optimizer; the classifier's step has no augment and no targets; the mean
over the steps), the augmentation's and the targets' own parts timed
alone by CUDA events, then a ``torch.profiler`` trace of the same steps:
the device's busy share of the window (the union of the kernels'
intervals, so that overlapping kernels count once) and the kernels with
the most device time, and the same time grouped into kinds (convolution,
matmul, elementwise, ...).
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from . import optim, tracing
from .models.darknet import dropout_mask_shape
from .ops import image
from .ops import targets as target_ops
from .train import build_model, make_sbp_steps, make_spm_steps
from .train.steps import _spm_targets
from .train_classifier import build_classifier, make_classifier_steps
# kernel-name fragments -> kind, first match wins
_KINDS = (("sbp_heatmaps", "K1"), ("decode_sbp", "K2"),
          ("implicit_gemm", "convolution"), ("convolve", "convolution"),
          ("conv", "convolution"), ("gemm", "matmul"),
          ("nchwtonhwc", "layout transpose"),
          ("nhwctonchw", "layout transpose"), ("bn_", "batch norm"),
          ("batch_norm", "batch norm"), ("max_pool", "max pool"),
          ("copy", "copy / cast"), ("reduce", "reduction"),
          ("index", "index / scatter / gather"),
          ("gather", "index / scatter / gather"),
          ("scatter", "index / scatter / gather"),
          ("elementwise", "elementwise"))


def _kind(name: str) -> str:
    low = name.lower()
    for fragment, kind in _KINDS:
        if fragment in low:
            return kind
    return "other"


def busy_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _device_ms(fn, n=5) -> float:
    """Mean device time of ``fn`` by CUDA events, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _augment_parts(batch, gen, host_gen, hw=(256, 192),
                   dtype=torch.bfloat16, **options) -> dict:
    """The geometric augmentation's parts at the train step's inputs and
    draws (``options``: ``sample_augment``'s), jitter and crop in
    ``dtype``."""
    b = batch["image"].shape[0]
    draws = image.sample_augment(gen, b, hw, clahe_prob=0.5,
                                 host_gen=host_gen, **options)
    imgs = image.normalize_batch(batch["image"])
    jit_in = imgs.to(dtype)
    name = str(dtype).removeprefix("torch.")
    return {
        "normalize": _device_ms(lambda: image.normalize_batch(
            batch["image"])),
        "rotation": _device_ms(lambda: image.rotate_shear3_grouped(
            imgs, draws.angles, hw[0] / 2.0, hw[1] / 2.0)),
        "clahe": _device_ms(lambda: image.clahe_luma_batch(
            imgs, draws.clahe, draws.clahe_clip)),
        f"color jitter ({name})": _device_ms(
            lambda: image.color_jitter_batch(
                jit_in, draws.brightness, draws.contrast, draws.saturation,
                draws.hue, draws.jitter_order, draws.jitter)),
        f"crop ({name})": _device_ms(lambda: image.crop_resize_mxu(
            jit_in, draws.x0, draws.y0, draws.cw, draws.ch)),
        "draws": _device_ms(lambda: image.sample_augment(
            gen, b, hw, clahe_prob=0.5, host_gen=host_gen, **options))}


def _spm_geometric_parts(batch, gen, host_gen) -> dict:
    """The SPM step's geometric augmentation (``make_spm_steps``'
    defaults: fp32 images, rotate_limit 30, scale (0.6, 1), ratio (0.75,
    1.33)) and its targets, part by part."""
    return dict(_augment_parts(batch, gen, host_gen, (512, 512),
                               torch.float32, rotate_limit=30.0,
                               scale_range=(0.6, 1.0),
                               ratio_range=(0.75, 1.33)),
                **_spm_target_parts(batch))


def _spm_parts(batch, gen, host_gen) -> dict:
    """The SPM step's photometric augmentation and targets, part by
    part."""
    b = batch["image"].shape[0]
    draws = image.sample_photometric(gen, b, clahe_prob=0.5,
                                     host_gen=host_gen)
    imgs = image.normalize_batch(batch["image"])
    return {
        "normalize": _device_ms(lambda: image.normalize_batch(
            batch["image"])),
        "clahe": _device_ms(lambda: image.clahe_luma_batch(
            imgs, draws.clahe, draws.clahe_clip)),
        "color jitter (bfloat16)": _device_ms(
            lambda: image.color_jitter_batch(
                imgs.to(torch.bfloat16), draws.brightness, draws.contrast,
                draws.saturation, draws.hue, draws.jitter_order,
                draws.jitter)),
        "draws": _device_ms(lambda: image.sample_photometric(
            gen, b, clahe_prob=0.5, host_gen=host_gen)),
        **_spm_target_parts(batch)}


def _spm_target_parts(batch) -> dict:
    """The SPM targets' parts at 512 -> 128."""
    c = torch.floor(batch["centers"] * 0.25)
    j = torch.floor(batch["joints"] * 0.25)
    masks = target_ops.spm_masks(c, 128, 1.0)
    return {
        "targets: root heatmap": _device_ms(
            lambda: target_ops.spm_heatmaps(c, 128, 1, 1.0)),
        "targets: masks": _device_ms(
            lambda: target_ops.spm_masks(c, 128, 1.0)),
        "targets: displacements": _device_ms(
            lambda: target_ops.spm_displacements(j, masks, 128, 17)),
        "targets: all": _device_ms(lambda: _spm_targets(
            batch["joints"], batch["centers"], 0.25, 128, 17, 1.0))}


def spm_people(rng, n: int, size: int = 512, max_persons: int = 30):
    """Seeded persons for n images of ``size`` x ``size`` (input px),
    padded to ``max_persons`` with (0, 0): 1-7 an image, each a center and
    17 joints within 120 px of it at 512 (scaled with ``size``), a fifth of
    the joints absent.  Returns joints [n, P, 17, 2], centers [n, P, 1, 2]
    fp32."""
    joints = np.zeros((n, max_persons, 17, 2), np.float32)
    centers = np.zeros((n, max_persons, 1, 2), np.float32)
    r = 120 * size / 512
    for i in range(n):
        m = rng.randint(1, 8)
        c = rng.uniform(r / 2, size - r / 2, (m, 2))
        centers[i, :m, 0] = c
        j = np.clip(c[:, None] + rng.uniform(-r, r, (m, 17, 2)), 1, size - 1)
        j[rng.rand(m, 17) < 0.2] = 0.0
        joints[i, :m] = j
    return joints, centers


def _classifier_setup(b: int, rng):
    """The classifier's step with the SBP steps' signature, its batch and
    its parts (the dropout mask's draw)."""
    model = build_classifier({"precision": "bf16", "seed": 0}, 200).cuda()
    opt = optim.get_optimizer("sgd", list(model.parameters()), lr=0.1,
                              momentum=0.9, weight_decay=5e-4, nesterov=True)
    train_step, _ = make_classifier_steps(model, opt, 200)

    def step(batch, gen, host_gen):
        return train_step(batch["image"], batch["label"], gen)

    def parts(batch, gen, host_gen):
        shape = dropout_mask_shape(b, 64, 64)
        return {"dropout mask draw": _device_ms(
            lambda: torch.rand(shape, generator=gen, device="cuda"))}

    batch = {"image": rng.randint(0, 256, (b, 64, 64, 3), dtype=np.uint8),
             "label": rng.randint(0, 200, b).astype(np.int32)}
    return step, {k: torch.from_numpy(v).cuda()
                  for k, v in batch.items()}, parts


def _setup(kind: str, b: int, rng, geometric: bool = False):
    """(step, batch on the card, parts timer) at full width; SPM with
    ``augment_geometric`` where ``geometric``."""
    if kind == "classifier":
        return _classifier_setup(b, rng)
    cfg = {"num_keypoints": 17, "precision": "bf16", "seed": 0}
    model = build_model(cfg, kind).cuda().train()
    opt = optim.get_optimizer("sgd", list(model.parameters()), lr=1e-3,
                              momentum=0.9, weight_decay=5e-3, nesterov=True)
    if kind == "spm":
        step, _ = make_spm_steps(model, opt, 512, 128, 17, 1.0, 0.5,
                                 augment={"clahe_prob": 0.5,
                                          "geometric": geometric})
        joints, centers = spm_people(rng, b)
        batch = {"image": rng.randint(0, 256, (b, 512, 512, 3),
                                      dtype=np.uint8),
                 "joints": joints, "centers": centers}
        parts = _spm_geometric_parts if geometric else _spm_parts
    else:
        step, _ = make_sbp_steps(model, opt, [256, 192], (64, 48), 17, 2.0,
                                 0.25, augment={"clahe_prob": 0.5})
        batch = {
            "image": rng.randint(0, 256, (b, 256, 192, 3), dtype=np.uint8),
            "joints": np.stack([rng.uniform(0, 192, (b, 17)),
                                rng.uniform(0, 256, (b, 17))],
                               -1).astype(np.float32),
            "joints_vis": (rng.rand(b, 17) > 0.2).astype(np.float32)}
        parts = _augment_parts
    return step, {k: torch.from_numpy(v).cuda()
                  for k, v in batch.items()}, parts


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kind", choices=("sbp", "spm", "classifier"),
                        default="sbp")
    parser.add_argument("--batch", type=int, default=None,
                        help="default 256 for SBP and the classifier, 32 "
                             "for SPM")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--geometric", action="store_true",
                        help="SPM with augment_geometric (SBP's rotate + "
                             "crop + jitter, as configs/spm_synth_ref.yaml)")
    args = parser.parse_args(argv)
    if args.geometric and args.kind != "spm":
        parser.error("--geometric is an SPM option")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])

    b = args.batch or (32 if args.kind == "spm" else 256)
    step, batch, parts_alone = _setup(args.kind, b,
                                      np.random.RandomState(0),
                                      args.geometric)
    gen = torch.Generator("cuda").manual_seed(0)
    host_gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        step(batch, gen, host_gen)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(batch, gen, host_gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    label = args.kind + (" (augment_geometric)" if args.geometric else "")
    print(f"{label} train step at batch {b}: {step_ms:.2f} ms host clock "
          f"({b * 1e3 / step_ms:.0f} images/s), mean of {args.steps}")

    with tracing.recording("cuda") as rec:
        for _ in range(args.steps):
            step(batch, gen, host_gen)
    spans = rec.summary()["spans"]
    print("parts (tracing spans, mean device / host ms): " + ", ".join(
        f"{k.removeprefix('train.')} {v['device_ms']:.2f} / "
        f"{v['host_ms']:.2f}" for k, v in spans.items()))
    print("parts alone (CUDA events): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in
        parts_alone(batch, gen, host_gen).items()))

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(args.steps):
            step(batch, gen, host_gen)
        torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    # device events, less the ranges that annotate them (they overlap)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        print("torch.profiler recorded no device events")
        return
    busy_ms = busy_us((e.time_range.start, e.time_range.end)
                      for e in kernels) / 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    by_kind = defaultdict(float)
    for e in kernels:
        by_name[e.name][0] += e.device_time_total / 1e3
        by_name[e.name][1] += 1
        by_kind[_kind(e.name)] += e.device_time_total / 1e3
    print(f"profiler: {len(kernels)} device events over {args.steps} steps, "
          f"device busy {busy_ms / args.steps:.2f} ms a step "
          f"({busy_ms / window_ms:.1%} of the {window_ms:.1f} ms window, "
          f"which includes the profiler's own cost)")
    print("device time by kind, a step: " + ", ".join(
        f"{k} {v / args.steps:.2f} ms" for k, v in
        sorted(by_kind.items(), key=lambda kv: -kv[1])))
    print("top kernels by device time, a step (ms, launches):")
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:25]:
        print(f"  {ms / args.steps:8.3f}  {n // args.steps:5d}  {name[:110]}")


if __name__ == "__main__":
    main()
