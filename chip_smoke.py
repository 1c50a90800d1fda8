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
   is 4x the L2; K2 also timed with the L2 flushed before each call;
4. serve: full-width SBP (darknet19, 256x192 input, 36,606,368 parameters,
   seeded weights, bf16) through ``load_sbp_predictor``: batch 1, batch 1,
   batch 64, uint8; plus one fp32 forward on the card against the CPU;
5. eval: ``validate`` (eval step: K1 targets, forward, loss, K2 decode, then
   the OKS metric) on a seeded batch with a COCO-format annotation file;
   the launch counts of both kernels are set to 0 before phase 4 and read
   after phase 5; then K1 stamps and K2 decodes the targets (GT probe),
   which must give back trunc(joint * ratio) * 4, and their AP is printed.

The last three lines of standard output: the card's name and power limit,
one JSON object describing each kernel, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The config is written inline with the values of configs/sbp_coco.yaml, so
neither PyYAML nor cv2 is needed.  Imports nothing of JAX.
"""

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from pytorch_pose_estimation_tpu_torch.eval import SBPmAPCOCO
from pytorch_pose_estimation_tpu_torch.ops import decode as decode_ops
from pytorch_pose_estimation_tpu_torch.ops import kernels
from pytorch_pose_estimation_tpu_torch.ops import targets as target_ops
from pytorch_pose_estimation_tpu_torch.ops.image import normalize_batch
from pytorch_pose_estimation_tpu_torch.train import (load_model,
                                                     load_sbp_predictor,
                                                     validate)
from pytorch_pose_estimation_tpu_torch.train.steps import _sbp_targets

# configs/sbp_coco.yaml, the fields the serving and eval path reads
CFG = {
    "input_size": [256, 192], "output_size": [64, 48], "num_keypoints": 17,
    "sigma": 2, "conf_threshold": 0.25, "batch_size": 64,
    "precision": "bf16", "seed": 0,
}
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


def _decode_cases(gen, b, h, w):
    """(name, logits, threshold, pred) on [b, K, h, w] maps."""
    rand = (torch.randn(b, K, h, w, generator=gen) * 3).cuda()
    ties = torch.full((b, K, h, w), -5.0, device="cuda")
    ties[:, 0] = 30.0  # saturates to 1.0 everywhere: index 0 wins
    flat = ties.view(b, K, h * w)
    flat[:, 1, 100] = 25.0  # ties with 20.0 at index 50 after the sigmoid
    flat[:, 1, 50] = 20.0
    ties[:, 2] = -20.0  # nothing clears the threshold: sentinel
    below = torch.zeros(b, K, h, w, device="cuda")  # 0.5 < 0.9
    stamped = kernels.sbp_heatmaps_cuda(_joints(gen, b, K, h, w), (h, w), 2.0)
    nan = rand.clone()
    nan.view(b, K, h * w)[0, 3, h * w // 2 + 1] = float("nan")
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


def _decode_check(gen, b, h, w, offset):
    """Every case on one layout: x and y identical to the plain version,
    conf within 1e-6 (both compute the sigmoid as 1/(1+expf(-x)))."""
    label = f"B={b} {h}x{w}" + (" at offset 1" if offset else "")
    err = 0.0
    cases = _decode_cases(gen, b, h, w)
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
              f"{e:.3g}, {found}/{b * K} found")
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


def _eval_set(tmp, n_images, rng):
    """One seeded batch of person crops already at the input size, bbox
    [0, 0, 192, 256] (crop frame == image frame), and its COCO file."""
    joints = np.stack([rng.uniform(0, 192, (n_images, K)),
                       rng.uniform(0, 256, (n_images, K))],
                      axis=-1).astype(np.float32)
    vis = (rng.rand(n_images, K) > 0.2).astype(np.float32)
    joints[vis == 0] = 0.0
    images, anns = [], []
    for i in range(n_images):
        kps = []
        for (x, y), v in zip(joints[i], vis[i]):
            kps += [float(x), float(y), 2 if v else 0]
        images.append({"id": i + 1, "file_name": f"{i + 1:012d}.jpg",
                       "width": 192, "height": 256})
        anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1,
                     "iscrowd": 0, "area": 192.0 * 256.0,
                     "bbox": [0.0, 0.0, 192.0, 256.0], "keypoints": kps,
                     "num_keypoints": int(vis[i].sum())})
    path = os.path.join(tmp, "person_keypoints_val.json")
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


def gt_probe(batch, cfg):
    """K1 stamps the eval batch's targets and K2 decodes them with
    pred=False: every visible joint must come back as trunc(joint*ratio)*4;
    the AP of those joints must be ~1."""
    ratio = H / 256
    joints = torch.from_numpy(batch["joints"]).cuda()
    vis = torch.from_numpy(batch["joints_vis"]).cuda()
    maps = _sbp_targets(joints, vis, ratio, (H, W), K, 2.0)
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
    metric = SBPmAPCOCO(cfg["val_path"], cfg["input_size"], 0.25)
    metric.update_state_decoded(batch, dec)
    ap = metric.result(verbose=False)
    print(f"GT probe: K1 -> K2(pred=False) recovered all {int(seen.sum())} "
          f"visible joints exactly; their AP@.5 {ap:.4f}")
    check(ap > 0.99, f"GT probe: AP@.5 {ap}")


def fp32_cross_check():
    """One fp32 forward (TF32 off) on the card against the CPU, same seeded
    weights and input."""
    cfg = dict(CFG, precision="fp32")
    x = normalize_batch(torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (1, 256, 192, 3), dtype=np.uint8)))
    with torch.inference_mode():
        model = load_model(cfg, None, "cuda")
        gpu = model(x.cuda()).cpu()
        cpu = load_model(cfg, None, "cpu")(x)
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
    print(f"fp32 forward, card vs CPU: max |logit| {scale:.4g}, max diff "
          f"{diff:.3g} ({diff / scale:.3g} relative); with TF32 on "
          f"{tf32_diff / scale:.3g} relative")
    check(diff <= 1e-5 * scale, "fp32 logits differ between card and CPU")


def main():
    card = phase_device()
    phase_build()
    gen = torch.Generator().manual_seed(0)
    k1_err, k1_rows = phase_k1(gen)
    k2_err, k2_rows = phase_k2(gen)

    rng = np.random.RandomState(0)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        path, batch = _eval_set(tmp, B, rng)
        cfg = dict(CFG, val_path=path)
        os.chdir(tmp)  # the metric writes results.json to the cwd
        try:
            for kern in kernels.KERNELS:
                kern.launches = 0
            phase_serve()
            phase_eval(batch, cfg)
            launches = {kern.__name__: kern.launches
                        for kern in kernels.KERNELS}
            print(f"main path launches: {launches}")
            check(all(n > 0 for n in launches.values()),
                  f"a kernel of the main path never launched: {launches}")
            gt_probe(batch, cfg)
        finally:
            os.chdir(cwd)
    fp32_cross_check()

    def row(name, source, replaces, err, rows):
        ms, plain, bnd, by = rows[B]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
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
    ]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
