"""SBP, PIS and SPM training, serving and validation.

Counterpart of pytorch_pose_estimation_tpu/train/trainer.py:
``apply_precision_config``, ``build_model``, ``build_metric``,
``load_for_inference``, ``load_sbp_predictor``, ``validate`` and the
``Trainer`` for SBP, PIS (SBP with the config's 11 keypoints and the PIS
metric) and SPM (``kind``), which reproduces the reference training
contract (train_sbp.py:55-79):

* validation every ``trainer_options.check_val_every_n_epoch`` epochs,
* TensorBoard logs (train_loss / val_loss / val_mAP / lr-step) when
  tensorboardX is installed,
* checkpoints under ``saved/<model>_<dataset>/version_N/checkpoints`` with
  best-by-val_loss and last, resume and ``resume="auto"`` (a checkpoint
  holds the augmentation generators' states too, so a fit interrupted at
  an epoch's end and resumed ends bitwise where the uninterrupted fit
  does; the JAX package folds the epoch into its key instead),
* early stopping on val_loss with patience 30 validation rounds,
* an optional warm start of the backbone from ``backbone_pretrained``, then
  an optional partial warm start from ``model_pretrained``.

Each train step runs augmentation, targets (kernel K1 for SBP), forward,
backward and the update on the device.  The batches come from the host
loader, which prefetches the next ones meanwhile (the batch is copied from
pinned memory without a sync), or, with ``cache_device: True``, from the
train set decoded once and held on the device (``device_cache.py``), in the
JAX package's order.  ``cache_device`` moves CLAHE to the device as in the
JAX package, unless the config says ``clahe: off``; ``cache_scan`` and
``scan_steps_per_dispatch`` (the JAX package's ``lax.scan`` runner) are
read by nothing here: the port steps one batch at a time either way.

Data parallelism (``parallel``): a ``Trainer`` in a process group of N
ranks (started by ``parallel.launch``, the training CLIs or torchrun)
trains on one global batch of ``batch_size`` rows, each rank on its
b = batch_size / N rows, with the JAX single-host mesh's semantics: the
train steps average the gradients and BatchNorm takes the global batch's
statistics, so the ranks' parameters stay bitwise equal and match one
process's.  On one node step s's global batch is one process's batch s:
every rank walks the same batches and builds only its rows, or, with
``cache_device``, holds its shard of the cache.  On several nodes
(``multihost``) each rank loads its own shard of the train set and
``cache_device`` falls back to streaming, as in the JAX package.  The
augmentation generators are seeded alike on every rank.  Rank 0 alone
logs, prints and writes checkpoints; the others wait for its writes at
barriers, and ``resume="auto"`` is resolved on rank 0.  Validation is
sharded (``validate``) and returns the same result on every rank, so the
early stop and the schedule decide alike everywhere.  With one GPU
selected there is no process group and nothing of this runs.

Entry points run on the card by default (``device="cuda"``) and raise when
CUDA is not available; they never carry on quietly on the CPU.  Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import make_model_name
from ..eval.metrics import SBPmAPCOCO, SBPmAPPIS, SPMmAPCOCO
from ..models import (SBP, SPM, PoseNet, lecun_normal_,
                      load_state_dict_file, refuse_directory)
from ..models.summary import print_summary
from ..ops.decode import decode_sbp_fast
from ..ops.image import normalize_batch
from ..optim import build_optimizer_from_cfg
from ..parallel import mesh
from ..tracing import recording, span
from .checkpoint import (CheckpointManager, load_backbone, load_pretrained,
                         next_version_dir, restore_checkpoint)
from .device_cache import build_device_cache
from .state import TrainState
from .steps import (make_sbp_eval_step, make_sbp_steps, make_spm_eval_step,
                    make_spm_steps)

# the batch keys the train and eval steps read, per model kind
_KEYS = {"sbp": ("image", "joints", "joints_vis"),
         "pis": ("image", "joints", "joints_vis"),
         "spm": ("image", "joints", "centers")}
# where backbone_pretrained='tiny-imagenet' looks, under the working
# directory (reference: models/backbone/darknet.py:138-150)
TINY_IMAGENET_CKPT = os.path.join("ckpt", "darknet19-tiny-imagenet.ckpt")


def _check_kind(kind: str) -> str:
    if kind not in _KEYS:
        raise ValueError(f"kind must be 'sbp', 'pis' or 'spm', got "
                         f"{kind!r}")
    return kind


def resolve_device(device) -> torch.device:
    """torch.device of ``device``; raises for CUDA without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return device


def to_device(array, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``; on the card the copy leaves
    from pinned memory and does not wait for the device."""
    t = torch.from_numpy(np.asarray(array))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def apply_precision_config(cfg: dict) -> str:
    """'bf16' (default): bf16 conv compute, fp32 parameters, BN, loss,
    logits and decode.  'fp32': fp32 everywhere, with TF32 off in cuDNN
    convolutions and cuBLAS matmuls (cuDNN convolutions default to TF32)."""
    precision = cfg.get("precision", "bf16")
    if precision not in ("bf16", "fp32"):
        raise ValueError(f"precision must be 'bf16' or 'fp32', got "
                         f"{precision!r}")
    if precision == "fp32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return precision


def build_model(cfg: dict, kind: str = "sbp") -> PoseNet:
    """SBP (``kind`` 'sbp' or 'pis') or SPM at the configured precision,
    with ``cfg['num_keypoints']`` and ``cfg['remat']``, initialized like
    the JAX package (lecun_normal) from a generator seeded with
    ``cfg['seed']`` (0)."""
    cls = SPM if _check_kind(kind) == "spm" else SBP
    precision = apply_precision_config(cfg)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    model = cls(num_keypoints=int(cfg["num_keypoints"]), dtype=dtype,
                remat=bool(cfg.get("remat", False)))
    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    return lecun_normal_(model, gen)


def load_model(cfg: dict, ckpt: Optional[str], device="cuda",
               kind: str = "sbp") -> PoseNet:
    """``build_model``, weights from ``ckpt`` (a torch state_dict, a
    Lightning checkpoint or a training checkpoint) when given, moved to
    ``device``, in eval mode."""
    device = resolve_device(device)
    model = build_model(cfg, kind)
    if ckpt:
        model.load_state_dict(load_state_dict_file(ckpt))
    return model.to(device).eval()


def build_metric(cfg: dict, kind: str = "sbp"):
    if _check_kind(kind) == "spm":
        return SPMmAPCOCO(cfg["val_path"], cfg["input_size"], cfg["sigma"],
                          cfg["conf_threshold"], cfg.get("max_persons", 30))
    cls = SBPmAPPIS if kind == "pis" else SBPmAPCOCO
    return cls(cfg["val_path"], cfg["input_size"], cfg["conf_threshold"])


def _images(images, device: torch.device) -> torch.Tensor:
    """uint8 [B, H, W, 3] (numpy or tensor) -> normalized fp32 NCHW on
    ``device``."""
    images = torch.as_tensor(images, device=device)
    if images.dtype != torch.uint8 or images.dim() != 4 or \
            images.shape[-1] != 3:
        raise ValueError("images must be uint8 [B, H, W, 3], got "
                         f"{images.dtype} {tuple(images.shape)}")
    return normalize_batch(images)


def load_for_inference(cfg: dict, ckpt: Optional[str], kind: str = "sbp",
                       device="cuda"
                       ) -> Tuple[PoseNet, Callable[..., torch.Tensor]]:
    """``load_model`` and ``forward(images_u8_nhwc) -> logits`` [B, C, h, w]
    fp32 on ``device`` (the training pipeline's Normalize(0, 1), then the
    eval-mode model).  Returns (model, forward), as the JAX package returns
    (variables, forward)."""
    device = resolve_device(device)
    model = load_model(cfg, ckpt, device, kind)

    @torch.inference_mode()
    def forward(images) -> torch.Tensor:
        return model(_images(images, device))

    return model, forward


def load_sbp_predictor(cfg: dict, ckpt: Optional[str], device="cuda"
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fused uint8-in / joints-out SBP predictor: normalize + forward +
    sigmoid decode (kernel K2 on the card).

    Returns ``predict(images_u8_nhwc) -> joints [B, K, 3]`` (a tensor on
    ``device``) in input-size pixel coordinates with the reference's
    sentinel scaling.  ``images`` may be a numpy array or a tensor.
    """
    _, forward = load_for_inference(cfg, ckpt, "sbp", device)
    input_w = int(cfg["input_size"][1])
    conf = float(cfg["conf_threshold"])

    @torch.inference_mode()
    def predict(images) -> torch.Tensor:
        return decode_sbp_fast(forward(images), input_w, conf, True)

    return predict


def _eval_step(cfg: dict, model: nn.Module, kind: str) -> Callable:
    if kind == "spm":
        return make_spm_eval_step(
            model, cfg["input_size"], cfg["output_size"],
            int(cfg["num_keypoints"]), float(cfg["sigma"]),
            float(cfg["conf_threshold"]), int(cfg.get("max_persons", 30)))
    return make_sbp_eval_step(
        model, cfg["input_size"], tuple(cfg["output_size"]),
        int(cfg["num_keypoints"]), float(cfg["sigma"]),
        float(cfg["conf_threshold"]))


def _pad_rows(x: np.ndarray, world: int) -> np.ndarray:
    """``x`` padded to a multiple of ``world`` rows by repeating row 0 (the
    JAX package's ``Trainer._pad_to_devices``)."""
    pad = -len(x) % world
    if not pad:
        return x
    return np.concatenate([x, np.repeat(x[:1], pad, axis=0)])


def _gather(out):
    """Every rank's rows of an eval output (a tensor or a tuple of them)."""
    if isinstance(out, tuple):
        return tuple(mesh.gather_rows(t) for t in out)
    return mesh.gather_rows(out)


def validate(cfg: dict, data_module, model: nn.Module, device="cuda",
             verbose: bool = True, kind: str = "sbp") -> Tuple[float, float]:
    """Validation (``Trainer.validate``): eval step over the data module's
    val loader, mean per-sample loss and OKS AP@.5 of the decoded joints.
    Returns (val_loss, val_mAP).

    Under N ranks: each val batch is padded to a multiple of N by repeating
    row 0, rank r evaluates its rows, the per-sample losses and the decoded
    outputs of all rows are gathered, rank 0 counts the real rows in the
    metric, and every rank returns rank 0's result."""
    device = resolve_device(device)
    keys = _KEYS[_check_kind(kind)]
    model = model.to(device).eval()
    eval_step = _eval_step(cfg, model, kind)
    world = mesh.world_size()
    metric = build_metric(cfg, kind) if mesh.is_main() else None
    loss_sum, n_total = 0.0, 0
    for batch in data_module.val_loader():
        n = len(batch["image"])
        dev_batch = {k: torch.as_tensor(mesh.local_rows(_pad_rows(
            np.asarray(batch[k]), world)), device=device) for k in keys}
        per_sample, decoded = eval_step(dev_batch)
        if world > 1:
            per_sample, decoded = mesh.gather_rows(per_sample)[:n], \
                _gather(decoded)
        loss_sum += float(per_sample.sum())
        n_total += n
        if metric is not None:
            metric.update_state_decoded(batch, decoded, count=n)
    val_loss = loss_sum / max(n_total, 1)
    val_map = metric.result(verbose=verbose) if metric is not None else None
    val_loss, val_map = mesh.broadcast_object((val_loss, val_map))
    if verbose and mesh.is_main():
        print(f"val_loss={val_loss:.4f} val_mAP={val_map:.4f}")
    return val_loss, val_map


class Trainer:
    """SBP, PIS or SPM (``kind``) training on one device
    (``device="cuda"`` by default; raises without CUDA), or on one rank of
    a process group (see the module docstring).  ``data_module`` gives
    ``train_loader()`` (with ``set_epoch``), ``val_loader()`` and
    ``val_db``; with ``cache_device`` also ``train_db``, ``batch_size`` and
    ``_loader(db, train, batch_size)``, which ``build_device_cache``
    decodes the train set through.  ``step`` and the epoch counter continue
    across a resume, and so does the cache's order."""

    def __init__(self, cfg: dict, data_module, kind: str = "sbp",
                 logging: bool = True, device="cuda"):
        self.cfg = cfg
        self.kind = _check_kind(kind)
        self.keys = _KEYS[kind]
        self.dm = data_module
        self.device = resolve_device(device)
        # joins torchrun's group when its environment is set (under
        # parallel.launch the group exists already)
        self.rank, self.world = mesh.maybe_init_distributed(
            cfg, "nccl" if self.device.type == "cuda" else "gloo")
        self.main = self.rank == 0
        self.multi_node = mesh.multi_node(cfg)
        if self.world > 1:
            b = mesh.per_rank(int(cfg["batch_size"]), self.world)
            self._say(f"data parallel: {self.world} ranks on "
                      f"{'several nodes' if self.multi_node else 'one node'}"
                      f", {b} rows each of the global batch "
                      f"{cfg['batch_size']}", flush=True)
        elif self.device.type == "cuda" and torch.cuda.device_count() > 1 \
                and len(mesh.select_devices(cfg.get("devices", "auto"))) > 1:
            print("this Trainer is one process on one GPU: train through "
                  "the CLIs (parallel.run) or torchrun to use the selected "
                  "devices", flush=True)
        if data_module is not None and self.multi_node:
            data_module.process_index = self.rank
            data_module.process_count = self.world

        with span("setup.model", sync=True):
            model = build_model(cfg, kind).to(self.device).train()
        optimizer, schedule = build_optimizer_from_cfg(cfg, model)
        self.state = TrainState(model, optimizer, schedule)

        # CLAHE placement: 'host' = cv2 on the crop (Albumentations'
        # semantics), 'device' = luma CLAHE in the train step, 'off'
        clahe_mode = cfg.get("clahe", "host")
        if clahe_mode not in ("host", "device", "off"):
            raise ValueError(f"clahe must be host, device or off, got "
                             f"{clahe_mode!r}")
        # the device cache's batches never pass the host again, so the
        # per-sample CLAHE must run on the device too
        self.cache_device = bool(cfg.get("cache_device"))
        if self.cache_device and self.multi_node:
            self._say("cache_device is for one node; streaming with "
                      "per-process shards instead")
            self.cache_device = False
        self._device_cache = None  # built on the first fit()
        if self.cache_device and clahe_mode == "host":
            clahe_mode = "device"
        if data_module is not None and clahe_mode != "host" and \
                hasattr(data_module, "clahe_prob"):
            data_module.clahe_prob = 0.0
        augment = {"clahe_prob": 0.5} if clahe_mode == "device" else {}
        # user overrides: rotate_limit / scale_range / ratio_range /
        # color_jitter / rotate_prob / jitter_prob / angle_groups
        augment.update(cfg.get("augment_options") or {})
        if kind == "spm" and cfg.get("augment_geometric"):
            augment["geometric"] = True
        self.augment = augment  # the train step's augmentation options
        if kind == "spm":
            self.train_step, self.eval_step = make_spm_steps(
                model, optimizer, cfg["input_size"], cfg["output_size"],
                int(cfg["num_keypoints"]), float(cfg["sigma"]),
                float(cfg["conf_threshold"]), augment=augment,
                max_persons=int(cfg.get("max_persons", 30)))
        else:
            self.train_step, self.eval_step = make_sbp_steps(
                model, optimizer, cfg["input_size"],
                tuple(cfg["output_size"]), int(cfg["num_keypoints"]),
                float(cfg["sigma"]), float(cfg["conf_threshold"]),
                augment=augment)

        self._warm_start_backbone(cfg.get("backbone_pretrained"))

        if cfg.get("model_pretrained"):
            path = cfg["model_pretrained"]
            if os.path.exists(path):
                load_pretrained(self.state, path)
                self._say(f"warm-started from {path}")
            else:
                self._say(f"model_pretrained not found, skipping: {path}")

        self.version_dir = None
        self.writer = None
        self.ckpt = None
        if logging:
            self.version_dir = next_version_dir(
                cfg.get("save_dir", "./saved"), make_model_name(cfg))
            self.ckpt = CheckpointManager(
                os.path.join(self.version_dir, "checkpoints"))
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None and self.main:
                self.writer = SummaryWriter(self.version_dir)

        self.global_step = 0
        self.log_every = int(cfg.get("log_every_n_steps", 50))
        # profiling window [start_step, end_step): a torch.profiler trace
        # of those steps, with the program's spans, into the run's version
        # dir
        prof = (cfg.get("trainer_options") or {}).get("profile_steps")
        self.profile_steps = tuple(prof) if prof else None
        self._profiler = None
        self._recording = None

    @property
    def model(self) -> nn.Module:
        return self.state.model

    def _say(self, *args, **kwargs) -> None:
        """print, on rank 0 only."""
        if self.main:
            print(*args, **kwargs)

    def _warm_start_backbone(self, bp) -> None:
        """Overlay the backbone from ``backbone_pretrained`` (JAX:
        ``Trainer._warm_start_backbone``):

        * 'tiny-imagenet': the reference's classifier checkpoint at
          ``<cwd>/ckpt/darknet19-tiny-imagenet.ckpt`` (Lightning or bare,
          in the reference's classifier layout); a missing file is
          reported and skipped, as in JAX;
        * a path to a file: a checkpoint of ``train_classifier``, or any
          torch file of a classifier or pose model (``load_backbone``);
        * anything else: reported and skipped.

        The JAX package's orbax directories are not read here: a
        directory raises, naming ``tools/orbax_to_torch.py``, which
        converts one on the JAX host."""
        if not bp:
            return
        if bp == "tiny-imagenet":
            path = os.path.join(os.getcwd(), TINY_IMAGENET_CKPT)
            if not os.path.exists(path):
                self._say(f"backbone_pretrained ckpt not found: {path}")
                return
        elif os.path.isdir(bp):
            refuse_directory(bp, "backbone_pretrained")
        elif os.path.isfile(bp):
            path = bp
        else:
            self._say(f"backbone_pretrained not found, skipping: {bp}")
            return
        n = load_backbone(self.model, path)
        self._say(f"backbone warm-started from {path} ({n} tensors)")

    # ------------------------------------------------------------------
    def summary(self):
        """The model's summary table (printed on rank 0 only)."""
        if not self.main:
            return None
        size = self.cfg["input_size"]
        h, w = (size, size) if self.kind == "spm" else size
        return print_summary(self.model, (1, 3, int(h), int(w)))

    def _log(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

    def _device_batch(self, batch: dict, keys: Sequence[str]) -> dict:
        """numpy batch -> tensors on the device (``to_device``)."""
        return {k: to_device(batch[k], self.device) for k in keys}

    def _profile(self):
        """Start or stop the torch.profiler trace at the window's edges
        (rank 0's steps); a ``tracing`` recording is open inside it, so
        that the trace holds the ``pose.*`` spans."""
        if not self.profile_steps or not self.main:
            return
        start, stop = self.profile_steps
        if self._profiler is None and self.global_step == start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._recording = recording(self.device).start()
        elif self._profiler is not None and self.global_step >= stop:
            self._recording.stop()
            self._recording = None
            self._profiler.stop()
            out_dir = self.version_dir or self.cfg.get("save_dir", "./saved")
            os.makedirs(out_dir, exist_ok=True)
            self._profiler.export_chrome_trace(os.path.join(
                out_dir, f"trace_steps_{start}-{stop}.json"))
            self._profiler = None

    # ------------------------------------------------------------------
    def _find_auto_resume(self) -> Optional[str]:
        """Highest-step checkpoint across version dirs (preemption
        recovery): 'last' (its step from the sidecar) or ``epoch=E-step=S``;
        ties prefer 'last'.  'best' is left out (resuming from it would
        rewind training to the best-val epoch), and so are half-written
        ``*.tmp*`` files and the sidecars."""
        base = os.path.join(self.cfg.get("save_dir", "./saved"),
                            make_model_name(self.cfg))
        if not os.path.isdir(base):
            return None
        candidates = []  # (step, prefer_last, path)
        for v in os.listdir(base):
            cdir = os.path.join(base, v, "checkpoints")
            if not v.startswith("version_") or not os.path.isdir(cdir):
                continue
            for name in os.listdir(cdir):
                path = os.path.join(cdir, name)
                if not os.path.isfile(path) or ".tmp" in name or \
                        name.endswith(".meta.json"):
                    continue
                if name == "last":
                    meta = self._read_ckpt_meta(path)
                    candidates.append((int(meta.get("step", 0)), 1, path))
                elif name.startswith("epoch=") and "-step=" in name:
                    try:
                        step = int(name.split("-step=")[1])
                    except ValueError:
                        continue
                    candidates.append((step, 0, path))
        if not candidates:
            return None
        return max(candidates)[2]

    @staticmethod
    def _read_ckpt_meta(path: str) -> dict:
        try:
            with open(path + ".meta.json") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def fit(self, resume: Optional[str] = None) -> TrainState:
        cfg = self.cfg
        if resume == "auto":
            resume = mesh.broadcast_object(
                self._find_auto_resume() if self.main else None)
            self._say(f"auto-resume: {resume or 'no checkpoint found'}")
        # the train step's draws; every checkpoint holds the generators'
        # states, so a resumed fit continues the uninterrupted fit's draws
        # (one written without them starts the stream again)
        seed = int(cfg.get("seed", 0)) * 1000003
        gen = torch.Generator(self.device).manual_seed(seed)
        host_gen = torch.Generator().manual_seed(seed)
        self.state.generators = (gen, host_gen)
        start_epoch = 0
        if resume:
            # continue the run: the epoch from the checkpoint's meta, the
            # step from the restored optimizer's update count
            meta = restore_checkpoint(resume, self.state)
            if "epoch" in meta:
                start_epoch = int(meta["epoch"]) + 1
            self.global_step = self.state.step
            self._say(f"resuming at epoch {start_epoch} "
                      f"(global step {self.global_step})")
        trainer_options = cfg.get("trainer_options", {}) or {}
        val_every = int(trainer_options.get("check_val_every_n_epoch", 1))
        patience = int(cfg.get("early_stop_patience", 30))
        max_epochs = int(cfg["epochs"])

        # Lightning-style sanity validation: a few val batches before
        # training, so that a broken eval path shows at once
        sanity = int(trainer_options.get("num_sanity_val_steps", 0))
        if sanity > 0 and self.dm.val_db:
            self.model.eval()
            for i, batch in enumerate(self.dm.val_loader()):
                if i >= sanity:
                    break
                self.eval_step(self._device_batch(batch, self.keys))
            self.model.train()
            self._say(f"sanity validation: {sanity} batch(es) ok")

        best_val = float("inf")
        bad_rounds = 0
        train_loader = None if self.cache_device else self._train_loader()
        if self.cache_device and self._device_cache is None:
            t0 = time.time()
            self._device_cache = build_device_cache(
                self.dm, self.dm.batch_size, seed=int(cfg.get("seed", 0)),
                keys=self.keys, device=self.device)
            cache = self._device_cache
            self._say(f"device cache: {cache.n_total} instances, "
                      f"{cache.nbytes() / 2 ** 20:.0f} MB on {self.device}"
                      f"{' per rank' if self.world > 1 else ''}, "
                      f"{cache.steps_per_epoch} steps/epoch (built in "
                      f"{time.time() - t0:.1f}s)", flush=True)
        for epoch in range(start_epoch, max_epochs):
            if train_loader is None:
                batches = self._device_cache.epoch_batches(epoch)
            else:
                train_loader.set_epoch(epoch)
                batches = (self._device_batch(b, self.keys)
                           for b in train_loader)
            epoch_losses = []
            t0 = time.time()
            n_img = 0
            for batch in batches:
                self._profile()
                loss = self.train_step(batch, gen, host_gen)
                self.global_step += 1
                n_img += batch["image"].shape[0]
                # keep the device scalar: no host sync per step
                epoch_losses.append(loss)
                if self.global_step % self.log_every == 0:
                    self._log("train_loss", float(loss), self.global_step)
                    self._log("lr-step", float(self.state.schedule(
                        self.global_step - 1)), self.global_step)
            self._profile()
            mean_loss = float(torch.stack(epoch_losses).mean()) if \
                epoch_losses else float("nan")
            dt = time.time() - t0
            self._say(f"epoch {epoch}: train_loss={mean_loss:.4f} "
                      f"({n_img * self.world / max(dt, 1e-9):.1f} img/s)",
                      flush=True)

            val_loss = None
            if (epoch + 1) % val_every == 0 and self.dm.val_db:
                val_loss, val_map = self.validate(verbose=False)
                self._log("val_loss", val_loss, self.global_step)
                self._log("val_mAP", val_map, self.global_step)
                self._say(f"epoch {epoch}: val_loss={val_loss:.4f} "
                          f"val_mAP={val_map:.4f}")
                if self.ckpt and (epoch + 1) % int(
                        cfg.get("save_freq", 1)) == 0:
                    self.ckpt.save_epoch(self.state, epoch, val_loss)
                if val_loss < best_val - 1e-12:
                    best_val = val_loss
                    bad_rounds = 0
                else:
                    bad_rounds += 1
            if self.ckpt and (epoch + 1) % int(
                    cfg.get("save_last_every_n_epochs", 1)) == 0:
                self.ckpt.save_last(self.state, epoch, val_loss)
            if bad_rounds >= patience:
                self._say(f"early stopping at epoch {epoch} "
                          f"(no val_loss improvement in {patience} rounds)")
                break
        if self.writer is not None:
            # its thread must end before the process does (a spawned rank
            # exits right after); a later log opens the file again
            self.writer.close()
        return self.state

    def _train_loader(self):
        """The streaming train loader: on one node this rank's rows of
        every global batch, on several its own shard at b rows a batch."""
        if self.multi_node:
            return self.dm.train_loader(
                batch_size=mesh.per_rank(int(self.cfg["batch_size"])))
        loader = self.dm.train_loader()
        if self.world > 1:
            loader.split_rows(self.rank, self.world)
        return loader

    def validate(self, verbose: bool = True) -> Tuple[float, float]:
        """``validate`` on the data module's val loader, then the model is
        put back in train mode.  Returns (val_loss, val_mAP)."""
        try:
            return validate(self.cfg, self.dm, self.model, self.device,
                            verbose, self.kind)
        finally:
            self.model.train()
