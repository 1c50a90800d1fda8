"""Pretrain the darknet19 classifier (tiny-imagenet style), on the GPU by
default.  Its checkpoint is what a pose config's ``backbone_pretrained``
reads (the reference loads such a checkpoint but ships no trainer for it,
models/backbone/darknet.py:138-150).  Counterpart of the repo's
train_classifier.py:

    python -m pytorch_pose_estimation_tpu_torch.train_classifier \\
        --cfg configs/darknet19_classifier.yaml [--device cuda]

The train step: uint8 / 255, the train-mode forward with a dropout keep
mask drawn from a ``torch.Generator`` (flax's element dropout, rate 0.5),
the loss ``-mean(sum(one_hot * log_softmax(logits)))`` (under bf16 the
logits and their log_softmax are bf16, as in JAX; the one-hot is fp32),
the backward, the update, and the batch accuracy.  Validation every
``check_val_every_n_epoch`` epochs (the config's top level, default 5)
counts top-1 hits; then ``save_epoch`` with val_loss = 1 - accuracy, and
``save_last`` every epoch, under
``<save_dir>/<model>_<dataset_name>/version_N/checkpoints``.

With ``--device cuda`` it trains on every GPU that the config's
``devices`` selects, one process each (``parallel.run``), or on
torchrun's ranks, with the JAX CLI's semantics: each rank takes its rows
of the global batch and of the global dropout mask, the gradients are
averaged, BatchNorm is cross-replica, and each val batch is padded to a
multiple of the ranks (the padded rows count no hit).
"""

import argparse
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import parallel
from .config import get_configs, make_model_name
from .data import ImageFolderDataModule
from .models import lecun_normal_
from .models.darknet import (darknet19, dropout_mask_shape,
                             sample_dropout_mask)
from .ops.image import normalize_batch
from .optim import build_optimizer_from_cfg
from .tracing import span
from .train import (CheckpointManager, TrainState, apply_precision_config,
                    next_version_dir, resolve_device, to_device)


def classifier_loss(logits: torch.Tensor, labels: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """-mean over the batch of sum(one_hot * log_softmax(logits)), the
    one-hot in fp32 (``jax.nn.one_hot``'s default)."""
    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    return -(onehot * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def make_classifier_steps(model: nn.Module, optimizer, num_classes: int
                          ) -> Tuple[Callable, Callable]:
    """Returns (train_step, eval_step).

    ``train_step(images, labels, gen=None, mask=None, marker=None) ->
    (loss, accuracy)``, both 0-dim device tensors (no host sync), updates
    ``model`` and ``optimizer`` in place; ``images`` uint8 [B, S, S, 3],
    ``labels`` [B] on the model's device (under N ranks, this rank's rows
    of the global batch; loss and accuracy are the global batch's); the
    dropout keep mask of the global batch is drawn from ``gen`` unless
    given, and the rank keeps its rows.  ``marker(name)``, if given, is
    called after "forward_backward", ("all_reduce" under N ranks) and
    "optimizer".  Under a ``tracing.recording()`` the step is the span
    ``train.step`` over ``train.draw`` (the mask), ``train.forward``,
    ``train.backward``, (``train.all_reduce``) and ``train.optimizer``.

    ``eval_step(images, labels) -> the number of top-1 hits`` (a 0-dim
    tensor), in eval mode; a label -1 (a padded row) is never a hit."""

    def train_step(images: torch.Tensor, labels: torch.Tensor,
                   gen: Optional[torch.Generator] = None,
                   mask: Optional[torch.Tensor] = None,
                   marker: Optional[Callable] = None):
        mark = marker or (lambda name: None)
        with span("train.step"):
            model.train()
            x = normalize_batch(images)
            world = parallel.world_size()
            if mask is None:
                with span("train.draw"):
                    b, _, h, w = x.shape
                    mask = sample_dropout_mask(
                        gen, dropout_mask_shape(b * world, h, w),
                        device=x.device)
            with span("train.forward"):
                logits = model(x, parallel.local_rows(mask))
                loss = classifier_loss(logits, labels, num_classes)
            with span("train.backward"):
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
            mark("forward_backward")
            with torch.no_grad():
                acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
            if world > 1:
                with span("train.all_reduce"):
                    loss, acc = parallel.average_gradients(
                        model.parameters(), loss, acc)
                mark("all_reduce")
            with span("train.optimizer"):
                optimizer.step()
            mark("optimizer")
            return loss.detach(), acc

    @torch.inference_mode()
    def eval_step(images: torch.Tensor, labels: torch.Tensor):
        model.eval()
        logits = model(normalize_batch(images))
        return (logits.argmax(-1) == labels).to(torch.float32).sum()

    return train_step, eval_step


def build_classifier(cfg: dict, num_classes: int) -> nn.Module:
    """darknet19 with ``num_classes`` at the configured precision, seeded
    lecun_normal like the JAX package's init (``cfg['seed']``, 0)."""
    precision = apply_precision_config(cfg)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    model = darknet19(num_classes=num_classes, dtype=dtype)
    return lecun_normal_(model, torch.Generator().manual_seed(
        int(cfg.get("seed", 0))))


def _val_hits(eval_step, batch: dict, device) -> float:
    """Top-1 hits of one val batch; under N ranks the batch is padded to a
    multiple of N (images by repeating its first rows, labels with -1, as
    the JAX CLI pads), each rank counts its rows and the counts are
    summed."""
    world = parallel.world_size()
    images, labels = batch["image"], batch["label"]
    pad = -len(labels) % world
    if pad:
        images = np.concatenate([images, images[:pad]], 0)
        labels = np.concatenate([labels, np.full(pad, -1, labels.dtype)], 0)
    hits = eval_step(to_device(parallel.local_rows(images), device),
                     to_device(parallel.local_rows(labels), device))
    return float(parallel.all_reduce_sum(hits))


def train(cfg: dict, data_module=None, device: str = "cuda") -> TrainState:
    """Train per ``cfg``; ``data_module`` (default: an
    ``ImageFolderDataModule`` over ``train_dir`` and ``val_dir``) gives
    ``train_loader()``, ``val_loader()`` and ``val_db``.  Returns the
    final ``TrainState``.  Under a process group of N ranks each rank
    trains on its rows of every global batch (on several nodes, on its
    own shard of the train set); rank 0 prints and writes the
    checkpoints."""
    device = resolve_device(device)
    rank, world = parallel.maybe_init_distributed(
        cfg, "nccl" if device.type == "cuda" else "gloo")
    main = rank == 0
    dm = data_module
    if dm is None:
        dm = ImageFolderDataModule(
            train_dir=cfg["train_dir"], val_dir=cfg["val_dir"],
            input_size=cfg["input_size"], workers=cfg["workers"],
            batch_size=cfg["batch_size"])
        dm.setup()
    num_classes = int(cfg.get("num_classes") or len(dm.classes))
    multi_node = parallel.multi_node(cfg)
    if multi_node:
        dm.process_index, dm.process_count = rank, world

    model = build_classifier(cfg, num_classes).to(device)
    optimizer, schedule = build_optimizer_from_cfg(cfg, model)
    state = TrainState(model, optimizer, schedule)
    train_step, eval_step = make_classifier_steps(model, optimizer,
                                                  num_classes)

    version_dir = next_version_dir(cfg.get("save_dir", "./saved"),
                                   make_model_name(cfg))
    ckpt = CheckpointManager(f"{version_dir}/checkpoints")
    gen = torch.Generator(device).manual_seed(int(cfg.get("seed", 0)))
    val_every = int(cfg.get("check_val_every_n_epoch", 5))
    if multi_node:
        loader = dm.train_loader(parallel.per_rank(dm.batch_size))
    else:
        loader = dm.train_loader()
        if world > 1:
            loader.split_rows(rank, world)
    for epoch in range(int(cfg["epochs"])):
        loader.set_epoch(epoch)
        t0, n, losses = time.time(), 0, []
        for batch in loader:
            loss, _ = train_step(to_device(batch["image"], device),
                                 to_device(batch["label"], device), gen)
            losses.append(loss)  # a device scalar: no sync per step
            n += len(batch["label"])
        mean_loss = float(torch.stack(losses).float().mean()) if losses \
            else float("nan")
        rate = n * world / max(time.time() - t0, 1e-9)
        if main:
            print(f"epoch {epoch}: loss={mean_loss:.4f} ({rate:.1f} img/s)",
                  flush=True)

        if (epoch + 1) % val_every == 0 and dm.val_db:
            correct, total = 0.0, 0
            for batch in dm.val_loader():
                correct += _val_hits(eval_step, batch, device)
                total += len(batch["label"])
            acc = correct / max(total, 1)
            if main:
                print(f"epoch {epoch}: val_acc={acc:.4f}")
            ckpt.save_epoch(state, epoch, val_loss=1.0 - acc)
        ckpt.save_last(state, epoch)
    return state


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True, type=str, help="config file")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    cfg = get_configs(args.cfg)
    return parallel.run(train, cfg, args.device, cfg, None, args.device)


if __name__ == "__main__":
    main()
