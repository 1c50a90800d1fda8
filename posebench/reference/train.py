"""The first train steps of a cell in plain PyTorch, float32.

From the seeded weights and the rows the device cache serves (worked out
again from the seed: ``cache_rows``), each step draws its augmentation
from generators seeded as the program's, augments, builds the targets,
runs the network in train mode, the loss and its gradients, and applies
SGD with Nesterov momentum, the weight decay added to the gradient first
(``t = g + wd p + m t``, ``p -= lr (g + wd p + m t)``), at the yolo_lr
schedule's rate for the step's update count.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from posebench.reference import augment, model, targets


def cache_rows(n: int, seed: int, batch: int, steps: int, world: int = 1
               ) -> np.ndarray:
    """The host rows of the first ``steps`` global batches that a cache of
    ``n`` rows over ``world`` devices serves for ``seed`` (the port's
    order, and the JAX package's): one permutation of the rows at upload,
    padded by wraparound to a multiple of ``world`` and cut into one
    contiguous shard a device; every epoch one permutation of the
    positions inside each shard, cut into steps of batch/world rows; a
    global batch is the devices' rows in device order."""
    order = np.random.RandomState(
        (seed * 2654435761 + 97) % (2 ** 32)).permutation(n)
    n_pad = -(-n // world) * world
    order = np.concatenate([order, order[:n_pad - n]])
    local = n_pad // world
    rng = np.random.RandomState((seed * 1000003) % (2 ** 32))
    perms = [rng.permutation(local) for _ in range(world)]
    pb = batch // world
    return np.stack([np.concatenate(
        [order[d * local + perms[d][s * pb:(s + 1) * pb]]
         for d in range(world)]) for s in range(steps)])


def yolo_lr(count: int, lr: float, burn_in: int, steps: Sequence[int],
            scales: Sequence[float]) -> float:
    if count < burn_in:
        return lr * (count / burn_in) ** 4
    out = lr
    for s, c in zip(steps, scales):
        if s <= count:
            out *= c
    return out


def run_steps(cfg: dict, weights: Dict[str, torch.Tensor],
              batches: List[dict], gen_seed: int, start_count: int,
              quant=None) -> dict:
    """``len(batches)`` steps from ``weights``.  Returns the losses, the
    norm of each parameter's first gradient and of its change over the
    steps (keys: ``parameter_keys``), the first step's logits, and each
    parameter's group (``parameter_groups``)."""
    kind, k = cfg["kind"], int(cfg["num_keypoints"])
    dev = batches[0]["image"].device
    gen = torch.Generator(dev).manual_seed(gen_seed)
    host_gen = torch.Generator().manual_seed(gen_seed)
    keys = model.parameter_keys(kind, k)
    p = {key: v.detach().clone().float() for key, v in weights.items()}
    p0 = {key: p[key].clone() for key in keys}
    trace = {key: torch.zeros_like(p[key]) for key in keys}
    opt, sched = cfg["optimizer_options"], cfg["scheduler_options"]
    wd, mom = float(opt["weight_decay"]), float(opt["momentum"])
    aug = cfg["augment"]
    losses, first = [], None
    for i, batch in enumerate(batches):
        b = batch["image"].shape[0]
        if kind == "sbp":
            geo, photo = augment.sample_geometric(
                gen, host_gen, b, cfg["input_size"], aug)
            img, joints, vis = augment.geometric(
                batch["image"], batch["joints"].float(),
                batch["joints_vis"].float(), geo, photo, quant)
            ratio = cfg["output_size"][0] / cfg["input_size"][0]
            target = targets.sbp_heatmaps(joints, vis, ratio,
                                          cfg["output_size"], cfg["sigma"])
        else:
            photo = augment.sample_photometric(
                gen, host_gen, b, aug["color_jitter"], aug["clahe_prob"],
                aug["jitter_prob"])
            img = augment.photometric(batch["image"], photo, quant)
            ratio = cfg["output_size"] / cfg["input_size"]
            target = targets.spm_target(batch["centers"].float(),
                                        batch["joints"].float(), ratio,
                                        cfg["output_size"], cfg["sigma"])
        leaves = [p[key].requires_grad_() for key in keys]
        logits = model.forward(p, img, kind, k, True, quant)
        loss = (targets.sbp_loss if kind == "sbp" else targets.spm_loss)(
            logits, target)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if first is None:
                first = {key: float(g.norm()) for key, g in zip(keys, grads)}
                first_logits = logits.detach().cpu()
            lr = yolo_lr(start_count + i, float(opt["lr"]),
                         int(sched["burn_in"]), sched["steps"],
                         sched["scales"])
            for key, g in zip(keys, grads):
                g = g + wd * p[key]
                trace[key] = g + mom * trace[key]
                p[key] = p[key].detach() - lr * (g + mom * trace[key])
        del logits, loss, grads, leaves
    with torch.no_grad():
        change = {key: float((p[key] - p0[key]).norm()) for key in keys}
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "logits": first_logits,
            "groups": model.parameter_groups(kind, k)}
