"""The first train steps of a cell in plain PyTorch, float32.

From the seeded weights and the rows the device cache serves (worked out
again from the seed: ``cache_rows``), each step draws its augmentation
from generators seeded as the program's, augments, builds the targets,
runs the configuration's network (``networks/``) in train mode, the loss
and its gradients, and applies the configuration's optimizer at its
schedule's rate for the step's update count (``rules``).

The rules are those of the configuration's names, in the order of optax's
chains (the port's optimizers follow them), each a tensor at a time:

* ``sgd``: the weight decay added to the gradient first, then the trace
  (``t = g + wd p + m t``; Nesterov: ``p -= lr (g + wd p + m t)``, else
  ``p -= lr t``);
* ``adam``: the weight decay added to the gradient first, then the moments
  (``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``), each
  divided by ``1 - b^n`` in float32 at the update's count ``n`` (the
  count after it), ``p -= lr mu^ / (sqrt(nu^) + eps)``;
* ``adamw``: Adam's direction, then the decay: ``p -= lr (mu^ /
  (sqrt(nu^) + eps) + wd p)``;

and the rate, at the update count before the update: ``yolo_lr`` (a
quartic burn-in, then the scales of the steps reached), ``multi_step``
(``lr gamma^m``, m the milestones reached).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from posebench.reference import augment, targets


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


def multi_step(count: int, lr: float, milestones: Sequence[int],
               gamma: float) -> float:
    return lr * gamma ** sum(1 for m in milestones if m <= count)


def _state(state: dict, name: str, p: torch.Tensor) -> torch.Tensor:
    """The state tensor ``name`` of a parameter, zeros before its first
    update."""
    if name not in state:
        state[name] = torch.zeros_like(p)
    return state[name]


def sgd(momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False):
    wd, mom = float(weight_decay), float(momentum)

    def update(p, g, state, count):
        g = g + wd * p
        if not mom:
            return g
        state["trace"] = g + mom * _state(state, "trace", p)
        return g + mom * state["trace"] if nesterov else state["trace"]

    return update


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _adam(betas, eps, decay_first, wd):
    b1, b2 = (float(b) for b in betas)

    def update(p, g, state, count):
        if decay_first:
            g = g + wd * p
        state["mu"] = g * (1 - b1) + _state(state, "mu", p) * b1
        state["nu"] = g * g * (1 - b2) + _state(state, "nu", p) * b2
        mu = state["mu"] / _bias_correction(b1, count)
        nu = state["nu"] / _bias_correction(b2, count)
        u = mu / (nu.sqrt() + eps)
        return u if decay_first else u + wd * p

    return update


def adam(betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
    return _adam(betas, float(eps), True, float(weight_decay))


def adamw(betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-2):
    return _adam(betas, float(eps), False, float(weight_decay))


OPTIMIZERS = {"sgd": sgd, "adam": adam, "adamw": adamw}
SCHEDULES = {"yolo_lr": yolo_lr, "multi_step": multi_step}

# (parameter, gradient, its state, update count) -> the direction -lr scales
Update = Callable[[torch.Tensor, torch.Tensor, dict, int], torch.Tensor]


def rules(cfg: dict) -> Tuple[Update, Callable[[int], float]]:
    """The configuration's update (``optimizer`` with its
    ``optimizer_options``) and its rate at an update count (``scheduler``
    with its ``scheduler_options``).  A name the reference does not know
    raises, naming its key."""
    for key, known in (("optimizer", OPTIMIZERS), ("scheduler", SCHEDULES)):
        if cfg.get(key) not in known:
            raise ValueError(
                f"configuration key {key!r}: {cfg.get(key)!r} is none of "
                f"the reference's {sorted(known)} (posebench/reference/"
                "train.py)")
    opt = dict(cfg["optimizer_options"])
    lr = float(opt.pop("lr"))
    update = OPTIMIZERS[cfg["optimizer"]](**opt)
    schedule, options = SCHEDULES[cfg["scheduler"]], \
        cfg["scheduler_options"]
    return update, lambda count: schedule(count, lr, **options)


def run_steps(cfg: dict, net, weights: Dict[str, torch.Tensor],
              batches: List[dict], gen_seed: int, start_count: int,
              quant=None) -> dict:
    """``len(batches)`` steps of the network module ``net`` from
    ``weights``.  Returns the losses, the norm of each parameter's first
    gradient and of its change over the steps (keys: ``net.groups``), the
    first step's logits, and each parameter's group."""
    kind = cfg["kind"]
    update, rate = rules(cfg)
    loss_fn = getattr(net, "loss", None) or (
        targets.sbp_loss if kind == "sbp" else targets.spm_loss)
    dev = batches[0]["image"].device
    gen = torch.Generator(dev).manual_seed(gen_seed)
    host_gen = torch.Generator().manual_seed(gen_seed)
    groups = net.groups(cfg)
    keys = list(groups)
    p = {key: v.detach().clone().float() for key, v in weights.items()}
    p0 = {key: p[key].clone() for key in keys}
    state = {key: {} for key in keys}
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
        logits = net.forward(p, img, cfg, True, quant)
        loss = loss_fn(logits, target)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if first is None:
                first = {key: float(g.norm()) for key, g in zip(keys, grads)}
                first_logits = logits.detach().cpu()
            count = start_count + i
            lr = rate(count)
            for key, g in zip(keys, grads):
                u = update(p[key].detach(), g, state[key], count + 1)
                p[key] = p[key].detach() - lr * u
        del logits, loss, grads, leaves
    with torch.no_grad():
        change = {key: float((p[key] - p0[key]).norm()) for key in keys}
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "logits": first_logits, "groups": groups}
