"""Optimizers and LR schedules.

Counterpart of pytorch_pose_estimation_tpu/optim.py (reference:
utils/module_select.py:13-35, module/lr_scheduler.py:10-92).  Each optimizer
computes the update of the JAX package's optax chain, in the chain's order,
not ``torch.optim``'s:

* sgd, adam, radam and rmsprop add the weight decay to the gradient before
  their statistics; adamw adds it after ``scale_by_adam``;
* sgd: ``trace`` (``t = g + m t``; nesterov ``g + m t``), dampening is
  accepted and ignored, as the JAX package's ``_sgd`` ignores it;
* adam / adamw: bias-corrected moments, ``m / (sqrt(v) + eps)``;
* radam: optax's rectification (threshold 5 on rho, eps outside the root);
* rmsprop: ``g / sqrt(v + eps)`` (optax's ``scale_by_rms``;
  ``torch.optim.RMSprop`` computes ``g / (sqrt(v) + eps)``), then an optional
  plain ``trace``.

Schedules are pure functions of the update count, and the first update uses
``schedule(0)`` (for ``yolo_lr`` that is lr 0).  Bias corrections and
radam's rectification are computed in float32 on the host, as optax computes
them in float32.  ``freeze_subtrees`` leaves the named subtrees out of the
optimizer: they get no update, no weight decay and no momentum
(``optax.set_to_zero``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

Schedule = Callable[[int], float]

# flax top-level subtree -> the port's module name (reference keys)
_SUBTREES = {"backbone": "backbone_features_module", "head": "sbp_head"}


# --------------------------------------------------------------------------
# LR schedules
# --------------------------------------------------------------------------

def yolo_lr(lr: float, burn_in: int, steps: Sequence[int],
            scales: Sequence[float]) -> Schedule:
    """Quartic burn-in ``lr (t / burn_in)^4``, then ``lr`` times the product
    of the ``scales`` whose ``steps`` have been reached."""
    bounds = list(zip((float(s) for s in steps), (float(c) for c in scales)))

    def schedule(count: int) -> float:
        t = float(count)
        if t < burn_in:
            return lr * (t / burn_in) ** 4
        return lr * math.prod(c for s, c in bounds if s <= t)

    return schedule


def multi_step(lr: float, milestones: Sequence[int], gamma: float
               ) -> Schedule:
    def schedule(count: int) -> float:
        return lr * gamma ** sum(1 for m in milestones if m <= count)

    return schedule


def cosine_annealing_warm_restarts(lr: float, T_0: int, T_mult: int = 1,
                                   eta_min: float = 0.0) -> Schedule:
    """torch.optim.lr_scheduler.CosineAnnealingWarmRestarts semantics."""

    def schedule(count: int) -> float:
        t = float(count)
        if T_mult == 1:
            t_cur, t_i = t % T_0, float(T_0)
        else:
            n = math.floor(math.log(t / T_0 * (T_mult - 1) + 1.0)
                           / math.log(T_mult))
            t_cur = t - T_0 * (T_mult ** n - 1.0) / (T_mult - 1.0)
            t_i = T_0 * T_mult ** n
        return eta_min + (lr - eta_min) * (
            1 + math.cos(math.pi * t_cur / t_i)) / 2

    return schedule


def cosine_annealing_warm_up_restarts(lr: float, T_0: int, T_mult: int = 1,
                                      eta_max: float = 0.1, T_up: int = 0,
                                      gamma: float = 1.0) -> Schedule:
    """Warm-up + cosine restarts with peak decay.  ``lr`` is the floor; the
    peak of cycle ``n`` is ``eta_max * gamma**n``; cycle ``n`` spans
    ``T_up + (T_0 - T_up) * T_mult**n`` updates: a linear ramp for ``T_up``,
    a cosine decay for the rest."""
    span0 = float(T_0 - T_up)

    def start(n: int) -> float:
        return n * T_up + span0 * (T_mult ** n - 1) / (T_mult - 1)

    def schedule(count: int) -> float:
        t = float(count)
        if T_mult == 1:
            cycle = math.floor(t / T_0)
            t_cur, t_i = t - cycle * T_0, float(T_0)
        else:
            cycle = 0
            while start(cycle + 1) <= t:
                cycle += 1
            t_cur = t - start(cycle)
            t_i = T_up + span0 * T_mult ** cycle
        peak = eta_max * gamma ** cycle
        if t_cur < T_up:
            return (peak - lr) * t_cur / max(T_up, 1) + lr
        return lr + (peak - lr) * (
            1 + math.cos(math.pi * (t_cur - T_up) / (t_i - T_up))) / 2

    return schedule


_SCHEDULES = {
    "multi_step": multi_step,
    "cosine_annealing_warm_restarts": cosine_annealing_warm_restarts,
    "cosine_annealing_warm_up_restarts": cosine_annealing_warm_up_restarts,
    "yolo_lr": yolo_lr,
}


def _constant(lr: float) -> Schedule:
    return lambda count: lr


def get_scheduler(name: Optional[str], lr: float, **options
                  ) -> Optional[Schedule]:
    """An LR schedule by registry name; a None name gives the constant lr,
    an unknown name None."""
    if name is None:
        return _constant(lr)
    factory = _SCHEDULES.get(name)
    return None if factory is None else factory(lr, **options)


# --------------------------------------------------------------------------
# Optimizers
# --------------------------------------------------------------------------

def _f32(x) -> float:
    """A host scalar rounded to float32, as optax computes it."""
    return float(np.float32(x))


def _bias_correction(decay: float, count: int) -> float:
    return _f32(np.float32(1) - np.float32(decay) ** np.float32(count))


class ChainOptimizer(torch.optim.Optimizer):
    """Base of the optax chains: one parameter group, a schedule read at the
    update count (from 0), per-parameter state tensors.  ``step()`` reads
    ``p.grad`` and skips parameters without one.  ``count`` is saved in the
    state_dict."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule,
                 **defaults):
        super().__init__(params, defaults)
        self.schedule = schedule
        self.count = 0

    def _update(self, p: torch.Tensor, g: torch.Tensor, state: Dict,
                group: Dict, count: int) -> torch.Tensor:
        """The chain's update before the learning rate (the direction that
        ``-lr`` scales)."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("closures are not supported")
        lr = float(self.schedule(self.count))
        count = self.count + 1  # optax's count after this update
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = self._update(p, p.grad, self.state[p], group, count)
                p.add_(u.mul_(_f32(-lr)))
        self.count = count

    def state_dict(self):
        out = super().state_dict()
        out["count"] = self.count
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)


def _moment(state: Dict, name: str, p: torch.Tensor) -> torch.Tensor:
    """The state tensor ``name``, zeros before the first update.  Updates
    replace the state's tensors rather than write into them, so a loaded
    state_dict never shares storage with the one it came from."""
    if name not in state:
        state[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return state[name]


def _ema(state: Dict, name: str, value: torch.Tensor, decay: float,
         p: torch.Tensor) -> torch.Tensor:
    """optax's ``update_moment``: ``(1 - decay) * value + decay * t``."""
    state[name] = value * (1 - decay) + _moment(state, name, p) * decay
    return state[name]


def _decayed(g: torch.Tensor, p: torch.Tensor, wd: float) -> torch.Tensor:
    """``add_decayed_weights``: ``g + wd * p`` (a new tensor)."""
    return g + p * wd if wd else g.clone()


class SGD(ChainOptimizer):
    def __init__(self, params, schedule, momentum=0.0, weight_decay=0.0,
                 nesterov=False, dampening=0.0):
        super().__init__(params, schedule, momentum=momentum,
                         weight_decay=weight_decay, nesterov=nesterov)

    def _update(self, p, g, state, group, count):
        g = _decayed(g, p, group["weight_decay"])
        m = group["momentum"]
        if not m:
            return g
        t = state["trace"] = g + _moment(state, "trace", p) * m
        return g + t * m if group["nesterov"] else t.clone()


def _adam_direction(p, g, state, group, count):
    b1, b2 = group["betas"]
    mu = _ema(state, "mu", g, b1, p)
    nu = _ema(state, "nu", g * g, b2, p)
    mu_hat = mu / _bias_correction(b1, count)
    nu_hat = nu / _bias_correction(b2, count)
    return mu_hat, nu_hat


class Adam(ChainOptimizer):
    def __init__(self, params, schedule, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        super().__init__(params, schedule, betas=tuple(betas), eps=eps,
                         weight_decay=weight_decay)

    def _update(self, p, g, state, group, count):
        g = _decayed(g, p, group["weight_decay"])
        mu_hat, nu_hat = _adam_direction(p, g, state, group, count)
        return mu_hat / (nu_hat.sqrt() + group["eps"])


class AdamW(ChainOptimizer):
    def __init__(self, params, schedule, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-2):
        super().__init__(params, schedule, betas=tuple(betas), eps=eps,
                         weight_decay=weight_decay)

    def _update(self, p, g, state, group, count):
        mu_hat, nu_hat = _adam_direction(p, g, state, group, count)
        u = mu_hat / (nu_hat.sqrt() + group["eps"])
        return u + p * group["weight_decay"]


class RAdam(ChainOptimizer):
    THRESHOLD = 5.0  # optax scale_by_radam's default

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        super().__init__(params, schedule, betas=tuple(betas), eps=eps,
                         weight_decay=weight_decay)

    def _update(self, p, g, state, group, count):
        g = _decayed(g, p, group["weight_decay"])
        mu_hat, nu_hat = _adam_direction(p, g, state, group, count)
        # optax's arithmetic: ro_inf in double, the rest in float32
        b2 = group["betas"][1]
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        f32_ro_inf = np.float32(ro_inf)
        b2t = np.float32(b2) ** np.float32(count)
        ro = f32_ro_inf - np.float32(2 * count) * b2t / (np.float32(1) - b2t)
        if ro < self.THRESHOLD:
            return mu_hat
        r = np.sqrt((ro - np.float32(4)) * (ro - np.float32(2)) * f32_ro_inf
                    / (np.float32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        return mu_hat * _f32(r) / (nu_hat.sqrt() + group["eps"])


class RMSprop(ChainOptimizer):
    def __init__(self, params, schedule, alpha=0.99, eps=1e-8,
                 weight_decay=0.0, momentum=0.0):
        super().__init__(params, schedule, alpha=alpha, eps=eps,
                         weight_decay=weight_decay, momentum=momentum)

    def _update(self, p, g, state, group, count):
        g = _decayed(g, p, group["weight_decay"])
        nu = _ema(state, "nu", g * g, group["alpha"], p)
        u = g * torch.rsqrt(nu + group["eps"])
        m = group["momentum"]
        if not m:
            return u
        state["trace"] = u + _moment(state, "trace", p) * m
        return state["trace"].clone()


_OPTIMIZERS = {
    "sgd": SGD,
    "adam": Adam,
    "radam": RAdam,
    "adamw": AdamW,
    "rmsprop": RMSprop,
}


def get_optimizer(name: str, params: Iterable[torch.Tensor],
                  lr: float = 1e-3, schedule: Optional[Schedule] = None,
                  **options) -> Optional[ChainOptimizer]:
    """An optimizer over ``params`` by registry name with torch-style
    keyword options; ``schedule`` overrides the constant ``lr``.  Unknown
    names return None (the reference registry's ``.get()``)."""
    cls = _OPTIMIZERS.get(name)
    if cls is None:
        return None
    return cls(params, schedule or _constant(lr), **options)


def freeze_subtrees(model: nn.Module, frozen_names: Sequence[str]
                    ) -> List[nn.Parameter]:
    """The parameters outside the named top-level subtrees (the JAX names:
    ``backbone``, ``head``, ``deconv_N``), for the optimizer; the rest stay
    as they are (the reference's set_parameter_requires_grad,
    utils/utility.py:17-20)."""
    frozen = [_SUBTREES.get(n, n) for n in frozen_names]
    children = dict(model.named_children())
    unknown = [n for n in frozen if n not in children]
    if unknown:
        raise ValueError(f"no subtree named {unknown} in the model "
                         f"(has {sorted(children)})")
    return [p for name, child in children.items() if name not in frozen
            for p in child.parameters()]


def build_optimizer_from_cfg(cfg: dict, model: nn.Module) -> tuple:
    """(optimizer over ``model``, schedule) from a flat experiment config,
    with the reference's fall-back to a constant lr when the scheduler keys
    are absent (reference: module/sbp_detector.py:47-71)."""
    opt_options = dict(cfg.get("optimizer_options", {}))
    lr = opt_options.pop("lr", 1e-3)
    if "betas" in opt_options:
        opt_options["betas"] = tuple(opt_options["betas"])

    schedule = None
    if "scheduler" in cfg and "scheduler_options" in cfg:
        schedule = get_scheduler(cfg["scheduler"], lr,
                                 **cfg["scheduler_options"])
    if schedule is None:
        schedule = _constant(lr)

    params = freeze_subtrees(model, cfg["freeze"]) if cfg.get("freeze") \
        else list(model.parameters())
    opt = get_optimizer(cfg["optimizer"], params, lr=lr, schedule=schedule,
                        **opt_options)
    return opt, schedule
