"""The port's optimizers and schedules (pytorch_pose_estimation_tpu_torch/
optim.py) against the JAX package's optax chains and schedule functions, on
the same parameters and gradients (numpy-seeded), on the CPU.

Tolerances: schedules rtol 1e-6 and atol 1e-7 of the schedule's peak (the
port computes them in double, JAX in float32: an ulp of float32 relative to
the value, or to the peak where a cosine nears its floor).  Parameters after
N updates rtol 1e-6, atol 1e-7 for sgd and rmsprop: both sides run the same
float32 operations in the same order, except the learning rate itself (the
ulp above) and rsqrt / sqrt, which may differ by an ulp between XLA and
torch.  adam, adamw and radam rtol 5e-5: their bias corrections divide by
1 - b^t, and XLA's float32 pow and numpy's may differ by an ulp, so an
ulp of b^t becomes up to b^t / (1 - b^t) ulps, ~1e-5 relative at
b2 = 0.999 in the first updates (radam measured 1.6e-5)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from pytorch_pose_estimation_tpu import optim as jax_optim
from pytorch_pose_estimation_tpu_torch import optim
from pytorch_pose_estimation_tpu_torch.config import get_configs

SHAPES = {"w": (4, 3), "b": (5,)}

SCHEDULES = {
    "yolo_lr": dict(burn_in=4, steps=[7, 9], scales=[0.1, 0.5]),
    "multi_step": dict(milestones=[3, 5, 5], gamma=0.5),
    "cosine_annealing_warm_restarts": dict(T_0=5, T_mult=1, eta_min=1e-4),
    "cosine_annealing_warm_restarts-Tmult2": dict(T_0=3, T_mult=2,
                                                  eta_min=1e-4),
    "cosine_annealing_warm_up_restarts": dict(T_0=6, T_mult=1, eta_max=0.1,
                                              T_up=2, gamma=0.9),
    "cosine_annealing_warm_up_restarts-Tmult2": dict(
        T_0=5, T_mult=2, eta_max=0.1, T_up=2, gamma=0.9),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_matches_jax(case):
    name = case.split("-")[0]
    lr = 1e-3 if name != "cosine_annealing_warm_up_restarts" else 1e-4
    ours = optim.get_scheduler(name, lr, **SCHEDULES[case])
    theirs = jax_optim.get_scheduler(name, lr, **SCHEDULES[case])
    counts = range(0, 40)
    got = np.array([ours(t) for t in counts])
    want = np.array([float(theirs(jnp.asarray(t))) for t in counts])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * want.max())
    assert len(set(np.round(got, 12))) >= 3  # the schedule moves


def test_yolo_lr_first_update_is_zero():
    assert optim.yolo_lr(1e-3, 4, [7], [0.1])(0) == 0.0


# (optimizer, options, schedule case or None, number of updates)
OPT_CASES = {
    "sgd-nesterov-wd-yolo": ("sgd", dict(momentum=0.9, weight_decay=5e-3,
                                         nesterov=True), "yolo_lr", 6),
    "sgd-momentum": ("sgd", dict(momentum=0.9), "multi_step", 5),
    "sgd-plain-wd": ("sgd", dict(weight_decay=1e-2), None, 5),
    "adam-wd": ("adam", dict(betas=(0.8, 0.95), weight_decay=1e-2),
                "cosine_annealing_warm_restarts", 5),
    "adamw": ("adamw", dict(weight_decay=5e-2), None, 5),
    # ro passes the threshold 5 at the 6th update with b2=0.999
    "radam-across-switch": ("radam", dict(weight_decay=1e-3),
                            "multi_step", 10),
    "rmsprop": ("rmsprop", dict(alpha=0.9, eps=1e-6), None, 5),
    "rmsprop-momentum-wd": ("rmsprop", dict(alpha=0.9, momentum=0.8,
                                            weight_decay=1e-2),
                            "cosine_annealing_warm_up_restarts", 6),
}


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(rng):
    return {k: (rng.randn(*s) * 0.5).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(name, options, schedule_case, n_updates, lr=0.05):
    sched_name = schedule_case.split("-")[0] if schedule_case else None
    sopts = SCHEDULES[schedule_case] if schedule_case else {}
    init = _params()
    # JAX: optax chain on a dict of arrays
    tx = jax_optim.get_optimizer(
        name, lr=lr, schedule=jax_optim.get_scheduler(sched_name, lr,
                                                      **sopts),
        **options)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)
    # port: the same chain over nn.Parameters
    ours = {k: nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in init.items()}
    opt = optim.get_optimizer(
        name, list(ours.values()), lr=lr,
        schedule=optim.get_scheduler(sched_name, lr, **sopts), **options)
    rng = np.random.RandomState(1)
    for _ in range(n_updates):
        grads = _grads(rng)
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in ours.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
    assert opt.count == n_updates
    return ({k: p.detach().numpy() for k, p in ours.items()},
            {k: np.asarray(v) for k, v in params.items()}, init)


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax_chain(case):
    name = OPT_CASES[case][0]
    got, want, init = _run_both(*OPT_CASES[case])
    rtol = 5e-5 if name in ("adam", "adamw", "radam") else 1e-6
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7,
                                   err_msg=k)
        assert np.abs(got[k] - init[k]).max() > 1e-3  # the params moved


def test_rmsprop_is_not_torch_rmsprop():
    """optax's eps sits inside the root: torch.optim.RMSprop, with eps
    outside, lands elsewhere on the same gradients (the case the chain
    test would miss if both rules were close)."""
    got, _, init = _run_both("rmsprop", dict(alpha=0.9, eps=1e-2), None, 3)
    p = {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    ref = torch.optim.RMSprop(list(p.values()), lr=0.05, alpha=0.9, eps=1e-2)
    rng = np.random.RandomState(1)
    for _ in range(3):
        grads = _grads(rng)
        for k, q in p.items():
            q.grad = torch.from_numpy(grads[k])
        ref.step()
    gap = max(np.abs(got[k] - p[k].detach().numpy()).max() for k in SHAPES)
    assert gap > 1e-3


class _Toy(nn.Module):
    """The SBP's top-level children, tiny."""

    def __init__(self):
        super().__init__()
        self.backbone_features_module = nn.Linear(3, 4, bias=False)
        self.deconv_1 = nn.Linear(4, 4, bias=False)
        self.sbp_head = nn.Linear(4, 2, bias=False)


_FLAX_NAMES = {"backbone_features_module": "backbone", "deconv_1": "deconv_1",
               "sbp_head": "head"}


def test_freeze_subtrees_matches_jax():
    """freeze 'backbone': no update, no weight decay, no momentum for it;
    the rest as the JAX multi_transform gives."""
    torch.manual_seed(0)
    model = _Toy()
    init = {n: c.weight.detach().numpy().copy()
            for n, c in model.named_children()}
    trainable = optim.freeze_subtrees(model, ["backbone"])
    assert {id(p) for p in trainable} == {
        id(model.deconv_1.weight), id(model.sbp_head.weight)}
    opts = dict(momentum=0.9, weight_decay=1e-2, nesterov=True)
    opt = optim.get_optimizer("sgd", trainable, lr=0.1, **opts)
    tx = jax_optim.freeze_subtrees(
        jax_optim.get_optimizer("sgd", lr=0.1, **opts), ["backbone"])
    params = {_FLAX_NAMES[n]: {"kernel": jnp.asarray(w)}
              for n, w in init.items()}
    opt_state = tx.init(params)
    rng = np.random.RandomState(2)
    for _ in range(3):
        grads = {n: rng.randn(*w.shape).astype(np.float32)
                 for n, w in init.items()}
        for n, c in model.named_children():
            c.weight.grad = torch.from_numpy(grads[n])
        updates, opt_state = tx.update(
            {_FLAX_NAMES[n]: {"kernel": jnp.asarray(g)}
             for n, g in grads.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.step()
    for n, c in model.named_children():
        np.testing.assert_allclose(
            c.weight.detach().numpy(),
            np.asarray(params[_FLAX_NAMES[n]]["kernel"]), rtol=1e-6,
            atol=1e-7, err_msg=n)
    np.testing.assert_array_equal(model.backbone_features_module.weight
                                  .detach().numpy(),
                                  init["backbone_features_module"])
    with pytest.raises(ValueError, match="no subtree"):
        optim.freeze_subtrees(model, ["neck"])


def test_build_optimizer_from_cfg_reference_recipe():
    cfg = get_configs("configs/sbp_coco.yaml")
    model = _Toy()
    opt, schedule = optim.build_optimizer_from_cfg(cfg, model)
    _, jax_schedule = jax_optim.build_optimizer_from_cfg(cfg)
    assert isinstance(opt, optim.SGD)
    group = opt.param_groups[0]
    assert (group["momentum"], group["weight_decay"], group["nesterov"]) == \
        (0.9, 5e-3, True)
    assert len(group["params"]) == 3
    for t in (0, 1, 1000, 1999, 2000, 104999, 105000, 200000):
        np.testing.assert_allclose(schedule(t), float(jax_schedule(t)),
                                   rtol=1e-6)
    assert schedule(0) == 0.0 and schedule(105000) == pytest.approx(1e-4)
    # freeze from the config; without scheduler keys, a constant lr
    cfg2 = dict(cfg, freeze=["backbone", "head"])
    del cfg2["scheduler"]
    opt2, schedule2 = optim.build_optimizer_from_cfg(cfg2, model)
    assert opt2.param_groups[0]["params"] == [model.deconv_1.weight]
    assert schedule2(0) == schedule2(10 ** 6) == 1e-3


def test_unknown_names_return_none():
    assert optim.get_optimizer("lamb", [nn.Parameter(torch.zeros(1))]) is None
    assert optim.get_scheduler("one_cycle", 1e-3) is None
    assert optim.get_scheduler(None, 1e-3)(123) == 1e-3


def test_count_survives_state_dict():
    p = nn.Parameter(torch.ones(3))
    opt = optim.get_optimizer("adam", [p], lr=0.1)
    for _ in range(2):
        p.grad = torch.full((3,), 0.5)
        opt.step()
    q = nn.Parameter(p.detach().clone())
    opt2 = optim.get_optimizer("adam", [q], lr=0.1)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.count == 2
    p.grad = q.grad = torch.full((3,), -0.25)
    opt.step()
    opt2.step()
    assert torch.equal(p, q)
