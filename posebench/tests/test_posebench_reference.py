"""The plain reference against the port at a small size on the CPU: the
same draws from the same generators, the same rows from the cache, the
same maps, network, loss and update; the augmentation's resampling within
the port's bf16 rounding of pixels and weights."""

import numpy as np
import pytest
import torch

from pytorch_pose_estimation_tpu_torch import losses as port_losses
from pytorch_pose_estimation_tpu_torch import optim as port_optim
from pytorch_pose_estimation_tpu_torch.ops import image as port_image
from pytorch_pose_estimation_tpu_torch.ops import targets as port_targets
from pytorch_pose_estimation_tpu_torch.train import (DeviceDataCache,
                                                     build_model)
from pytorch_pose_estimation_tpu_torch.train import steps as port_steps

from posebench import harness, judge
from posebench.entries import train as train_entry
from posebench.reference import augment, targets
from posebench.reference import train as ref_train
from posebench_tiny import tiny

SBP_AUG = tiny("sbp_train_b256").config["augment"]
SPM_AUG = tiny("spm_train_b32").config["augment"]
# the port rounds pixels and interpolation weights to bf16 at each of its
# three shears and the crop's two passes: about 2^-8 a pass
RESAMPLE_ATOL = 0.02


def gens(seed=5):
    return torch.Generator().manual_seed(seed), \
        torch.Generator().manual_seed(seed)


def port_draws(b, hw):
    g, h = gens()
    a = SBP_AUG
    return port_image.sample_augment(
        g, b, hw, rotate_limit=a["rotate_limit"],
        scale_range=tuple(a["scale_range"]),
        ratio_range=tuple(a["ratio_range"]),
        jitter_params=tuple(a["color_jitter"]), clahe_prob=a["clahe_prob"],
        rotate_prob=a["rotate_prob"], jitter_prob=a["jitter_prob"],
        angle_groups=a["angle_groups"], host_gen=h)


def batch(b=8, hw=(64, 32), seed=0):
    r = np.random.default_rng(seed)
    imgs = torch.from_numpy(r.integers(0, 256, (b, *hw, 3), dtype=np.uint8))
    joints = torch.from_numpy(r.uniform(0, 1, (b, 17, 2)).astype(
        np.float32)) * torch.tensor([hw[1], hw[0]], dtype=torch.float32)
    vis = torch.from_numpy((r.uniform(size=(b, 17)) < 0.7).astype(
        np.float32))
    return imgs, joints, vis


def test_samplers_draw_the_ports_numbers():
    pd = port_draws(16, (64, 32))
    g, h = gens()
    geo, ph = augment.sample_geometric(g, h, 16, (64, 32), SBP_AUG)
    for a, b in [(pd.angles, geo.angles), (pd.rotate, geo.rotate),
                 (pd.x0, geo.x0), (pd.cw, geo.cw), (pd.y0, geo.y0),
                 (pd.brightness, ph.brightness), (pd.hue, ph.hue),
                 (pd.clahe_clip, ph.clahe_clip), (pd.jitter, ph.jitter)]:
        assert torch.equal(a, b)
    assert pd.jitter_order == ph.order
    g, h = gens()
    pp = port_image.sample_photometric(
        g, 16, tuple(SPM_AUG["color_jitter"]), SPM_AUG["clahe_prob"],
        SPM_AUG["jitter_prob"], host_gen=h)
    g, h = gens()
    rp = augment.sample_photometric(g, h, 16, SPM_AUG["color_jitter"],
                                    SPM_AUG["clahe_prob"],
                                    SPM_AUG["jitter_prob"])
    assert torch.equal(pp.contrast, rp.contrast) and \
        torch.equal(pp.clahe, rp.clahe) and pp.jitter_order == rp.order


@pytest.mark.parametrize("part", ["rotate", "crop", "clahe", "jitter"])
def test_augmentation_parts(part):
    imgs, _, _ = batch()
    x = port_image.normalize_batch(imgs)
    d = port_draws(8, (64, 32))
    if part == "rotate":
        got = port_image.rotate_shear3_grouped(x, d.angles, 32.0, 16.0)
        want = augment.rotate(x, d.angles.repeat_interleave(
            8 // d.angles.shape[0]))
        tol = RESAMPLE_ATOL
    elif part == "crop":
        got = port_image.crop_resize_mxu(x, d.x0, d.y0, d.cw, d.ch)
        want = augment.crop_resize(x, d.x0, d.y0, d.cw, d.ch)
        tol = RESAMPLE_ATOL
    elif part == "clahe":
        got = port_image.clahe_luma(x, d.clahe_clip)
        want = augment.clahe(x, d.clahe_clip)
        tol = 1e-6
    else:
        got = port_image.color_jitter_batch(
            x, d.brightness, d.contrast, d.saturation, d.hue,
            d.jitter_order, d.jitter)
        want = augment.color_jitter(x, augment.Photometric(
            d.brightness, d.contrast, d.saturation, d.hue, d.jitter_order,
            d.jitter, None, None))
        tol = 1e-6
    assert (got - want).abs().max() <= tol


def test_geometric_chain_and_sbp_maps():
    imgs, joints, vis = batch()
    d = port_draws(8, (64, 32))
    pi, pj, pv = port_image.augment_batch_core(imgs, joints, vis, d,
                                               (64, 32))
    g, h = gens()
    geo, ph = augment.sample_geometric(g, h, 8, (64, 32), SBP_AUG)
    ri, rj, rv = augment.geometric(imgs, joints, vis, geo, ph)
    # CLAHE's 256-bin luma maps turn the rounding's shifts into whole bins
    assert (pi - ri).abs().max() <= 0.1
    assert (pi - ri).abs().mean() <= 2e-3
    assert torch.allclose(pj, rj, atol=1e-4) and torch.equal(pv, rv)
    port = port_steps._sbp_targets(rj, rv, 0.25, (16, 8), 17, 2.0)
    assert torch.equal(port, targets.sbp_heatmaps(rj, rv, 0.25, (16, 8),
                                                  2.0))


def test_spm_maps_and_losses():
    cell = tiny("spm_train_b32")
    from posebench import traffic
    arrays = traffic.cache_arrays(cell.traffic, cell.config, 7)
    j = torch.from_numpy(arrays["joints"][:4])
    c = torch.from_numpy(arrays["centers"][:4])
    port = port_steps._spm_targets(j, c, 0.25, 16, 17, 1.0)
    ref = targets.spm_target(c, j, 0.25, 16, 1.0)
    assert torch.equal(port, ref)
    logits = torch.randn(port.shape, generator=torch.Generator()
                         .manual_seed(1))
    assert port_losses.spm_loss(logits, port).item() == \
        pytest.approx(targets.spm_loss(logits, ref).item(), rel=1e-6)
    sbp_t = port_targets.sbp_heatmaps(torch.rand(2, 17, 2) * 8, (16, 8), 17,
                                      2.0)
    sbp_l = torch.randn(sbp_t.shape)
    assert port_losses.sbp_loss(sbp_l, sbp_t).item() == \
        pytest.approx(targets.sbp_loss(sbp_l, sbp_t).item(), rel=1e-6)


@pytest.mark.parametrize("kind", ["sbp", "spm"])
def test_network_matches_the_port_in_fp32(kind):
    cfg = {"kind": kind, "num_keypoints": 17, "input_size": 64,
           "init": {"bn_shift": 1.0}}
    net = harness.network(cfg)
    w = net.weights(cfg, 11, "cpu")
    port = build_model({"num_keypoints": 17, "precision": "fp32"}, kind)
    x = torch.rand(4, 3, 64, 64)
    for train in (True, False):
        port.load_state_dict(w)   # train mode moves the running statistics
        port.train(train)
        with torch.no_grad():
            got = port(x)
            want = net.forward(w, x, cfg, train)
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cache_rows_are_the_ports():
    arrays = {"image": np.arange(40, dtype=np.int64)[:, None]}
    seed = 2 ** 31 + 99
    cache = DeviceDataCache(arrays, 8, seed=seed, device="cpu")
    got = [b["image"][:, 0].numpy() for _, b in
           zip(range(3), cache.epoch_batches(0))]
    assert np.array_equal(np.stack(got), ref_train.cache_rows(40, seed, 8, 3))


def test_first_step_and_update_match_the_port():
    """SPM in fp32 (no resampling): the first step's loss and gradients,
    and the optimizer's update (its count past the burn-in)."""
    cell = tiny("spm_train_b32")
    prog = train_entry.Program(cell, torch.device("cpu"))
    got = prog.checked_steps(1)
    ref = train_entry.reference(cell, prog.arrays, torch.device("cpu"), 1)
    assert got["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-5)
    n = judge.train_numbers(got, ref)
    assert n["grad_gap"] < 0.01 and n["update_gap"] < 0.01


def test_seeded_weights_are_lecun_normal():
    cfg = tiny("sbp_train_b256").config
    w = harness.network(cfg).weights(cfg, harness.torch_seed(3, 3), "cpu")
    k = w["backbone_features_module.5.3.conv.weight"]   # 1024 x 512 x 3 x 3
    assert k.std().item() == pytest.approx((1 / (512 * 9)) ** 0.5, rel=0.01)
    assert k.abs().max() <= 2 * (1 / (512 * 9)) ** 0.5 / 0.8796 + 1e-6


# (optimizer, its options, schedule, its options, the first update count):
# the cells' SGD, and Adam, AdamW and multi_step as mmpose's configurations
# use them; each schedule's rate changes inside the three steps
UPDATES = [
    ("sgd", {"lr": 1e-3, "momentum": 0.9, "weight_decay": 5e-3,
             "nesterov": True},
     "yolo_lr", {"burn_in": 4, "steps": [4], "scales": [0.1]}, 2),
    ("sgd", {"lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-4},
     "multi_step", {"milestones": [1, 2], "gamma": 0.1}, 0),
    ("adam", {"lr": 5e-4}, "multi_step",
     {"milestones": [171, 172], "gamma": 0.1}, 170),
    ("adam", {"lr": 1e-3, "betas": [0.8, 0.99], "eps": 1e-6,
              "weight_decay": 1e-4},
     "yolo_lr", {"burn_in": 2, "steps": [3], "scales": [0.5]}, 1),
    ("adamw", {"lr": 1e-3, "weight_decay": 0.05}, "multi_step",
     {"milestones": [1], "gamma": 0.5}, 0),
]


@pytest.mark.parametrize("name,options,schedule,sched_options,start",
                         UPDATES, ids=[f"{u[0]}-{u[2]}" for u in UPDATES])
def test_update_rules_match_the_port(name, options, schedule, sched_options,
                                     start):
    """Three steps of the reference's rule and the port's optimizer from
    the same parameters and gradients: each tensor's change agrees within
    1e-6 of its norm."""
    gen = torch.Generator().manual_seed(17)
    shapes = [(64, 32, 3, 3), (64,), (17, 64, 1, 1)]
    p0 = [torch.randn(s, generator=gen) * 0.1 for s in shapes]
    grads = [[torch.randn(s, generator=gen) * 0.01 for s in shapes]
             for _ in range(3)]
    cfg = {"optimizer": name, "optimizer_options": options,
           "scheduler": schedule, "scheduler_options": sched_options}
    update, rate = ref_train.rules(cfg)
    ref, state = [p.clone() for p in p0], [{} for _ in p0]
    for i, gs in enumerate(grads):
        lr = rate(start + i)
        ref = [p - lr * update(p, g, st, start + i + 1)
               for p, g, st in zip(ref, gs, state)]
    opts = dict(options)
    lr = opts.pop("lr")
    params = [torch.nn.Parameter(p.clone()) for p in p0]
    port = port_optim.get_optimizer(
        name, params, lr=lr, schedule=port_optim.get_scheduler(
            schedule, lr, **sched_options), **opts)
    port.count = start
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = g.clone()
        port.step()
    for p, r, q0 in zip(params, ref, p0):
        change = r - q0
        assert change.norm() > 0
        assert (p.detach() - r).norm() <= 1e-6 * change.norm()


def test_an_unknown_rule_names_its_key():
    cfg = tiny("sbp_train_b256").config
    for key, value in (("optimizer", "rmsprop"),
                       ("scheduler", "cosine_annealing_warm_restarts")):
        with pytest.raises(ValueError, match=f"'{key}'.*'{value}'"):
            ref_train.rules(dict(cfg, **{key: value}))
