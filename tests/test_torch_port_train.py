"""The port's SBP training (BatchNorm updates, remat, the train step,
checkpoints, the loader and ``Trainer.fit``) against the JAX package, on
the CPU, in fp32 (TF32 plays no part on the CPU; JAX at "highest" matmul
precision).  Full-width SBP at a 64x64 input, batch 2, weights from the JAX
package's init through ``from_jax_variables``, as
tests/test_differential_train.py does; augmentation draws repeat the JAX
key splits (``jax_draws``).

Tolerances:
* BN running statistics 1e-4 of each tensor's largest value (batch
  statistics summed in another order; flax takes the variance as
  E[x^2] - E[x]^2);
* the loss 1e-6 relative;
* the update of each parameter (new - old) within the one-ulp yardstick of
  tests/_torch_update_gap.py, and 2e-2 of its norm.  Measured
  0.3-1.1%: at this init the loss pushes every logit down, so the gradient
  reaching each train-mode BN is nearly constant per channel, and the BN
  backward subtracts nearly all of it; rounding differences are amplified
  (chip_smoke.py phase 6b prints what one ulp of weight noise does to the
  update at 256x192).  A plain-momentum (not nesterov) update would be 90%
  off.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from pytorch_pose_estimation_tpu import optim as jax_optim
from pytorch_pose_estimation_tpu.data import \
    SBPCOCODataModule as JaxDataModule
from pytorch_pose_estimation_tpu.models import SBP as JaxSBP
from pytorch_pose_estimation_tpu.train.state import create_train_state
from pytorch_pose_estimation_tpu.train.steps import \
    make_sbp_steps as jax_make_sbp_steps
from pytorch_pose_estimation_tpu_torch import optim
from pytorch_pose_estimation_tpu_torch.data import SBPCOCODataModule
from pytorch_pose_estimation_tpu_torch.models import (SBP, from_jax_variables,
                                                      layers)
from pytorch_pose_estimation_tpu_torch.train import (
    CheckpointManager, TrainState, Trainer, extract_backbone,
    load_pretrained, make_sbp_steps, restore_checkpoint,
    restore_checkpoint_flexible, save_checkpoint)

import _torch_update_gap as G
from synth_fixture import COCO_KP_NAMES, make_dataset
from test_torch_port_augment import jax_draws
from test_torch_port_models import calibrated_jax_variables

HW = (64, 64)
OUT = (16, 16)
K = 17
SIGMA = 2.0
AUGMENT = {"clahe_prob": 0.5}  # the JAX defaults plus device CLAHE
DRAW_OPTS = dict(rotate_limit=40.0, scale_range=(0.4, 1.0),
                 ratio_range=(0.4, 1.6), jitter_params=(0.5, 0.2, 0.5, 0.1),
                 clahe_prob=0.5, rotate_prob=0.5, jitter_prob=0.5,
                 angle_groups=16)
SGD = dict(momentum=0.9, weight_decay=5e-3, nesterov=True)


@pytest.fixture(scope="module")
def variables():
    return calibrated_jax_variables()


def _port(variables, **kw):
    model = SBP(K, **kw)
    model.load_state_dict(from_jax_variables(variables))
    return model.train()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bn_keys(sd):
    return [k for k in sd if k.endswith(("running_mean", "running_var"))]


def _stats_gap(got: dict, want: dict) -> float:
    return max(float((got[k] - want[k]).abs().max() / want[k].abs().max())
               for k in _bn_keys(want))


@pytest.mark.parametrize("rule", ["flax", "torch_unbiased"])
def test_bn_running_stats_match_flax(variables, rule, monkeypatch):
    """One train-mode forward: the running statistics match flax's mutated
    batch_stats.  With torch's own update (the unbiased batch variance,
    larger by n/(n-1): n = 8 values per channel in the 2x2 maps of the last
    stage at batch 2) they do not."""
    x = np.random.RandomState(1).rand(2, 3, *HW).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, mutated = JaxSBP(num_keypoints=K).apply(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=True,
            mutable=["batch_stats"])
    want = from_jax_variables({"params": variables["params"],
                               "batch_stats": _np_tree(
                                   mutated["batch_stats"])})
    if rule == "torch_unbiased":
        monkeypatch.setattr(layers.BatchNorm2d, "forward",
                            nn.BatchNorm2d.forward)
    port = _port(variables)
    with torch.no_grad():
        port(torch.from_numpy(x))
    gap = _stats_gap(port.state_dict(), want)
    if rule == "flax":
        assert gap <= 1e-4, gap
    else:
        assert gap > 1e-2, gap  # measured 0.042 (the flax rule: 1.7e-5)


def test_remat_changes_nothing_but_memory(variables):
    """SBP(remat=True) recomputes the backbone in the backward pass: the
    same loss, gradients and running statistics (updated once) as
    without."""
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 3, *HW)
                         .astype(np.float32))
    out = {}
    for remat in (False, True):
        model = _port(variables, remat=remat)
        loss = model(x).square().mean()
        loss.backward()
        out[remat] = (loss.item(), {k: p.grad.clone() for k, p in
                                    model.named_parameters()},
                      model.state_dict())
    assert out[True][0] == out[False][0]
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, rtol=1e-5, atol=1e-7)
    for k in _bn_keys(out[False][2]):
        torch.testing.assert_close(out[True][2][k], out[False][2][k],
                                   rtol=1e-6, atol=0)


def _batches(n, b=2, seed=3):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randint(0, 256, (b,) + HW + (3,), dtype=np.uint8),
             "joints": np.stack([rng.uniform(0, HW[1], (b, K)),
                                 rng.uniform(0, HW[0], (b, K))],
                                -1).astype(np.float32),
             "joints_vis": (rng.rand(b, K) > 0.2).astype(np.float32)}
            for _ in range(n)]


def _port_steps(start: dict, batches, draws, schedule):
    """The port's make_sbp_steps from state_dict ``start``: (losses, the
    model, the optimizer)."""
    port = SBP(K)
    port.load_state_dict(start)
    port.train()
    opt = optim.get_optimizer("sgd", list(port.parameters()),
                              schedule=schedule, **SGD)
    step, _ = make_sbp_steps(port, opt, list(HW), OUT, K, SIGMA, 0.25,
                             augment=AUGMENT)
    losses = []
    for batch, d in zip(batches, draws):
        loss = step({k: torch.from_numpy(v) for k, v in batch.items()},
                    draws=d)
        assert loss.dim() == 0 and not loss.requires_grad
        losses.append(float(loss))
    return np.asarray(losses), port, opt


def _run_both(variables, batches, keys, jax_schedule, port_schedule):
    """The JAX train_step and the port's on the same batches and draws;
    returns (JAX losses, port losses, JAX state, port model, start sd,
    the port's draws)."""
    tx = jax_optim.get_optimizer("sgd", schedule=jax_schedule, **SGD)
    model = JaxSBP(num_keypoints=K)
    state = create_train_state(model, tx, (1,) + HW + (3,))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    jax_step, _ = jax_make_sbp_steps(model, tx, list(HW), OUT, K, SIGMA,
                                     augment=AUGMENT)
    want = []
    for batch, key in zip(batches, keys):
        with jax.default_matmul_precision("highest"):
            state, loss = jax_step(
                state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        want.append(float(loss))
    draws = [jax_draws(key, len(batch["image"]), HW, **DRAW_OPTS)
             for batch, key in zip(batches, keys)]
    start = from_jax_variables(variables)
    got, port, opt = _port_steps(start, batches, draws, port_schedule)
    assert opt.count == int(state.step) == len(batches)
    return np.asarray(want), got, state, port, start, draws


def test_train_step_matches_jax(variables):
    """One train step (augmentation with device CLAHE, K1's plain version,
    forward, loss, backward, nesterov SGD with weight decay under yolo_lr):
    the loss, every parameter's update and the running statistics.  The
    schedule is shifted by 3 updates on both sides: yolo_lr's first update
    has lr 0."""
    jax_yolo = jax_optim.yolo_lr(1e-3, 2, [100], [0.1])
    port_yolo = optim.yolo_lr(1e-3, 2, [100], [0.1])
    batches = _batches(1)
    want, got, state, port, start, draws = _run_both(
        variables, batches, [jax.random.PRNGKey(5)],
        lambda c: jax_yolo(c + 3), lambda c: port_yolo(c + 3))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    jax_sd = from_jax_variables({"params": _np_tree(state.params),
                                 "batch_stats": _np_tree(state.batch_stats)})
    sd = port.state_dict()
    names = [name for name, _ in port.named_parameters()]
    ulp = G.ulp_gaps(lambda s: _port_steps(s, batches, draws,
                                           lambda c: port_yolo(c + 3))[1]
                     .state_dict(), start, sd, names)
    G.assert_update_close(sd, jax_sd, start, ulp, names, bound=2e-2,
                          label="sbp train step")


def test_five_step_loss_trajectory_matches_jax(variables):
    """Five steps from yolo_lr's count 0 (lr 0, then the quartic burn-in),
    fresh batches and draws each step: losses within 5e-4 relative
    (measured 1.2e-4 at the fourth step: the fp32 gradient gap of the
    module docstring, at lr 1e-2), and the loss moves.  The keys are ones for which the jitted JAX augmentation
    equals the port's exactly on these batches (checked when they were
    picked): on other keys XLA's fused hue op moves some pixels on the CPU
    (see test_torch_port_augment.py)."""
    batches = _batches(5, seed=4)
    keys = [jax.random.PRNGKey(k) for k in (101, 110, 112, 121, 122)]
    want, got, _, _, _, _ = _run_both(
        variables, batches, keys, jax_optim.yolo_lr(1e-2, 2, [100], [0.1]),
        optim.yolo_lr(1e-2, 2, [100], [0.1]))
    np.testing.assert_allclose(got, want, rtol=5e-4)
    assert len(set(np.round(got, 3))) == 5


# --------------------------------------------------------------------------
# checkpoints and data
# --------------------------------------------------------------------------

def test_pad_batch_matches_jax():
    from pytorch_pose_estimation_tpu.data.pipeline import \
        pad_batch as jax_pad_batch
    from pytorch_pose_estimation_tpu_torch.data import pad_batch

    batch = _batches(1, b=3)[0]
    for size in (3, 5):
        got, want = pad_batch(batch, size), jax_pad_batch(batch, size)
        assert set(got) == set(want) and got["pad_mask"].tolist() == \
            [1, 1, 1] + [0] * (size - 3)
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _small_state(seed=0):
    torch.manual_seed(seed)
    model = nn.Sequential()
    model.add_module("backbone_features_module", nn.Linear(3, 4))
    model.add_module("sbp_head", nn.Linear(4, 2))
    schedule = optim.yolo_lr(0.1, 2, [10], [0.1])
    opt = optim.get_optimizer("sgd", list(model.parameters()),
                              schedule=schedule, **SGD)
    return TrainState(model, opt, schedule)


def _steps(state, n):
    for _ in range(n):
        state.optimizer.zero_grad()
        state.model(torch.ones(2, 3)).square().sum().backward()
        state.optimizer.step()


def test_checkpoint_round_trip(tmp_path):
    a = _small_state(0)
    _steps(a, 3)
    mgr = CheckpointManager(str(tmp_path / "ckpts"))
    path = mgr.save_epoch(a, 4, val_loss=0.5)
    mgr.save_epoch(a, 5, val_loss=0.7)  # not better: best stays epoch 4
    last = mgr.save_last(a, 5, 0.7)
    names = sorted(os.listdir(tmp_path / "ckpts"))
    assert names == ["best", "best.meta.json", "epoch=4-step=3",
                     "epoch=4-step=3.meta.json", "epoch=5-step=3",
                     "epoch=5-step=3.meta.json", "last", "last.meta.json"]
    assert json.loads((tmp_path / "ckpts" / "best.meta.json").read_text()) \
        == {"epoch": 4, "step": 3, "val_loss": 0.5}
    b = _small_state(1)
    assert restore_checkpoint(last, b) == {"epoch": 5, "step": 3,
                                           "val_loss": 0.7}
    assert b.step == 3
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v)
    _steps(a, 2)
    _steps(b, 2)  # momentum and count came back: the same next updates
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v)
    c = _small_state(2)
    assert restore_checkpoint_flexible(path, c)["epoch"] == 4
    torch.save(a.model.state_dict(), tmp_path / "bare.pt")
    assert restore_checkpoint_flexible(str(tmp_path / "bare.pt"), c) == {}
    assert c.step == 3 and torch.equal(c.model[1].weight,
                                       a.model[1].weight)


def test_extract_backbone_and_partial_warm_start(tmp_path):
    a = _small_state(0)
    _steps(a, 2)
    ck = save_checkpoint(str(tmp_path / "ck"), a)
    bb = extract_backbone(ck, str(tmp_path / "backbone.pt"))
    assert sorted(torch.load(bb)) == ["backbone_features_module.bias",
                                      "backbone_features_module.weight"]
    b = _small_state(1)
    head = b.model.sbp_head.weight.clone()
    load_pretrained(b, bb)
    assert torch.equal(b.model.backbone_features_module.weight,
                       a.model.backbone_features_module.weight)
    assert torch.equal(b.model.sbp_head.weight, head)  # left alone


def _cfg(root, **over):
    cfg = {
        "model": "simple-baselines-pose", "dataset_name": "coco-keypoints",
        "train_path": os.path.join(root, "annotations",
                                   "person_keypoints_train2017.json"),
        "val_path": os.path.join(root, "annotations",
                                 "person_keypoints_val2017.json"),
        "img_dir": root, "input_size": [128, 96], "output_size": [32, 24],
        "num_keypoints": K, "sigma": SIGMA, "conf_threshold": 0.25,
        "workers": 2, "batch_size": 8, "class_labels": COCO_KP_NAMES,
        "epochs": 1, "save_dir": os.path.join(root, "saved"),
        "precision": "fp32", "optimizer": "sgd",
        "optimizer_options": {"lr": 1e-3, **SGD},
        "scheduler": "yolo_lr",
        "scheduler_options": {"burn_in": 2, "steps": [100],
                              "scales": [0.1]},
        "trainer_options": {"check_val_every_n_epoch": 1,
                            "num_sanity_val_steps": 1},
        "clahe": "device"}
    cfg.update(over)
    return cfg


def test_find_auto_resume(tmp_path):
    """Highest step across version dirs; 'last' wins a tie; 'best',
    sidecars and half-written files are never picked."""
    tr = Trainer(_cfg(str(tmp_path)), None, logging=False, device="cpu")
    assert tr._find_auto_resume() is None
    base = tmp_path / "saved" / "simple-baselines-pose_coco-keypoints"

    def mk(version, name, step=None):
        d = base / version / "checkpoints"
        d.mkdir(parents=True, exist_ok=True)
        (d / name).write_bytes(b"x")
        if step is not None:
            (d / (name + ".meta.json")).write_text(
                json.dumps({"epoch": 0, "step": step}))
        return str(d / name)

    mk("version_0", "epoch=4-step=190")
    e24 = mk("version_1", "epoch=24-step=950")
    mk("version_1", "last.tmp123")  # a save killed before its rename
    mk("version_1", "epoch=30-step=1200.tmp7")
    mk("version_1", "best", step=5000)
    assert tr._find_auto_resume() == e24
    last = mk("version_1", "last", step=950)
    assert tr._find_auto_resume() == last
    e29 = mk("version_2", "epoch=29-step=1140")
    assert tr._find_auto_resume() == e29


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    make_dataset(root, "train2017", 6, seed=1)
    make_dataset(root, "val2017", 3, seed=2)
    return root


def _data_modules(cfg, clahe_prob):
    args = (cfg["train_path"], cfg["val_path"], cfg["input_size"],
            cfg["output_size"], K, SIGMA, 2, cfg["batch_size"],
            COCO_KP_NAMES)
    port = SBPCOCODataModule(*args, img_dir=cfg["img_dir"], use_native=False,
                             clahe_prob=clahe_prob, seed=3)
    jax_dm = JaxDataModule(*args, img_dir=cfg["img_dir"], use_native=False,
                           clahe_prob=clahe_prob, seed=3)
    port.setup()
    jax_dm.setup()
    return port, jax_dm


def test_train_loader_matches_jax_cv2_loader(synth):
    """Same instances in the same shuffled order, same pixels (host CLAHE
    at p=0.5 included), for two epochs; the ragged tail is dropped."""
    port, jax_dm = _data_modules(_cfg(synth, batch_size=4), 0.5)
    assert len(port.train_db) == len(jax_dm.train_db) > 4
    a, b = port.train_loader(), jax_dm.train_loader()
    assert len(a) == len(b) == len(port.train_db) // 4
    orders = []
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        got, want = list(a), list(b)
        assert len(got) == len(want) == len(a)
        for x, y in zip(got, want):
            assert set(x) == set(y)
            for k in x:
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        orders.append(np.concatenate([x["bbox"] for x in got]))
    assert not np.array_equal(orders[0], orders[1])  # reshuffled


def test_trainer_fit_and_resume_on_synthetic_data(synth, capsys):
    """Trainer.fit on the CPU at 128x96, batch 8, one epoch, then a resume
    for a second: the reference checkpoint names, the step and epoch
    carried over, a finite loss and the val metric printed."""
    cfg = _cfg(synth)
    dm, _ = _data_modules(cfg, 0.5)
    trainer = Trainer(cfg, dm, device="cpu")
    assert dm.clahe_prob == 0.0  # clahe: device moves it off the host
    state = trainer.fit()
    steps = len(dm.train_db) // 8
    assert state.step == trainer.global_step == steps >= 1
    ckpts = os.path.join(trainer.version_dir, "checkpoints")
    assert sorted(os.listdir(ckpts)) == [
        "best", "best.meta.json", f"epoch=0-step={steps}",
        f"epoch=0-step={steps}.meta.json", "last", "last.meta.json"]
    out = capsys.readouterr().out
    assert "epoch 0: train_loss=" in out and "img/s" in out
    assert "epoch 0: val_loss=" in out

    again = Trainer(dict(cfg, epochs=2), dm, device="cpu")
    assert again.version_dir != trainer.version_dir
    again.fit(resume="auto")
    assert again.state.step == 2 * steps
    out = capsys.readouterr().out
    assert f"resuming at epoch 1 (global step {steps})" in out
    assert "epoch 1: train_loss=" in out and "epoch 0:" not in out
    meta = json.loads(open(os.path.join(
        again.version_dir, "checkpoints", "last.meta.json")).read())
    assert meta["epoch"] == 1 and meta["step"] == 2 * steps
    assert np.isfinite(meta["val_loss"])


def test_train_sbp_cli_trains_on_the_cpu(synth, tmp_path):
    """``python -m pytorch_pose_estimation_tpu_torch.train_sbp --cfg ...
    --device cpu``: the YAML is read (1e-3 as a float), the model trains
    one epoch, writes 'last' and the torch.profiler trace of step 0, with
    the step's ``tracing`` spans in it."""
    from pytorch_pose_estimation_tpu_torch import train_sbp

    cfg = _cfg(synth, save_dir=str(tmp_path / "saved"),
               trainer_options={"check_val_every_n_epoch": 5,
                                "profile_steps": [0, 1]})
    lines = []
    for k, v in cfg.items():
        lines.append(f"{k}: {json.dumps(v)}")
    lines = [ln.replace('"lr": 0.001', '"lr": 1e-3') for ln in lines]
    path = tmp_path / "sbp.yaml"
    path.write_text("\n".join(lines) + "\n")
    assert "1e-3" in path.read_text()
    state = train_sbp.main(["--cfg", str(path), "--device", "cpu"])
    assert state.step == 1
    assert state.schedule(1000) == pytest.approx(1e-4)  # lr 1e-3 x 0.1
    version = tmp_path / "saved" / "simple-baselines-pose_coco-keypoints" / \
        "version_0"
    assert sorted(os.listdir(version / "checkpoints")) == \
        ["last", "last.meta.json"]
    trace = json.loads((version / "trace_steps_0-1.json").read_text())
    assert trace["traceEvents"]
    ranges = {e["name"] for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {"pose.train.step", "pose.train.forward",
            "pose.train.backward"} <= ranges
