"""The port's SPM training and evaluation (train and eval steps, the data
module, the metric, ``Trainer(kind="spm")`` and the ``test_spm`` and
``train_spm`` modules) against the JAX package on the CPU, in fp32.  Full
width SPM at a 64x64 input (16x16 maps), batch 2, 4 persons, weights from
the JAX package's init through ``from_jax_variables``; augmentation draws
repeat the JAX key splits (``jax_spm_draws``, ``jax_draws``).

Tolerances are stated in each test.  The JAX step's augmentation runs op
by op (``jax.disable_jit``): jitted on the CPU, XLA's fused hue op moves
some pixels (ROADMAP Queue 3).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_pose_estimation_tpu import optim as jax_optim
from pytorch_pose_estimation_tpu.data import \
    SPMCOCODataModule as JaxDataModule
from pytorch_pose_estimation_tpu.eval.metrics import \
    SPMmAPCOCO as JaxSPMmAPCOCO
from pytorch_pose_estimation_tpu.models import SPM as JaxSPM
from pytorch_pose_estimation_tpu.ops import image as jax_image
from pytorch_pose_estimation_tpu.train import steps as jax_steps
from pytorch_pose_estimation_tpu.train.state import create_train_state
from pytorch_pose_estimation_tpu.train.steps import \
    make_spm_steps as jax_make_spm_steps
from pytorch_pose_estimation_tpu_torch import optim, test_spm, train_spm
from pytorch_pose_estimation_tpu_torch.data import SPMCOCODataModule
from pytorch_pose_estimation_tpu_torch.eval import SPMmAPCOCO
from pytorch_pose_estimation_tpu_torch.models import SPM, from_jax_variables
from pytorch_pose_estimation_tpu_torch.ops import decode_spm_batch
from pytorch_pose_estimation_tpu_torch.train import (Trainer,
                                                     make_spm_eval_step,
                                                     make_spm_steps, validate)

import _torch_update_gap as G
from synth_fixture import COCO_KP_NAMES, make_dataset
from test_torch_port_augment import jax_draws, jax_spm_draws
from test_torch_port_models import calibrated_jax_variables

IN, OUT, K, P, SIGMA, CONF = 64, 16, 17, 4, 1.0, 0.5
HW = (IN, IN)
SGD = dict(momentum=0.9, weight_decay=5e-3, nesterov=True)
TIE = 1e-5  # sigmoid gap under which fp32 noise may reorder the NMS


@pytest.fixture(scope="module")
def variables():
    return calibrated_jax_variables(kind="spm", input_hw=HW)


def _port(variables):
    model = SPM(K)
    model.load_state_dict(from_jax_variables(variables, "spm"))
    return model


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, b=2):
    """Persons in input px: three with joints spread over the image and
    one padded; one absent joint (0, 0) and one at (0, y)."""
    rng = np.random.RandomState(seed)
    joints = rng.uniform(0, IN, (b, P, K, 2)).astype(np.float32)
    centers = rng.uniform(8, IN - 8, (b, P, 1, 2)).astype(np.float32)
    joints[:, -1] = 0
    centers[:, -1] = 0
    joints[0, 0, 0] = 0
    joints[0, 0, 1] = [0, 30]
    return {"image": rng.randint(0, 256, (b, IN, IN, 3), dtype=np.uint8),
            "joints": joints, "centers": centers}


def _bn_keys(sd):
    return [k for k in sd if k.endswith(("running_mean", "running_var"))]


def _op_by_op_augmentation(monkeypatch, batch, key, geometric):
    """Replace the JAX SPM step's augmentation call (``augment_batch`` or
    ``color_jitter_batch``, looked up when the step is traced) by its
    result on the same arguments computed op by op (``jax.disable_jit``),
    so the jitted step runs XLA's fused hue op nowhere (ROADMAP Queue 3).
    The arguments are the ones the step passes (train/steps.py:151-177)."""
    images = jnp.asarray(batch["image"])
    with jax.disable_jit():
        if geometric:
            pts = jnp.concatenate(
                [jnp.asarray(batch["joints"]).reshape(2, P * K, 2),
                 jnp.asarray(batch["centers"]).reshape(2, P, 2)], axis=1)
            valid = (~((pts[..., 0] <= 0) & (pts[..., 1] <= 0))
                     ).astype(jnp.float32)
            out = jax_image.augment_batch(
                key, images, pts, valid, HW, 30.0, (0.6, 1.0), (0.75, 1.33),
                (0.5, 0.2, 0.5, 0.1), 0.5)
            monkeypatch.setattr(jax_steps, "augment_batch",
                                lambda *args: out)
        else:
            k_cl, k_col = jax.random.split(key)
            x = jax_image.clahe_luma_batch(
                k_cl, images.astype(jnp.float32) / 255.0, 0.5)
            out = jax_image.color_jitter_batch(k_col, x, 0.5, 0.2, 0.5, 0.1,
                                               apply_prob=0.5)
            monkeypatch.setattr(jax_steps, "color_jitter_batch",
                                lambda *args, **kwargs: out)


@pytest.mark.parametrize("geometric", [False, True])
def test_spm_train_step_matches_jax(variables, geometric, monkeypatch):
    """One train step, device CLAHE on: photometric augmentation (the
    default) or rotate + crop + jitter (``geometric``), the SPM targets,
    forward, loss, backward, nesterov SGD with weight decay under yolo_lr
    shifted by 3 updates (its first update has lr 0).

    The loss to 2e-6 relative and the BN statistics to 1e-4, as for SBP
    (1e-6 there).  Each parameter's update within the one-ulp yardstick of
    tests/_torch_update_gap.py (the port's own step with every weight
    moved by about one ulp) and within 0.1 of its norm, not SBP's 2e-2:
    SPM's update at init is worse conditioned (ROADMAP Queue 3).  The gaps
    are printed (run with ``-s``)."""
    augment = {"clahe_prob": 0.5, "geometric": geometric}
    batch = _batch(1)
    key = jax.random.PRNGKey(11)
    jax_yolo = jax_optim.yolo_lr(1e-3, 2, [100], [0.1])
    tx = jax_optim.get_optimizer("sgd", schedule=lambda c: jax_yolo(c + 3),
                                 **SGD)
    model = JaxSPM(num_keypoints=K)
    state = create_train_state(model, tx, (1,) + HW + (3,))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    _op_by_op_augmentation(monkeypatch, batch, key, geometric)
    jax_step, _ = jax_make_spm_steps(model, tx, IN, OUT, K, SIGMA,
                                     augment=augment)
    with jax.default_matmul_precision("highest"):
        state, want = jax_step(state, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, key)

    port_yolo = optim.yolo_lr(1e-3, 2, [100], [0.1])
    if geometric:  # the JAX step's augment_batch arguments
        draws = jax_draws(key, 2, HW, rotate_limit=30.0,
                          scale_range=(0.6, 1.0), ratio_range=(0.75, 1.33),
                          clahe_prob=0.5)
    else:
        draws = jax_spm_draws(key, 2, clahe_prob=0.5)

    def port_step(start):
        port = _port(variables)
        port.load_state_dict(start)
        opt = optim.get_optimizer("sgd", list(port.parameters()),
                                  schedule=lambda c: port_yolo(c + 3), **SGD)
        step, _ = make_spm_steps(port, opt, IN, OUT, K, SIGMA, CONF,
                                 augment=augment)
        loss = step({k: torch.from_numpy(v) for k, v in batch.items()},
                    draws=draws)
        assert loss.dim() == 0 and not loss.requires_grad
        return float(loss), port.state_dict()

    start = from_jax_variables(variables, "spm")
    got, sd = port_step(start)
    np.testing.assert_allclose(got, float(want), rtol=2e-6)
    jax_sd = from_jax_variables({"params": _np_tree(state.params),
                                 "batch_stats": _np_tree(state.batch_stats)},
                                "spm")
    names = [name for name, _ in _port(variables).named_parameters()]
    ulp = G.ulp_gaps(lambda s: port_step(s)[1], start, sd, names)
    G.assert_update_close(sd, jax_sd, start, ulp, names, bound=0.1,
                          label=f"spm train step, geometric={geometric}")


def test_spm_eval_step_matches_jax(variables):
    """Per-sample losses to 1e-5 relative.  The decoded roots' x and y
    equal JAX's, except where two of the port's candidate root values lie
    within 1e-5 (fp32 logits ~1e-5 apart may order them the other way),
    which is allowed and counted; their conf within 1e-5.  Keypoints
    within 1e-2 input px (the gap is printed): a logit 1e-5 off moves a
    field by up to z * input / S * 1e-5 = 7e-3 px."""
    batch = _batch(2, b=4)
    model = JaxSPM(num_keypoints=K)
    state = create_train_state(model, optax.sgd(1e-3), (1,) + HW + (3,))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    _, jax_eval = jax_make_spm_steps(model, None, IN, OUT, K, SIGMA,
                                     decode_conf_threshold=CONF,
                                     max_persons=P)
    with jax.default_matmul_precision("highest"):
        want_l, (want_r, want_j) = jax_eval(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    want_r, want_j = np.asarray(want_r), np.asarray(want_j)
    port = _port(variables).eval()
    eval_step = make_spm_eval_step(port, IN, OUT, K, SIGMA, CONF, P)
    got_l, (got_r, got_j) = eval_step(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-5)
    got_r, got_j = got_r.numpy(), got_j.numpy()
    with torch.no_grad():
        probs = torch.sigmoid(port(torch.from_numpy(
            batch["image"]).permute(0, 3, 1, 2).float() / 255)[:, 0]).numpy()
    exact, gap = 0, 0.0
    for b in range(len(got_r)):
        if np.array_equal(got_r[b, :, :2], want_r[b, :, :2]):
            exact += 1
            gap = max(gap, float(np.abs(got_j[b] - want_j[b]).max()))
            continue
        for g, w in zip(got_r[b], want_r[b]):  # a near tie, not a fault
            if not np.array_equal(g[:2], w[:2]):
                gx, gy, wx, wy = (int(v) // (IN // OUT)
                                  for v in (*g[:2], *w[:2]))
                assert abs(probs[b, gy, gx] - probs[b, wy, wx]) < TIE
                break
    print(f"spm eval step: {exact} of {len(got_r)} images' roots exact, "
          f"keypoints {gap:.3g} px apart")
    assert exact >= 3 and gap <= 1e-2
    np.testing.assert_allclose(got_r[..., 2], want_r[..., 2], rtol=0,
                               atol=1e-5)
    assert (got_r[..., 2] >= 0).sum() >= 8


# --------------------------------------------------------------------------
# data and metric
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spm"))
    make_dataset(root, "train2017", 4, seed=1, img_size=(256, 256))
    make_dataset(root, "val2017", 3, seed=2, img_size=(256, 256))
    return root


def _cfg(root, **over):
    ann = os.path.join(root, "annotations", "person_keypoints_{}.json")
    cfg = {
        "model": "single-stage-pose-machines",
        "dataset_name": "coco-keypoints",
        "train_path": ann.format("train2017"),
        "val_path": ann.format("val2017"), "img_dir": root,
        "input_size": IN, "output_size": OUT, "num_keypoints": K,
        "sigma": SIGMA, "conf_threshold": CONF, "max_persons": P,
        "workers": 2, "batch_size": 2, "class_labels": COCO_KP_NAMES,
        "epochs": 1, "save_dir": os.path.join(root, "saved"),
        "precision": "fp32", "optimizer": "sgd",
        "optimizer_options": {"lr": 1e-3, **SGD}, "scheduler": "yolo_lr",
        "scheduler_options": {"burn_in": 2, "steps": [100],
                              "scales": [0.1]},
        "trainer_options": {"check_val_every_n_epoch": 1,
                            "num_sanity_val_steps": 1}}
    cfg.update(over)
    return cfg


def _data_modules(cfg, clahe_prob=0.5):
    args = (cfg["train_path"], cfg["val_path"], cfg["img_dir"], IN, OUT, K,
            SIGMA, 2, cfg["batch_size"], COCO_KP_NAMES)
    port = SPMCOCODataModule(*args, max_persons=P, use_native=False,
                             clahe_prob=clahe_prob, seed=3)
    jax_dm = JaxDataModule(*args, max_persons=P, use_native=False,
                           clahe_prob=clahe_prob, seed=3)
    port.setup()
    jax_dm.setup()
    return port, jax_dm


def test_spm_data_module_matches_jax(synth):
    """Train batches (host CLAHE at p=0.5, shuffled, two epochs) and val
    batches equal the JAX cv2 loader's, key by key and dtype by dtype."""
    port, jax_dm = _data_modules(_cfg(synth))
    assert len(port.train_db) == len(jax_dm.train_db) == 4
    pairs = []
    for epoch in (0, 1):
        a, b = port.train_loader(), jax_dm.train_loader()
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        pairs += zip(list(a), list(b))
    pairs += zip(list(port.val_loader()), list(jax_dm.val_loader()))
    assert len(pairs) == 6
    for x, y in pairs:
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert pairs[0][0]["image_size"].dtype == np.int64
    # use_native=True takes the native path: one batch_fn call a batch
    native = SPMCOCODataModule(None, None, None, IN, OUT, K, SIGMA, 0, 2, [],
                               use_native=True)
    assert native.use_native
    loader = native.train_loader()
    assert loader.batch_fn is not None and loader.sample_fn is None


def test_spm_metric_matches_jax(synth, tmp_path, monkeypatch):
    """The result list and AP of the same decoded batches: the ground
    truth itself (roots at the centers, conf 1; absent keypoints at
    (0, 0)), AP near 1, and the decode of random logits."""
    cfg = _cfg(synth)
    monkeypatch.chdir(tmp_path)  # the metric writes results.json to cwd
    ours = SPMmAPCOCO(cfg["val_path"], IN, SIGMA, CONF, P)
    theirs = JaxSPMmAPCOCO(cfg["val_path"], IN, SIGMA, CONF, P)
    assert ours.result(False) == 0.0 and not os.path.exists("results.json")
    _, jax_dm = _data_modules(cfg)
    rng = np.random.RandomState(4)
    for batch in jax_dm.val_loader():
        b = len(batch["image"])
        present = (batch["centers"][:, :, 0] > 0).any(-1, keepdims=True)
        roots = np.where(present, np.concatenate(
            [batch["centers"][:, :, 0], np.ones((b, P, 1), np.float32)], -1),
            -1).astype(np.float32)
        kps = np.concatenate([batch["joints"],
                              np.ones((b, P, K, 1), np.float32)], -1)
        logits = torch.from_numpy(
            rng.randn(b, 1 + 2 * K, OUT, OUT).astype(np.float32) * 3)
        for decoded in ((torch.from_numpy(roots), torch.from_numpy(kps)),
                        decode_spm_batch(logits, IN, SIGMA, CONF, True, P)):
            ours.update_state_decoded(batch, decoded)
            theirs.update_state_decoded(
                batch, tuple(a.numpy() for a in decoded))
    assert len(ours.result_list) > 0
    assert ours.result_list == theirs.result_list
    ap = ours.result(verbose=False)
    assert ap == theirs.result(verbose=False) and ap > 0.9
    assert os.path.exists("results.json")


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def test_spm_trainer_fit_resume_validate_and_cli(synth, tmp_path, capsys,
                                                 monkeypatch):
    """Trainer(kind="spm") on the CPU: one epoch (sanity validation, device
    CLAHE off the host) and its checkpoints; the ``train_spm`` module
    (config from YAML) resumes it for a second epoch; ``test_spm`` from
    the written 'last' reproduces ``validate`` of the resumed model."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(synth, save_dir=str(tmp_path / "saved"), clahe="device")
    dm, _ = _data_modules(cfg)
    trainer = Trainer(cfg, dm, kind="spm", device="cpu")
    assert dm.clahe_prob == 0.0
    assert trainer.summary()["output_shape"] == (1, 1 + 2 * K, OUT, OUT)
    state = trainer.fit()
    assert state.step == 2
    ckpts = os.path.join(trainer.version_dir, "checkpoints")
    assert sorted(os.listdir(ckpts)) == [
        "best", "best.meta.json", "epoch=0-step=2", "epoch=0-step=2.meta.json",
        "last", "last.meta.json"]

    path = tmp_path / "spm.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in dict(cfg, epochs=2).items()))
    state = train_spm.main(["--cfg", str(path), "--resume", "auto",
                            "--device", "cpu"])
    assert state.step == 4
    out = capsys.readouterr().out
    assert "sanity validation: 1 batch(es) ok" in out
    assert "resuming at epoch 1 (global step 2)" in out
    val_loss, val_map = validate(cfg, dm, state.model, "cpu", verbose=False,
                                 kind="spm")
    assert np.isfinite(val_loss) and 0.0 <= val_map <= 1.0

    last = os.path.join(os.path.dirname(trainer.version_dir), "version_1",
                        "checkpoints", "last")
    got = test_spm.main(["--cfg", str(path), "--ckpt", last,
                         "--device", "cpu"])
    np.testing.assert_allclose(got, (val_loss, val_map), rtol=1e-6)
    with pytest.raises(ValueError, match="'sbp', 'pis' or 'spm'"):
        Trainer(cfg, dm, kind="hourglass", logging=False, device="cpu")
