"""The port's PIS path (11-keypoint SBP) against the JAX package, on the CPU:
the data module (absolute paths), ``SBPmAPPIS`` and the metrics' ``count``,
the behaviour rules, the train and eval steps at K=11, ``validate(kind=
"pis")``, the PIS training chain through weight surgery, the two behaviour
harnesses and ``inference_sbp_pis`` against the root CLIs on the same
weights.  Data from tests/synth_fixture.py (``make_pis_dataset``,
``make_pis_behavior_dataset``); full-width SBP at a 96x64 input in fp32
(JAX at "highest" matmul precision).

Tolerances (those of the SBP tests, tests/test_torch_port_slice.py and
tests/test_torch_port_train.py): eval losses 1e-4 relative; decoded x and
y equal outside near ties (top two sigmoid values within 1e-5), conf
1e-5; the train step's loss 1e-6 relative, each parameter's update 2e-2
of its norm, BN statistics 1e-4.  Metrics, rules, data, harness counts and
images: equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import inference_sbp_pis as jax_inference_pis
import pis_falling_down_test_code as jax_fall_cli
import pis_handle_test_code as jax_handle_cli
from pytorch_pose_estimation_tpu import optim as jax_optim
from pytorch_pose_estimation_tpu import pis as jax_pis
from pytorch_pose_estimation_tpu.data import SBPPISDataModule as JaxPISData
from pytorch_pose_estimation_tpu.data.coco import \
    CocoAnnotations as JaxCocoAnnotations
from pytorch_pose_estimation_tpu.data.sbp_dataset import \
    load_sbp_instance_db as jax_load_db
from pytorch_pose_estimation_tpu.eval import metrics as jax_metrics
from pytorch_pose_estimation_tpu.models import SBP as JaxSBP
from pytorch_pose_estimation_tpu.models.torch_import import \
    import_torch_state_dict
from pytorch_pose_estimation_tpu.ops.decode import \
    decode_sbp_fast as jax_decode_sbp_fast
from pytorch_pose_estimation_tpu.train.state import create_train_state
from pytorch_pose_estimation_tpu.train.steps import \
    make_sbp_steps as jax_make_sbp_steps
from pytorch_pose_estimation_tpu_torch import (inference_sbp_pis, optim,
                                               pis, pis_falling_down_test_code,
                                               pis_handle_test_code,
                                               saving_weights, train_sbp_pis)
from pytorch_pose_estimation_tpu_torch.data import (CocoAnnotations,
                                                    SBPPISDataModule,
                                                    load_sbp_instance_db)
from pytorch_pose_estimation_tpu_torch.eval import (SBPmAPCOCO, SBPmAPPIS,
                                                    SPMmAPCOCO)
from pytorch_pose_estimation_tpu_torch.models import SBP, from_jax_variables
from pytorch_pose_estimation_tpu_torch.ops import normalize_batch
from pytorch_pose_estimation_tpu_torch.train import (Trainer, build_metric,
                                                     build_model,
                                                     make_sbp_eval_step,
                                                     make_sbp_steps,
                                                     validate)
from pytorch_pose_estimation_tpu_torch.train.steps import _sbp_targets

import _torch_update_gap as G
from synth_fixture import make_pis_behavior_dataset, make_pis_dataset
from test_torch_port_augment import jax_draws
from test_torch_port_models import calibrated_jax_variables

K = 11
INPUT_HW = (96, 64)  # stride 32 in, 4 out: sides that divide by 32
OUTPUT_HW = (24, 16)
SIGMA = 2.0
CONF = 0.25
TIE = 1e-5  # top-two sigmoid gap under which fp32 noise may flip argmax
PIS_LABELS = ["nose", "left_eye", "right_eye", "left_ear", "right_ear",
              "left_shoulder", "right_shoulder", "left_elbow",
              "right_elbow", "left_wrist", "right_wrist"]
SGD = dict(momentum=0.9, weight_decay=5e-3, nesterov=True)


@pytest.fixture(scope="module")
def pis_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pis"))
    return (root, make_pis_dataset(root, "train", 6, seed=2),
            make_pis_dataset(root, "valid", 5, seed=3))


@pytest.fixture(scope="module")
def behavior(tmp_path_factory):
    """(train, handle val, fall val) annotation files: 2 val images per
    class, the class in the directory above each image."""
    root = str(tmp_path_factory.mktemp("pis_behavior"))
    return make_pis_behavior_dataset(root, n_train=2, n_val_per_class=2,
                                     seed=0)


def _cfg(train_path, val_path, **over):
    cfg = {"model": "simple-baselines-pose", "dataset_name": "pis",
           "train_path": train_path, "val_path": val_path,
           "input_size": list(INPUT_HW), "output_size": list(OUTPUT_HW),
           "num_keypoints": K, "sigma": SIGMA, "conf_threshold": CONF,
           "class_labels": PIS_LABELS, "workers": 0, "batch_size": 2,
           "precision": "fp32", "seed": 0, "optimizer": "sgd",
           "optimizer_options": {"lr": 1e-3, **SGD}}
    cfg.update(over)
    return cfg


def _modules(train_path, val_path, batch_size=2, clahe_prob=0.0):
    args = dict(train_path=train_path, val_path=val_path,
                input_size=list(INPUT_HW), output_size=list(OUTPUT_HW),
                num_keypoints=K, sigma=SIGMA, workers=2,
                batch_size=batch_size, class_labels=PIS_LABELS,
                clahe_prob=clahe_prob, seed=3)
    port = SBPPISDataModule(use_native=False, **args)
    theirs = JaxPISData(use_native=False, **args)
    port.setup()
    theirs.setup()
    return port, theirs


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def variables(pis_root):
    """Seeded JAX SBP weights at K=11, BN calibrated on the PIS val
    crops."""
    dm, _ = _modules(None, pis_root[2], batch_size=4)
    first = next(iter(dm.val_loader()))["image"]
    return calibrated_jax_variables(
        np.transpose(first, (0, 3, 1, 2)) / np.float32(255),
        input_hw=INPUT_HW, num_keypoints=K)


def _port(variables):
    model = SBP(K)
    model.load_state_dict(from_jax_variables(variables))
    return model.eval()


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["pis", "handle", "fall"])
def test_pis_data_module_matches_jax(pis_root, behavior, which):
    """The same records (absolute paths, 11 joints, the same visibility)
    and the same ``val_loader(batch_size=1)`` batches as the JAX module."""
    val = {"pis": pis_root[2], "handle": behavior[1],
           "fall": behavior[2]}[which]
    port, theirs = _modules(None, val)
    assert port.absolute_paths and port.img_dir is None
    assert len(port.val_db) == len(theirs.val_db) > 0
    for a, b in zip(port.val_db, theirs.val_db):
        assert os.path.isabs(a["image_path"])
        assert a["image_path"] == b["image_path"]
        assert a["joints"].shape == (K, 2)
        for k in ("bbox", "joints", "joints_vis"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                     b["category_id"])
    got = list(port.val_loader(batch_size=1))
    assert all(len(x["image"]) == 1 for x in got)
    _assert_batches_equal(got, list(theirs.val_loader(batch_size=1)))


def test_pis_train_loader_matches_jax(pis_root):
    """Shuffled train batches with host CLAHE at p=0.5, two epochs."""
    port, theirs = _modules(pis_root[1], None, batch_size=2, clahe_prob=0.5)
    a, b = port.train_loader(), theirs.train_loader()
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        _assert_batches_equal(list(a), list(b))
    assert len(port.train_loader(batch_size=4)) == 1  # 6 records, drop last


@pytest.mark.parametrize("absolute", [False, True])
def test_instance_db_path_rule_matches_jax(pis_root, absolute, tmp_path):
    """``absolute_paths`` uses ``file_name`` as it is; otherwise it is
    joined to ``img_dir`` (here on file names made relative)."""
    db = json.load(open(pis_root[2]))
    for im in db["images"]:
        im["file_name"] = os.path.basename(im["file_name"])
    path = str(tmp_path / "relative.json")
    json.dump(db, open(path, "w"))
    got = load_sbp_instance_db(CocoAnnotations(path), "/imgs", K,
                               absolute_paths=absolute)
    want = jax_load_db(JaxCocoAnnotations(path), "/imgs", K,
                       absolute_paths=absolute)
    assert [r["image_path"] for r in got] == [r["image_path"] for r in want]
    assert got[0]["image_path"].startswith("/imgs/") != absolute


# --------------------------------------------------------------------------
# metrics and behaviour rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["decoded", "logits"])
def test_pis_metric_matches_jax(pis_root, case, tmp_path, monkeypatch):
    """The same decoded joints (or logits peaked at the ground truth) give
    the same results (51 numbers each) and the same AP as JAX's
    SBPmAPPIS."""
    monkeypatch.chdir(tmp_path)  # the metric writes results.json to cwd
    dm, _ = _modules(None, pis_root[2])
    ours = SBPmAPPIS(pis_root[2], list(INPUT_HW), CONF)
    theirs = jax_metrics.SBPmAPPIS(pis_root[2], list(INPUT_HW), CONF)
    rng = np.random.RandomState(4)
    for batch in dm.val_loader():
        n = len(batch["image"])
        if case == "decoded":
            j = np.concatenate([batch["joints"], batch["joints_vis"][..., None]
                                - 0.5 + rng.uniform(0, 0.4, (n, K, 1))],
                               -1).astype(np.float32)
            j[:, ::3, 2] = -1.0  # some not found
            ours.update_state_decoded(batch, torch.from_numpy(j))
            theirs.update_state_decoded(batch, j)
        else:
            maps = _sbp_targets(torch.from_numpy(batch["joints"]),
                                torch.from_numpy(batch["joints_vis"]),
                                OUTPUT_HW[0] / INPUT_HW[0], OUTPUT_HW, K,
                                SIGMA)
            logits = maps * 10 - 5
            ours.update_state(batch, logits)
            theirs.update_state(batch, jnp.asarray(
                logits.permute(0, 2, 3, 1).numpy()))
    assert len(ours.result_list) == len(dm.val_db)
    assert all(len(r["keypoints"]) == 51 for r in ours.result_list)
    for a, b in zip(ours.result_list, theirs.result_list):
        assert a["keypoints"] == b["keypoints"]
        np.testing.assert_allclose(a["score"], b["score"], rtol=0,
                                   atol=1e-6)
    ap = ours.result(verbose=False)
    assert ap == theirs.result(verbose=False)
    assert len(json.load(open("results.json"))[0]["keypoints"]) == 51
    if case == "logits":
        assert ap > 0.5


@pytest.mark.parametrize("kind", ["sbp", "spm"])
def test_metric_count_limits_rows_as_jax(pis_root, kind, tmp_path,
                                         monkeypatch):
    """``count`` keeps the first N rows of a padded batch, as in JAX."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(5)
    if kind == "sbp":
        dm, _ = _modules(None, pis_root[2], batch_size=4)
        batch = next(iter(dm.val_loader()))
        ours = SBPmAPCOCO(pis_root[2], list(INPUT_HW), CONF)
        theirs = jax_metrics.SBPmAPCOCO(pis_root[2], list(INPUT_HW), CONF)
        decoded = (rng.uniform(-1, 60, (4, K, 3)).astype(np.float32),)
    else:
        ours = SPMmAPCOCO(pis_root[2], 64, 1.0, 0.5, 3)
        theirs = jax_metrics.SPMmAPCOCO(pis_root[2], 64, 1.0, 0.5, 3)
        batch = {"image_size": np.full((4, 2), 64), "image_id": np.arange(
            1, 5), "category_id": np.ones(4, np.int64)}
        decoded = ((rng.uniform(-1, 60, (4, 3, 3)).astype(np.float32),
                    rng.uniform(0, 60, (4, 3, 17, 3)).astype(np.float32)),)
    for count in (None, 3):
        ours.reset_states()
        theirs.reset_states()
        ours.update_state_decoded(batch, *decoded, count=count)
        theirs.update_state_decoded(batch, *decoded, count=count)
        assert ours.result_list == theirs.result_list
    assert {r["image_id"] for r in ours.result_list} <= set(
        np.asarray(batch["image_id"])[:3].tolist())


def _grid(dtype):
    """Seeded points, points whose intersection lands on an integer (the
    truncation boundary) and points on a vertical shoulder line."""
    rng = np.random.RandomState(6)
    pts = rng.uniform(-200, 3000, (200, 2))
    (ax, ay), (bx, by) = jax_handle_cli.HANDLE_ROI
    g = (ay - by) / (ax - bx)
    ys = (np.arange(-20, 20) * g + (ay - g * ax))  # x intersection integer
    edge = np.stack([np.arange(-20, 20) + 0.0, ys], -1)
    return np.concatenate([pts, edge, edge + [0.5, 0], edge - [1e-9, 0]]
                          ).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_handle_grip_matches_jax(dtype):
    ours = pis.HandleGrip(jax_handle_cli.HANDLE_ROI)
    theirs = jax_pis.HandleGrip(jax_handle_cli.HANDLE_ROI)
    got = [ours.get_handle_grip_result(p) for p in _grid(dtype)]
    want = [theirs.get_handle_grip_result(p) for p in _grid(dtype)]
    assert got == want
    assert 0 < sum(got) < len(got)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_falling_down_matches_jax(dtype):
    rng = np.random.RandomState(7)
    pts = rng.uniform(-100, 100, (300, 4)).astype(dtype)
    pts[:20, 2] = pts[:20, 0]  # vertical: the 1e-6 keeps it finite
    pts[20:40, 2] = pts[20:40, 0] - dtype(1e-6)
    ours, theirs = pis.FallingDown(-1, 8), jax_pis.FallingDown(-1, 8)
    got = [ours.get_falling_down_result(p[:2], p[2:]) for p in pts]
    want = [theirs.get_falling_down_result(p[:2], p[2:]) for p in pts]
    assert got == want
    assert 0 < sum(got) < len(got)


def test_vertical_handle_roi_raises_on_both_sides():
    for mod in (pis, jax_pis):
        with pytest.raises(ZeroDivisionError):
            mod.HandleGrip(((100, 0), (100, 50))).get_handle_grip_result(
                (3.0, 4.0))
        with pytest.raises(ZeroDivisionError):  # horizontal: gradient 0
            mod.HandleGrip(((0, 7), (50, 7))).get_handle_grip_result(
                (3.0, 4.0))


# --------------------------------------------------------------------------
# steps, validate and the trainer at K=11
# --------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_train_step_k11_matches_jax(variables):
    """One train step at K=11 (the targets, forward, loss, backward,
    nesterov SGD under yolo_lr shifted by 3 updates) against JAX's
    ``make_sbp_steps`` at K=11, fed the same draws, with the augmentation
    off: no rotation, jitter or CLAHE and the identity crop (ROADMAP item
    6's check; the augmentation is tested against JAX in
    test_torch_port_augment.py).  With it on, the jitted JAX step's pixels
    differ from its op-by-op ones on the CPU (ROADMAP Queue 3) and the
    updates drift past 2e-2.  Each update within the one-ulp yardstick of
    tests/_torch_update_gap.py and within 2e-2 of its norm."""
    rng = np.random.RandomState(8)
    batch = {"image": rng.randint(0, 256, (2,) + INPUT_HW + (3,),
                                  dtype=np.uint8),
             "joints": np.stack([rng.uniform(0, INPUT_HW[1], (2, K)),
                                 rng.uniform(0, INPUT_HW[0], (2, K))],
                                -1).astype(np.float32),
             "joints_vis": (rng.rand(2, K) > 0.2).astype(np.float32)}
    key = jax.random.PRNGKey(9)
    jax_yolo = jax_optim.yolo_lr(1e-3, 2, [100], [0.1])
    tx = jax_optim.get_optimizer("sgd", schedule=lambda c: jax_yolo(c + 3),
                                 **SGD)
    model = JaxSBP(num_keypoints=K)
    state = create_train_state(model, tx, (1,) + INPUT_HW + (3,))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    augment = {"rotate_prob": 0.0, "jitter_prob": 0.0,
               "scale_range": (1.0, 1.0),
               "ratio_range": (INPUT_HW[1] / INPUT_HW[0],) * 2}
    jax_step, _ = jax_make_sbp_steps(model, tx, list(INPUT_HW), OUTPUT_HW,
                                     K, SIGMA, augment=augment)
    with jax.default_matmul_precision("highest"):
        state, want = jax_step(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    port_yolo = optim.yolo_lr(1e-3, 2, [100], [0.1])
    draws = jax_draws(key, 2, INPUT_HW, rotate_prob=0.0, jitter_prob=0.0,
                      scale_range=(1.0, 1.0),
                      ratio_range=augment["ratio_range"])

    def port_step(start):
        port = _port(variables)
        port.load_state_dict(start)
        port.train()
        opt = optim.get_optimizer("sgd", list(port.parameters()),
                                  schedule=lambda c: port_yolo(c + 3), **SGD)
        step, _ = make_sbp_steps(port, opt, list(INPUT_HW), OUTPUT_HW, K,
                                 SIGMA, CONF, augment=augment)
        loss = step({k: torch.from_numpy(v) for k, v in batch.items()},
                    draws=draws)
        return float(loss), port.state_dict()

    start = from_jax_variables(variables)
    got, sd = port_step(start)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    jax_sd = from_jax_variables({"params": _np_tree(state.params),
                                 "batch_stats": _np_tree(state.batch_stats)})
    assert sd["sbp_head.0.weight"].shape[0] == K
    names = [n for n, _ in _port(variables).named_parameters()]
    ulp = G.ulp_gaps(lambda s: port_step(s)[1], start, sd, names)
    G.assert_update_close(sd, jax_sd, start, ulp, names, bound=2e-2,
                          label="pis train step, K=11")


@pytest.fixture(scope="module")
def jax_eval(variables):
    model = JaxSBP(num_keypoints=K)
    state = create_train_state(model, optax.sgd(1e-3),
                               (1,) + INPUT_HW + (3,))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    _, eval_step = jax_make_sbp_steps(model, None, list(INPUT_HW), OUTPUT_HW,
                                      K, SIGMA, decode_conf_threshold=CONF)

    def run(batch):
        with jax.default_matmul_precision("highest"):
            losses, joints = eval_step(state, {
                k: jnp.asarray(batch[k])
                for k in ("image", "joints", "joints_vis")})
        return np.asarray(losses), np.asarray(joints)

    return run


def _clear(port, images):
    """Channels whose top two sigmoid values are more than TIE apart."""
    with torch.no_grad():
        probs = torch.sigmoid(port(normalize_batch(
            torch.from_numpy(images)))).flatten(2)
    top2 = probs.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1] > TIE).numpy()


def test_eval_step_k11_matches_jax(pis_root, variables, jax_eval):
    port = _port(variables)
    dm, _ = _modules(None, pis_root[2])
    eval_step = make_sbp_eval_step(port, INPUT_HW, OUTPUT_HW, K, SIGMA, CONF)
    checked = 0
    for batch in dm.val_loader():
        losses, joints = eval_step({k: torch.from_numpy(batch[k]) for k in
                                    ("image", "joints", "joints_vis")})
        want_losses, want_joints = jax_eval(batch)
        assert joints.shape == (len(batch["image"]), K, 3)
        np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-4)
        clear = _clear(port, batch["image"])
        got = joints.numpy()
        np.testing.assert_array_equal(got[clear][:, :2],
                                      want_joints[clear][:, :2])
        np.testing.assert_allclose(got[..., 2], want_joints[..., 2],
                                   rtol=0, atol=1e-5)
        checked += int(clear.sum())
    assert checked >= 0.75 * len(dm.val_db) * K


def test_validate_pis_matches_jax(pis_root, variables, jax_eval, tmp_path,
                                  monkeypatch):
    """``validate(kind="pis")`` against JAX's eval step and SBPmAPPIS on
    the same weights: val_loss 1e-4 relative, the same AP."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(None, pis_root[2])
    dm, jax_dm = _modules(None, pis_root[2])
    assert isinstance(build_metric(cfg, "pis"), SBPmAPPIS)
    metric = jax_metrics.SBPmAPPIS(cfg["val_path"], cfg["input_size"], CONF)
    losses = []
    for batch in jax_dm.val_loader():
        per, joints = jax_eval(batch)
        losses.append(per)
        metric.update_state_decoded(batch, joints, count=len(per))
    want = (float(np.concatenate(losses).mean()), metric.result(False))
    got = validate(cfg, dm, _port(variables), device="cpu", verbose=False,
                   kind="pis")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert got[1] == want[1]
    assert len(json.load(open("results.json"))[0]["keypoints"]) == 51


def test_pis_kind_builds_an_11_keypoint_trainer(pis_root, tmp_path):
    cfg = _cfg(pis_root[1], pis_root[2], save_dir=str(tmp_path), epochs=1)
    tr = Trainer(cfg, None, kind="pis", device="cpu")
    assert tr.model.sbp_head[0].weight.shape[0] == K
    assert tr.keys == ("image", "joints", "joints_vis")
    assert tr.version_dir == str(tmp_path / "simple-baselines-pose_pis" /
                                 "version_0")
    with pytest.raises(ValueError, match="'sbp', 'pis' or 'spm'"):
        build_model(cfg, "hourglass")


def test_pis_train_saving_weights_and_warm_start(pis_root, tmp_path,
                                                 monkeypatch, capsys):
    """``train_sbp_pis`` on the CPU (one epoch, validation through
    SBPmAPPIS), ``saving_weights`` of its ``last``, then a PIS Trainer
    warm-started from that file: its backbone equals the donor's, its head
    does not (tests/test_spm_pis_e2e.py:90-146 for JAX)."""
    monkeypatch.chdir(tmp_path)
    # save_freq 5: only 'last' is written (each file holds 290 MB)
    cfg = _cfg(pis_root[1], pis_root[2], epochs=1, save_freq=5,
               save_dir=str(tmp_path / "saved"), clahe="device",
               trainer_options={"check_val_every_n_epoch": 1},
               scheduler="yolo_lr",
               scheduler_options={"burn_in": 2, "steps": [100],
                                  "scales": [0.1]})
    path = tmp_path / "pis.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in cfg.items()))
    donor = train_sbp_pis.main(["--cfg", str(path), "--device", "cpu"])
    assert donor.step == 3  # 6 crops at batch 2
    assert "epoch 0: val_loss=" in capsys.readouterr().out
    assert len(json.load(open("results.json"))[0]["keypoints"]) == 51
    last = tmp_path / "saved" / "simple-baselines-pose_pis" / "version_0" / \
        "checkpoints" / "last"
    out = saving_weights.main(["--ckpt", str(last), "--out",
                               str(tmp_path / "pretrained_weights")])
    assert all(k.startswith("backbone_features_module.")
               for k in torch.load(out))
    warm = Trainer(dict(cfg, model_pretrained=out), None, kind="pis",
                   logging=False, device="cpu")
    donor_sd, warm_sd = donor.model.state_dict(), warm.model.state_dict()
    bb = [k for k in donor_sd if k.startswith("backbone_features_module.")]
    assert len(bb) == 18 * 6
    for k in bb:
        assert torch.equal(warm_sd[k], donor_sd[k]), k
    assert not torch.equal(warm_sd["sbp_head.0.weight"],
                           donor_sd["sbp_head.0.weight"])


# --------------------------------------------------------------------------
# the harnesses and inference_sbp_pis against the root CLIs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(variables, tmp_path_factory):
    """The port's weights in a torch file, and a JAX predictor over the same
    weights (``import_torch_state_dict`` of the port's state_dict) to stand
    in for the root CLIs' ``load_sbp_predictor``."""
    port = _port(variables)
    path = str(tmp_path_factory.mktemp("w") / "pis.pt")
    torch.save(port.state_dict(), path)
    jax_vars = import_torch_state_dict(port.state_dict())
    model = JaxSBP(num_keypoints=K)

    @jax.jit
    def predict(images):
        logits = model.apply(jax_vars, images.astype(jnp.float32) / 255.0,
                             train=False)
        return jax_decode_sbp_fast(logits, INPUT_HW[1], CONF, True)

    def jax_predictor(cfg, ckpt):
        assert ckpt == path

        def call(images):
            # a writable copy: the root CLIs write into the joints
            with jax.default_matmul_precision("highest"):
                return np.array(predict(jnp.asarray(images)))
        return call

    return path, jax_predictor


@pytest.mark.parametrize("task", ["handle", "fall"])
def test_harness_counts_match_root_cli(behavior, weights, task, monkeypatch):
    path, jax_predictor = weights
    val = behavior[1] if task == "handle" else behavior[2]
    cfg = _cfg(None, val, batch_size=1)  # the shape inference_sbp_pis uses
    root_cli, port_cli = {
        "handle": (jax_handle_cli, pis_handle_test_code),
        "fall": (jax_fall_cli, pis_falling_down_test_code)}[task]
    monkeypatch.setattr(root_cli, "load_sbp_predictor", jax_predictor)
    want = root_cli.run(dict(cfg), path, label_depth=-2)
    got = port_cli.main(["--cfg", _yaml(cfg, path), "--ckpt", path,
                         "--label-depth", "-2", "--val-path", val,
                         "--device", "cpu"])
    assert tuple(got) == tuple(want)
    assert sum(got) == 4  # 2 images of each class


def _yaml(cfg, near):
    path = os.path.join(os.path.dirname(near), "pis_cfg.yaml")
    with open(path, "w") as f:
        f.write("".join(f"{k}: {json.dumps(v)}\n" for k, v in cfg.items()))
    return path


@pytest.mark.parametrize("task", ["handle_grip", "falling_down"])
def test_inference_sbp_pis_images_equal_root_cli(behavior, weights, task,
                                                 tmp_path, monkeypatch,
                                                 capsys):
    path, jax_predictor = weights
    val = behavior[1] if task == "handle_grip" else behavior[2]
    cfg = _cfg(None, val)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    inference_sbp_pis.inference(cfg, path, task, str(ours), limit=3,
                                device="cpu")
    assert capsys.readouterr().out.count("Inference: ") == 3
    monkeypatch.setattr(jax_inference_pis, "load_sbp_predictor",
                        jax_predictor)
    jax_inference_pis.inference(dict(cfg), path, task, str(theirs), limit=3)
    names = [f"{i:06d}_pred.jpg" for i in range(3)]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == names
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()
