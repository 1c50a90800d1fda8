"""The ported SBP eval slice as a whole against the JAX package, on the CPU:
the val loader, the eval step (targets, forward, per-sample loss, decode),
the OKS metric, ``validate`` and the ``test_sbp`` CLI module, with the same
converted weights on synthetic COCO data (tests/synth_fixture.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_pose_estimation_tpu.data import \
    SBPCOCODataModule as JaxDataModule
from pytorch_pose_estimation_tpu.eval.metrics import \
    SBPmAPCOCO as JaxSBPmAPCOCO
from pytorch_pose_estimation_tpu.models import SBP as JaxSBP
from pytorch_pose_estimation_tpu.train.state import create_train_state
from pytorch_pose_estimation_tpu.train.steps import make_sbp_steps
from pytorch_pose_estimation_tpu_torch import test_sbp as port_cli
from pytorch_pose_estimation_tpu_torch.data import SBPCOCODataModule
from pytorch_pose_estimation_tpu_torch.eval import SBPmAPCOCO
from pytorch_pose_estimation_tpu_torch.models import SBP, from_jax_variables
from pytorch_pose_estimation_tpu_torch.ops import normalize_batch
from pytorch_pose_estimation_tpu_torch.train import (make_sbp_eval_step,
                                                     validate)
from pytorch_pose_estimation_tpu_torch.train.steps import _sbp_targets

from synth_fixture import COCO_KP_NAMES, make_dataset
from test_torch_port_models import calibrated_jax_variables

# stride 32 in, 4 out: widths that divide by 32
INPUT_HW = (96, 64)
OUTPUT_HW = (24, 16)
SIGMA = 2.0
CONF = 0.25
TIE = 1e-5  # top-two sigmoid gap under which fp32 noise may flip argmax


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    json_path = make_dataset(root, "val2017", 5, seed=3)
    cfg = {
        "val_path": json_path, "img_dir": root, "input_size": list(INPUT_HW),
        "output_size": list(OUTPUT_HW), "num_keypoints": 17, "sigma": SIGMA,
        "conf_threshold": CONF, "workers": 2, "batch_size": 4,
        "class_labels": COCO_KP_NAMES, "precision": "fp32",
    }
    jax_dm = JaxDataModule(
        train_path=json_path, val_path=json_path, img_dir=root,
        input_size=cfg["input_size"], output_size=cfg["output_size"],
        num_keypoints=17, sigma=SIGMA, workers=2, batch_size=4,
        class_labels=COCO_KP_NAMES)
    jax_dm.setup()
    dm = SBPCOCODataModule(
        train_path=None, val_path=json_path, img_dir=root,
        input_size=cfg["input_size"], output_size=cfg["output_size"],
        num_keypoints=17, sigma=SIGMA, workers=2, batch_size=4,
        class_labels=COCO_KP_NAMES)
    dm.setup()
    first = next(iter(dm.val_loader()))["image"]
    variables = calibrated_jax_variables(
        np.transpose(first, (0, 3, 1, 2)) / np.float32(255))
    port = SBP(17)
    port.load_state_dict(from_jax_variables(variables))
    port.eval()
    return cfg, jax_dm, dm, variables, port


@pytest.fixture(scope="module")
def jax_eval(setup):
    """The JAX eval step (fp32, highest matmul precision) on the same
    weights: batch -> (per-sample losses, joints) as numpy."""
    variables = setup[3]
    model = JaxSBP(num_keypoints=17)
    state = create_train_state(model, optax.sgd(1e-3), (1,) + INPUT_HW + (3,))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    _, eval_step = make_sbp_steps(model, None, list(INPUT_HW), OUTPUT_HW, 17,
                                  SIGMA, decode_conf_threshold=CONF)

    def run(batch):
        with jax.default_matmul_precision("highest"):
            losses, joints = eval_step(state, {
                k: jnp.asarray(batch[k])
                for k in ("image", "joints", "joints_vis")})
        return np.asarray(losses), np.asarray(joints)

    return run


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(batch[k]))
            for k in ("image", "joints", "joints_vis")}


def test_val_loader_matches_jax_cv2_loader(setup):
    """Both packages' default decoder (the native loader when it is built,
    else cv2, in both): the same val batches, exactly."""
    _, jax_dm, dm, _, _ = setup
    assert len(dm.val_db) == len(jax_dm.val_db) > 4  # >1 batch, ragged tail
    got, want = list(dm.val_loader()), list(jax_dm.val_loader())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_eval_step_matches_jax(setup, jax_eval):
    """Per-sample losses to rtol 1e-4 (fp32 logits that differ by ~5e-5
    through 22 blocks, summed in another order).  conf within 1e-5: the
    sigmoid's slope is at most 1/4, so those logit differences move it by
    ~1e-5 at most.  Decoded x and y are equal, except in channels whose
    top two sigmoid values lie within 1e-5 of each other: there the
    logits' fp32 noise may pick the other pixel, so those channels are
    left out (and counted)."""
    _, _, dm, _, port = setup
    eval_step = make_sbp_eval_step(port, INPUT_HW, OUTPUT_HW, 17, SIGMA,
                                   CONF)
    checked = 0
    for batch in dm.val_loader():
        losses, joints = eval_step(_tensors(batch))
        want_losses, want_joints = jax_eval(batch)
        np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-4)
        with torch.no_grad():
            probs = torch.sigmoid(port(normalize_batch(
                torch.from_numpy(batch["image"])))).flatten(2)
        top2 = probs.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1] > TIE).numpy()
        got = joints.numpy()
        np.testing.assert_array_equal(got[clear][:, :2],
                                      want_joints[clear][:, :2])
        np.testing.assert_allclose(got[..., 2], want_joints[..., 2],
                                   rtol=0, atol=1e-5)
        checked += int(clear.sum())
    assert checked >= 0.75 * len(dm.val_db) * 17


def test_metric_matches_jax_on_same_joints(setup, jax_eval, tmp_path,
                                           monkeypatch):
    cfg, jax_dm, _, _, _ = setup
    monkeypatch.chdir(tmp_path)  # the metric writes results.json to cwd
    ours = SBPmAPCOCO(cfg["val_path"], cfg["input_size"], CONF)
    theirs = JaxSBPmAPCOCO(cfg["val_path"], cfg["input_size"], CONF)
    for batch in jax_dm.val_loader():
        _, joints = jax_eval(batch)
        # GT-decoded joints score high; the model's own ones near 0
        gt = np.concatenate([batch["joints"], batch["joints_vis"][..., None]],
                            axis=-1).astype(np.float32)
        for j in (joints, gt):
            ours.update_state_decoded(batch, torch.tensor(j))
            theirs.update_state_decoded(batch, j)
    assert ours.result_list == theirs.result_list
    ap = ours.result(verbose=False)
    assert ap == theirs.result(verbose=False)
    assert 0.0 < ap <= 1.0


@pytest.mark.parametrize("case", ["random", "stamped"])
def test_metric_update_state_matches_jax_on_same_logits(setup, case,
                                                        tmp_path,
                                                        monkeypatch):
    """update_state decodes NCHW logits (the port) and NHWK logits (JAX)
    before packing.  Random logits x3 (peaks well apart, as in the decode
    tests) or logits peaked at the ground truth (AP > 0).  x and y are
    equal, score within 1e-6 (sigmoid values of torch and XLA may differ
    by an ulp), AP equal."""
    cfg, jax_dm, _, _, _ = setup
    monkeypatch.chdir(tmp_path)  # the metric writes results.json to cwd
    ours = SBPmAPCOCO(cfg["val_path"], cfg["input_size"], CONF)
    theirs = JaxSBPmAPCOCO(cfg["val_path"], cfg["input_size"], CONF)
    rng = np.random.RandomState(7)
    for batch in jax_dm.val_loader():
        n = len(batch["image"])
        if case == "random":
            logits = torch.from_numpy(
                (rng.randn(n, 17, *OUTPUT_HW) * 3).astype(np.float32))
        else:
            maps = _sbp_targets(torch.from_numpy(batch["joints"]),
                                torch.from_numpy(batch["joints_vis"]),
                                OUTPUT_HW[0] / INPUT_HW[0], OUTPUT_HW, 17,
                                SIGMA)
            logits = maps * 10 - 5  # peak sigmoid 0.993, elsewhere < 0.98
        ours.update_state(batch, logits)
        theirs.update_state(batch, jnp.asarray(
            logits.permute(0, 2, 3, 1).numpy()))
    assert len(ours.result_list) == len(theirs.result_list) > 0
    for a, b in zip(ours.result_list, theirs.result_list):
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                     b["category_id"])
        np.testing.assert_array_equal(a["keypoints"], b["keypoints"])
        np.testing.assert_allclose(a["score"], b["score"], rtol=0,
                                   atol=1e-6)
    ap = ours.result(verbose=False)
    assert ap == theirs.result(verbose=False)
    if case == "stamped":
        assert ap > 0.5


def test_validate_and_cli_match_eval_step(setup, jax_eval, tmp_path,
                                         monkeypatch):
    cfg, _, dm, _, port = setup
    monkeypatch.chdir(tmp_path)  # the metric writes results.json to cwd
    eval_step = make_sbp_eval_step(port, INPUT_HW, OUTPUT_HW, 17, SIGMA,
                                   CONF)
    metric = SBPmAPCOCO(cfg["val_path"], cfg["input_size"], CONF)
    losses = []
    for batch in dm.val_loader():
        per, joints = eval_step(_tensors(batch))
        losses.append(per.numpy())
        metric.update_state_decoded(batch, joints)
    want = (float(np.concatenate(losses).mean()), metric.result(False))

    got = validate(cfg, dm, port, device="cpu", verbose=False)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    jax_losses = np.concatenate([jax_eval(b)[0]
                                 for b in dm.val_loader()])
    np.testing.assert_allclose(got[0], jax_losses.mean(), rtol=1e-4)

    ckpt = tmp_path / "model.pt"
    torch.save({"state_dict": {f"model.{k}": v
                               for k, v in port.state_dict().items()}}, ckpt)
    cfg_path = tmp_path / "sbp.yaml"
    cfg_path.write_text("\n".join(
        f"{k}: {v!r}" if isinstance(v, str) else f"{k}: {v}"
        for k, v in dict(cfg, lr=1e-3).items()) + "\n")
    assert port_cli.get_configs(str(cfg_path))["lr"] == 1e-3  # not a str
    cli = port_cli.main(["--cfg", str(cfg_path), "--ckpt", str(ckpt),
                         "--device", "cpu"])
    np.testing.assert_allclose(cli, got, rtol=1e-6)
    assert os.path.exists(tmp_path / "results.json")
