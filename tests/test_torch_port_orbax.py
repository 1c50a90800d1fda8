"""The JAX package's orbax checkpoints carried into the port by
``tools/orbax_to_torch.py`` and the port's jax-free mappers
(``models/convert.py``: ``from_jax_variables`` on backbone-only trees,
``from_jax_opt_state``), on the CPU, in fp32 (JAX at "highest").

One module fixture makes the JAX side: a full-width SBP (64x64 input,
calibrated weights) trained 2 steps on one batch with sbp_coco.yaml's sgd
(nesterov, weight decay 5e-3, yolo_lr) and the augmentation off, saved by
the JAX ``CheckpointManager``, and its next step on the same batch; a
params-only SPM tree (``save_params``); the backbone that
``extract_backbone`` takes from the SBP checkpoint; and a darknet19
classifier training checkpoint.  Its temporary directory is removed at
the end.

Tolerances: converted tensors exactly; the next train step's loss 1e-6
relative and each parameter's update 5e-2 of its norm.  The limit is set
from readings of this test's step, not from
``test_torch_port_train.py::test_train_step_matches_jax``'s 2e-2: flax's
BatchNorm takes the batch variance in one pass (E[x^2] - E[x]^2 in
fp32) and the port in two, and on this third step that puts the sound
update 2.41% of its norm from flax's at the median and 3.10% at most
(XLA sums E[x^2] on the CPU in a running fp32 sum: the cause is shown
in test_torch_port_bn_variance.py), while the same step with the trace
dropped reads 80% at most: the test prints both readings and holds the
second past 0.25.
Eval logits 1e-4 absolute (they lie within +-1).  The
optimizer step after a mapped state: ``test_torch_port_optim.py``'s
tolerance (5e-5 relative for the adam family, else 1e-6).
"""

import importlib.util
import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_sbp as jax_test_sbp
from pytorch_pose_estimation_tpu import optim as jax_optim
from pytorch_pose_estimation_tpu.config import get_configs
from pytorch_pose_estimation_tpu.models import SPM as JaxSPM
from pytorch_pose_estimation_tpu.models import SBP as JaxSBP
from pytorch_pose_estimation_tpu.models import darknet19 as jax_darknet19
from pytorch_pose_estimation_tpu.train.checkpoint import (CheckpointManager,
                                                          extract_backbone,
                                                          save_params)
from pytorch_pose_estimation_tpu.train.state import create_train_state
from pytorch_pose_estimation_tpu.train.steps import \
    make_sbp_steps as jax_make_sbp_steps
from pytorch_pose_estimation_tpu_torch import optim
from pytorch_pose_estimation_tpu_torch import test_sbp as port_test_sbp
from pytorch_pose_estimation_tpu_torch.models import (SBP, from_jax_opt_state,
                                                      from_jax_variables,
                                                      load_state_dict_file)
from pytorch_pose_estimation_tpu_torch.models.convert import map_params
from pytorch_pose_estimation_tpu_torch.train import (TrainState, Trainer,
                                                     build_model,
                                                     load_backbone, load_model,
                                                     load_pretrained,
                                                     make_sbp_steps,
                                                     restore_checkpoint)
from pytorch_pose_estimation_tpu_torch.train.checkpoint import \
    backbone_entries
from pytorch_pose_estimation_tpu_torch.train_classifier import \
    build_classifier

from synth_fixture import COCO_KP_NAMES, make_dataset
from test_torch_port_augment import jax_draws
from test_torch_port_models import calibrated_jax_variables
from test_torch_port_train import _batches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "orbax_to_torch", os.path.join(REPO, "tools", "orbax_to_torch.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

HW = (64, 64)
OUT = (16, 16)
K = 17
AUG_OFF = {"rotate_prob": 0.0, "jitter_prob": 0.0, "scale_range": (1.0, 1.0),
           "ratio_range": (1.0, 1.0)}
# configs/sbp_coco.yaml at this size, fp32, one device; yolo_lr's burn-in
# cut to 2 updates so that the third update's lr is 1e-3 (at 2,000 it
# rounds every update away)
CFG = dict(get_configs(os.path.join(REPO, "configs", "sbp_coco.yaml")),
           input_size=list(HW), output_size=list(OUT), precision="fp32",
           devices=1, batch_size=4, workers=2,
           scheduler_options={"burn_in": 2, "steps": [105000],
                              "scales": [0.1]})
SPM_CFG = dict(CFG, input_size=64, output_size=16)
CLS_CFG = dict(get_configs(os.path.join(REPO, "configs",
                                        "darknet19_classifier.yaml")),
               num_classes=5, precision="fp32")
MODEL_DIR = "simple-baselines-pose_coco-keypoints"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trace(opt_state):
    """The TraceState's tree of a plain (unmasked) optax chain."""
    return next(s.trace for s in opt_state if isinstance(s, optax.TraceState))


def _randomized(tree, rng, count):
    """``tree`` with every float leaf random (variances positive) and every
    integer leaf ``count``."""
    def leaf(path, x):
        x = np.asarray(x)
        if x.dtype.kind in "iu":
            return np.full(x.shape, count, x.dtype)
        v = rng.randn(*x.shape).astype(np.float32)
        return np.abs(v) + 0.5 if "var" in jax.tree_util.keystr(path) else v
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def variables():
    return calibrated_jax_variables()


@pytest.fixture(scope="module")
def jax_run(variables, tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax")
    precision = jax.config.jax_default_matmul_precision
    tx, _ = jax_optim.build_optimizer_from_cfg(CFG)
    model = JaxSBP(num_keypoints=K)
    state = create_train_state(model, tx, (1,) + HW + (3,))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    batch, key = _batches(1)[0], jax.random.PRNGKey(5)
    device_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    ckpt_dir = root / "saved" / MODEL_DIR / "version_0" / "checkpoints"
    with jax.default_matmul_precision("highest"):
        step, _ = jax_make_sbp_steps(model, tx, list(HW), OUT, K, 2.0,
                                     augment=AUG_OFF)
        for _ in range(2):  # every step on one batch
            state, _ = step(state, device_batch, key)
        CheckpointManager(str(ckpt_dir)).save_last(state, 0, val_loss=1.25)
        saved = jax.tree_util.tree_map(np.array, state)  # the step donates
        next_state, next_loss = step(state, device_batch, key)

    # SPM: the SBP's trunk under a 35-channel head made of the calibrated
    # 17-channel one (twice, then its first channel), so that the logits
    # stay O(1)
    h = np.asarray(variables["params"]["head"]["kernel"])
    head = np.concatenate([h, h[..., ::-1], h[..., :1]], -1)
    spm = {"params": dict(variables["params"],
                          head={"kernel": head.astype(np.float32)}),
           "batch_stats": variables["batch_stats"]}
    save_params(str(root / "spm_params"), spm)
    extract_backbone(str(ckpt_dir / "last"), str(root / "backbone"))

    cls_tx, _ = jax_optim.build_optimizer_from_cfg(CLS_CFG)
    cls_state = create_train_state(jax_darknet19(num_classes=5), cls_tx,
                                   (1, 64, 64, 3))
    rng = np.random.RandomState(6)
    cls_state = cls_state.replace(
        step=jnp.asarray(4, jnp.int32),
        params=_randomized(cls_state.params, rng, 4),
        batch_stats=_randomized(cls_state.batch_stats, rng, 4),
        opt_state=_randomized(cls_state.opt_state, rng, 4))
    CheckpointManager(str(root / "cls")).save_last(cls_state, 3)
    yield {"root": root, "ckpt_dir": ckpt_dir, "state": saved,
           "next_state": next_state, "next_loss": float(next_loss),
           "batch": batch, "key": key, "spm": spm,
           "cls_state": cls_state}
    jax.config.update("jax_default_matmul_precision", precision)
    shutil.rmtree(root, ignore_errors=True)


def test_port_refuses_orbax_directories_and_names_the_converter(jax_run):
    """``--ckpt``, ``--resume``, ``model_pretrained`` and
    ``backbone_pretrained`` given an orbax directory raise a ValueError
    that names the converter, and read nothing."""
    src = str(jax_run["ckpt_dir"] / "last")
    state = TrainState(build_model(CFG, "sbp"), None, None)
    tr = Trainer(CFG, None, logging=False, device="cpu")
    for load in (load_state_dict_file,
                 lambda p: load_model(CFG, p, device="cpu"),
                 lambda p: restore_checkpoint(p, state),
                 lambda p: load_pretrained(state, p),
                 tr._warm_start_backbone):
        with pytest.raises(ValueError, match="tools/orbax_to_torch.py"):
            load(src)


def _port_state(cfg, path):
    model = build_model(cfg, "sbp")
    opt, schedule = optim.build_optimizer_from_cfg(cfg, model)
    state = TrainState(model, opt, schedule)
    return state, restore_checkpoint(path, state)


def test_training_checkpoint_converts_exactly_and_trains_on(jax_run,
                                                           tmp_path):
    """(a) Every model tensor, every trace, the count, the step and the
    meta exactly JAX's; then the next step from each side on the same
    batch and draws, held at 5e-2 of the update: flax's default one-pass
    BN variance, summed by XLA on the CPU in a running fp32 sum, puts
    JAX's step 2.41-3.10% from the port's (tests/
    test_torch_port_bn_variance.py shows the cause on one BN layer)."""
    out = str(tmp_path / "last")
    assert tool.convert(CFG, str(jax_run["ckpt_dir"] / "last"), out) == {
        out: "train"}
    state = jax_run["state"]
    blob = torch.load(out, weights_only=True)
    meta = {"epoch": 0, "step": 2, "val_loss": 1.25}
    assert blob["step"] == 2 and blob["meta"] == meta and "rng" not in blob
    with open(out + ".meta.json") as f:
        assert json.load(f) == meta
    want = from_jax_variables({"params": _np(state.params),
                               "batch_stats": _np(state.batch_stats)})
    assert set(blob["model"]) == set(want)
    for k, v in want.items():
        assert torch.equal(blob["model"][k], v), k
    port, got_meta = _port_state(CFG, out)
    assert got_meta == meta and port.step == 2
    assert blob["optimizer"]["count"] == 2
    trace = map_params(_np(_trace(state.opt_state)))
    names = [n for n, _ in port.model.named_parameters()]
    assert len(blob["optimizer"]["state"]) == len(names) == len(trace)
    for i, name in enumerate(names):
        assert torch.equal(blob["optimizer"]["state"][i]["trace"],
                           trace[name]), name

    nxt = jax_run["next_state"]
    jax_sd = from_jax_variables({"params": _np(nxt.params),
                                 "batch_stats": _np(nxt.batch_stats)})
    gaps = _next_step_gaps(port, jax_run, jax_sd, names)
    assert max(gaps.values()) <= 5e-2, max(gaps.items(), key=lambda i: i[1])
    assert port.step == int(nxt.step) == 3
    # the limit tells a dropped trace from a sound one
    port, _ = _port_state(CFG, out)
    for s in port.optimizer.state.values():
        s["trace"].zero_()
    dropped = _next_step_gaps(port, jax_run, jax_sd, names)
    print(f"update gap to JAX: median {np.median(list(gaps.values())):.4f}"
          f", max {max(gaps.values()):.4f}; trace dropped: median "
          f"{np.median(list(dropped.values())):.4f}, max "
          f"{max(dropped.values()):.4f}")
    assert max(dropped.values()) > 0.25


def _next_step_gaps(port, jax_run, jax_sd, names):
    """The port's next step from ``port`` on the fixture's batch and draws:
    its loss within 1e-6 of JAX's, and each parameter's update gap to
    JAX's (``jax_sd`` after the step) over the norm of JAX's update."""
    model = port.model.train()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    step, _ = make_sbp_steps(model, port.optimizer, list(HW), OUT, K, 2.0,
                             0.25, augment=AUG_OFF)
    loss = step({k: torch.from_numpy(v) for k, v in jax_run["batch"].items()},
                draws=jax_draws(jax_run["key"], 2, HW, **AUG_OFF))
    np.testing.assert_allclose(float(loss), jax_run["next_loss"], rtol=1e-6)
    sd = model.state_dict()
    gaps = {}
    for name in names:
        jax_update = jax_sd[name] - start[name]
        gaps[name] = float((sd[name] - start[name] - jax_update).norm()
                           / jax_update.norm())
    return gaps
    assert port.step == int(nxt.step) == 3


def test_params_only_spm_tree_serves_like_flax(jax_run, tmp_path):
    """(b, d) ``save_params`` of an SPM -> a bare state_dict (the kind from
    the config: one input size), which ``load_model`` serves: logits within
    1e-4 of flax's, and ``spm_head.0.weight`` exactly the kernel."""
    out = str(tmp_path / "spm.pt")
    assert tool.convert(SPM_CFG, str(jax_run["root"] / "spm_params"),
                        out) == {out: "params"}
    sd = load_state_dict_file(out)
    want = from_jax_variables(jax_run["spm"], "spm")
    assert set(sd) == set(want) and "spm_head.0.weight" in sd
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    model = load_model(SPM_CFG, out, device="cpu", kind="spm")
    # the calibration batch's first rows (calibrated_jax_variables' default)
    x = np.random.RandomState(0).rand(8, 3, 64, 48)[:2].transpose(
        0, 2, 3, 1).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        flax = np.asarray(JaxSPM(num_keypoints=K).apply(
            jax_run["spm"], jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert 0.5 < np.abs(flax).max() <= 1.0 + 1e-4
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), flax, atol=1e-4)


def test_backbone_only_tree_overlays_the_backbone_alone(jax_run, tmp_path):
    """(c) ``extract_backbone``'s tree -> the ``backbone_features_module.*``
    entries; ``load_pretrained`` (``model_pretrained``) and
    ``load_backbone`` (``backbone_pretrained``) copy exactly those, and
    nothing else moves."""
    out = str(tmp_path / "pretrained_weights")
    assert tool.convert(CFG, str(jax_run["root"] / "backbone"), out) == {
        out: "backbone"}
    state = jax_run["state"]
    full = from_jax_variables({"params": _np(state.params),
                               "batch_stats": _np(state.batch_stats)})
    want = {k: v for k, v in full.items()
            if k.startswith("backbone_features_module.")}
    sd = load_state_dict_file(out)
    assert set(sd) == set(want) and len(want) == 18 * 6
    for overlay in (lambda st: load_pretrained(st, out),
                    lambda st: load_backbone(st.model, out)):
        port = TrainState(build_model(CFG, "sbp"), None, None)
        before = {k: v.clone() for k, v in port.model.state_dict().items()}
        overlay(port)
        for k, v in port.model.state_dict().items():
            assert torch.equal(v, want[k] if k in want else before[k]), k


def test_classifier_checkpoint_warm_starts_the_backbone(jax_run, tmp_path):
    """(d) A darknet19 classifier's training checkpoint (the kind from the
    config) -> the port's checkpoint in the classifier layout, every
    tensor exact; as ``backbone_pretrained`` it overlays the pose model's
    backbone exactly."""
    src = jax_run["root"] / "cls" / "last"
    out = str(tmp_path / "cls_last")
    assert tool.convert(CLS_CFG, str(src), out) == {out: "train"}
    cls = jax_run["cls_state"]
    blob = torch.load(out, weights_only=True)
    want = from_jax_variables({"params": _np(cls.params),
                               "batch_stats": _np(cls.batch_stats)},
                              "classifier")
    assert set(blob["model"]) == set(want) and "stem.0.conv.weight" in want
    for k, v in want.items():
        assert torch.equal(blob["model"][k], v), k
    trace = map_params(_np(_trace(cls.opt_state)), "classifier")
    assert blob["step"] == blob["optimizer"]["count"] == 4
    names = [n for n, _ in build_classifier(CLS_CFG, 5).named_parameters()]
    assert len(blob["optimizer"]["state"]) == len(names) == len(trace)
    for i, name in enumerate(names):
        assert torch.equal(blob["optimizer"]["state"][i]["trace"],
                           trace[name]), name

    tr = Trainer(dict(CFG, backbone_pretrained=out), None, logging=False,
                 device="cpu")
    plain = build_model(CFG, "sbp").state_dict()
    bb = backbone_entries(want)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, bb[k] if k in bb else plain[k]), k


def test_tree_that_does_not_fit_the_config_is_refused(jax_run, tmp_path):
    """The model comes from ``--cfg`` alone: a classifier checkpoint under
    a pose config, and an SPM tree under the SBP config, raise and write
    nothing."""
    out = tmp_path / "out"
    for cfg, src, match in (
            (CFG, jax_run["root"] / "cls" / "last",
             "holds a darknet19 classifier"),
            (CLS_CFG, jax_run["ckpt_dir"] / "last", "holds a pose model"),
            (CFG, jax_run["root"] / "spm_params",
             r"sbp_head\.0\.weight \(35, 512, 1, 1\) "
             r"\(the model's \(17, 512, 1, 1\)\)")):
        with pytest.raises(ValueError, match=match):
            tool.convert(cfg, str(src), str(out))
        assert not out.exists()


@pytest.fixture(scope="module")
def opt_inputs(variables):
    """Two seeded gradients of the SBP's parameters (flax trees and mapped
    to torch) and a port model to load each case's weights into."""
    rng = np.random.RandomState(11)
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.randn(*p.shape) * 1e-2).astype(np.float32),
        variables["params"]) for _ in range(2)]
    return grads, map_params(grads[1]), SBP(K)


OPT_CASES = {
    "sgd": ("sgd", {"lr": 1e-2}, None),
    "sgd-nesterov-wd": ("sgd", {"lr": 1e-2, "momentum": 0.9,
                                "weight_decay": 5e-3, "nesterov": True},
                        None),
    "sgd-nesterov-freeze-backbone": ("sgd", {"lr": 1e-2, "momentum": 0.9,
                                             "nesterov": True},
                                     ["backbone"]),
    "adam": ("adam", {"lr": 1e-3, "weight_decay": 1e-4}, None),
    "adam-freeze-head": ("adam", {"lr": 1e-3}, ["head", "deconv_1"]),
    "adamw": ("adamw", {"lr": 1e-3, "weight_decay": 1e-2}, None),
    "radam": ("radam", {"lr": 1e-3}, None),
    "rmsprop": ("rmsprop", {"lr": 1e-3, "alpha": 0.9}, None),
    "rmsprop-momentum": ("rmsprop", {"lr": 1e-3, "alpha": 0.9,
                                     "momentum": 0.8}, None),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_state_maps_onto_the_port_optimizer(variables, opt_inputs,
                                                      case):
    """(e) optax's state after one update, flattened by the tool and mapped
    by ``from_jax_opt_state`` onto the port's optimizer built from the
    same config: the next update and the state after it equal optax's.
    Frozen subtrees carry no state and do not move."""
    name, options, freeze = OPT_CASES[case]
    (g1, g2), g2_torch, model = opt_inputs
    cfg = dict(CFG, optimizer=name, optimizer_options=options,
               scheduler="multi_step",
               scheduler_options={"milestones": [1], "gamma": 0.5})
    if freeze:
        cfg["freeze"] = freeze
    tx, _ = jax_optim.build_optimizer_from_cfg(cfg)

    @jax.jit
    def two_updates(params, g1, g2):
        updates, state = tx.update(g1, tx.init(params), params)
        params = optax.apply_updates(params, updates)
        updates, new_state = tx.update(g2, state, params)
        return state, params, optax.apply_updates(params, updates), new_state

    opt_state, params, want, new_state = _np(two_updates(
        variables["params"], g1, g2))
    flat = tool.flatten_opt_state(opt_state)
    assert flat["count"] == 1
    model.load_state_dict(from_jax_variables(
        {"params": params, "batch_stats": variables["batch_stats"]}))
    opt, _ = optim.build_optimizer_from_cfg(cfg, model)
    opt.load_state_dict(from_jax_opt_state(flat, model, opt))
    for n, p in model.named_parameters():
        p.grad = g2_torch[n]
    opt.step()
    want = map_params(want)
    rtol = 5e-5 if name in ("adam", "adamw", "radam") else 1e-6
    frozen = tuple(optim._SUBTREES.get(f, f) + "." for f in freeze or ())
    start = map_params(params)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=rtol, atol=1e-7, err_msg=n)
        if n.startswith(frozen):
            assert torch.equal(p.detach(), start[n]), n
    after = tool.flatten_opt_state(new_state)
    moments = sorted(k for k in after if k != "count")
    assert opt.count == after["count"] == 2
    assert moments == {"sgd": ["trace"] if "momentum" in options else [],
                       "rmsprop": ["nu", "trace"] if "momentum" in options
                       else ["nu"]}.get(name, ["mu", "nu"])
    names = {id(p): n for n, p in model.named_parameters()}
    for k in moments:
        mapped = map_params(after[k], partial=True)
        assert len(mapped) == len(opt.state)
        for p, s in opt.state.items():
            want_k = mapped[names[id(p)]].numpy()
            np.testing.assert_allclose(s[k].numpy(), want_k, rtol=rtol,
                                       atol=1e-6 * np.abs(want_k).max())


def test_cli_prints_jax_numbers_and_resume_auto_finds_the_copy(
        jax_run, tmp_path, monkeypatch, capsys):
    """(f) JAX ``test_sbp`` on the orbax checkpoint and the port's
    ``test_sbp`` on its conversion print the same val_loss and AP@.5 to 4
    decimals on fixture data; a converted ``checkpoints/`` directory is
    what ``--resume auto`` picks."""
    root = str(tmp_path / "coco")
    json_path = make_dataset(root, "val2017", 4, seed=3)
    cfg = dict(CFG, train_path=json_path, val_path=json_path, img_dir=root,
               class_labels=COCO_KP_NAMES,
               save_dir=str(tmp_path / "port_saved"))
    ckpts = os.path.join(cfg["save_dir"], MODEL_DIR, "version_0",
                         "checkpoints")
    last = os.path.join(ckpts, "last")
    cfg_path = tmp_path / "sbp.yaml"
    cfg_path.write_text(json.dumps(cfg))  # JSON is YAML
    assert tool.main(["--cfg", str(cfg_path), "--src",
                      str(jax_run["ckpt_dir"]), "--out", ckpts]) == {
        last: "train"}
    assert os.path.isfile(last) and os.path.isfile(last + ".meta.json")
    monkeypatch.chdir(tmp_path)  # the metrics write results.json here
    capsys.readouterr()
    jax_test_sbp.test(cfg, str(jax_run["ckpt_dir"] / "last"))
    port_test_sbp.test(cfg, last, device="cpu")
    lines = re.findall(r"val_loss=\S+ val_mAP=\S+", capsys.readouterr().out)
    assert len(lines) == 2 and lines[0] == lines[1], lines
    tr = Trainer(cfg, None, logging=False, device="cpu")
    assert tr._find_auto_resume() == last
