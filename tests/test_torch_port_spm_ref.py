"""SPM at reference scale (configs/spm_synth_ref.yaml) in the port against
the JAX package on the CPU: the corpus recipe of ``tools.spm_ref`` (the
500 val images and 2,774 instances behind the JAX run in PARITY.md), the
accuracy arm's config copy, and, on a prefix of that val set at 128 -> 32
with its real crowds (3-8 persons an image) and ``max_persons`` 10, the
SPM data module, one ``augment_geometric`` train step with the JAX draws
fed in, and the OKS metric; then the cached, geometric SPM fit resumed
after epoch 1 against the uninterrupted fit.

The train step and the fit run a small stand-in for darknet19 SPM (a
stride-4 conv, BatchNorm, a 1x1 head of 1 + 2K channels): the full-width
model's steps are held to JAX at 64x64 in test_torch_port_spm_train.py.
Tolerances are stated in each test.
"""

import json
import os
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from pytorch_pose_estimation_tpu import config as jax_config
from pytorch_pose_estimation_tpu import optim as jax_optim
from pytorch_pose_estimation_tpu.data import \
    SPMCOCODataModule as JaxDataModule
from pytorch_pose_estimation_tpu.eval.metrics import \
    SPMmAPCOCO as JaxSPMmAPCOCO
from pytorch_pose_estimation_tpu.ops import image as jax_image
from pytorch_pose_estimation_tpu.train import steps as jax_steps
from pytorch_pose_estimation_tpu.train.state import create_train_state
from pytorch_pose_estimation_tpu_torch import config, optim
from pytorch_pose_estimation_tpu_torch.data import SPMCOCODataModule
from pytorch_pose_estimation_tpu_torch.eval import SPMmAPCOCO
from pytorch_pose_estimation_tpu_torch.models.layers import BatchNorm2d
from pytorch_pose_estimation_tpu_torch.ops import decode_spm_batch
from pytorch_pose_estimation_tpu_torch.tools import spm_ref
from pytorch_pose_estimation_tpu_torch.train import Trainer, make_spm_steps
from pytorch_pose_estimation_tpu_torch.train import trainer as port_trainer

from synth_fixture import make_dataset
from test_torch_port_augment import jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "synth_fixture.py")
YAML = os.path.join(REPO, spm_ref.CONFIG)
SCRIPT = os.path.join(REPO, "pytorch_pose_estimation_tpu_torch", "tools",
                      "accuracy_on_card.sh")
IN, OUT, K, SIGMA, CONF = 128, 32, 17, 1.0, 0.5
P = spm_ref.SPM_SYNTH_REF["max_persons"]  # 10
C = 1 + 2 * K
SGD = dict(momentum=0.9, weight_decay=5e-3, nesterov=True)


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    """The corpus's val split through the recipe: (root, annotation path,
    images, instances)."""
    root = str(tmp_path_factory.mktemp("spm_ref"))
    path, n, inst = spm_ref.make_corpus(root, FIXTURE,
                                        splits=("val2017",))["val2017"]
    return root, path, n, inst


def _prefix(val_set, tmp_path, n):
    """An annotation file of the val set's first ``n`` images (their
    instances in order), named as the val split's (the data modules find
    the images' folder from the name); the images stay where they are."""
    root, path, *_ = val_set
    with open(path) as f:
        db = json.load(f)
    db["images"] = db["images"][:n]
    ids = {im["id"] for im in db["images"]}
    db["annotations"] = [a for a in db["annotations"]
                         if a["image_id"] in ids]
    os.makedirs(tmp_path / "prefix")
    out = str(tmp_path / "prefix" / os.path.basename(path))
    with open(out, "w") as f:
        json.dump(db, f)
    return out


# --------------------------------------------------------------------------
# the corpus and the config
# --------------------------------------------------------------------------

def test_corpus_recipe_is_the_jax_runs_val_set(val_set, tmp_path):
    """The recipe's val split holds PARITY.md's 500 images and 2,774
    instances, and its annotation file is byte for byte (so every number
    in it) the one a direct ``make_dataset`` call with the recipe's
    arguments writes."""
    root, path, n, inst = val_set
    assert (n, inst) == (500, 2774)
    direct = make_dataset(str(tmp_path), "val2017", 500, seed=1,
                          img_size=(512, 640), min_persons=3, max_persons=8,
                          clutter=8, occlude_prob=0.3, scale_jitter=True)
    with open(path, "rb") as a, open(direct, "rb") as b:
        assert a.read() == b.read()
    with open(path) as f:
        db = json.load(f)
    per_image = np.bincount([a["image_id"] for a in db["annotations"]])[1:]
    assert per_image.min() == 3 and per_image.max() == 8
    assert {(im["width"], im["height"]) for im in db["images"]} == \
        {(640, 512)}


def test_corpus_recipe_fails_on_other_counts(tmp_path, monkeypatch):
    """A split whose counts are not the recipe's raises."""
    monkeypatch.setitem(spm_ref.SPLITS, "val2017", (3, 1, 99))
    with pytest.raises(RuntimeError, match="recipe's are 3 and 99"):
        spm_ref.make_corpus(str(tmp_path), FIXTURE, splits=("val2017",))


def test_inline_recipe_is_the_yaml():
    """``SPM_SYNTH_REF`` (phase 13's config, without PyYAML) equals the
    YAML read by the port's and by the JAX package's ``get_configs``."""
    assert spm_ref.SPM_SYNTH_REF == config.get_configs(YAML) == \
        jax_config.get_configs(YAML)


@pytest.mark.parametrize("epochs", [90, 2])
def test_arm_config_copy_differs_in_epochs_only(epochs, tmp_path):
    """The accuracy arm's copy of the YAML (``tools.spm_ref config``, as
    the script writes it), read by the port, equals the JAX package's
    ``get_configs`` of the YAML in every key but ``epochs``; one line of
    text differs."""
    out = spm_ref.write_config(str(tmp_path / "a" / "spm.yaml"), epochs,
                               YAML)
    ours, theirs = config.get_configs(out), jax_config.get_configs(YAML)
    assert ours["epochs"] == epochs and theirs["epochs"] == 200
    assert {k: v for k, v in ours.items() if k != "epochs"} == \
        {k: v for k, v in theirs.items() if k != "epochs"}
    with open(out) as a, open(YAML) as b:
        diff = [(x, y) for x, y in zip(a, b) if x != y]
    assert diff == [(f"epochs: {epochs}\n", "epochs: 200\n")]
    with open(SCRIPT) as f:
        script = f.read()
    assert "SPM_EPOCHS=${SPM_EPOCHS:-90}" in script
    assert 'spm_run spm_s$SEED ref "$SPM_EPOCHS" "$SEED"' in script
    assert '-m $M.tools.spm_ref config "$cfg" --recipe "$recipe" --epochs ' \
        '"$epochs"' in script
    assert '-m $M.train_spm --cfg "$cfg" --resume auto' in script


# --------------------------------------------------------------------------
# data, step and metric on a prefix of the val set
# --------------------------------------------------------------------------

def _data_modules(val_set, path, batch_size=4):
    root = val_set[0]
    args = (path, path, root, IN, OUT, K, SIGMA, 2, batch_size,
            spm_ref.COCO_KP_NAMES)
    # the recipe's cache_device puts CLAHE in the step: none on the host
    kw = dict(max_persons=P, use_native=False, clahe_prob=0.0, seed=0)
    port, theirs = SPMCOCODataModule(*args, **kw), JaxDataModule(*args, **kw)
    port.setup()
    theirs.setup()
    return port, theirs


def test_data_module_matches_jax_on_the_crowds(val_set, tmp_path):
    """On the first 8 val images (43 persons) at 128 in, ``max_persons``
    10: two shuffled train epochs and the val batches equal the JAX cv2
    loader's, key by key, dtype by dtype and exactly."""
    port, theirs = _data_modules(val_set, _prefix(val_set, tmp_path, 8))
    pairs = []
    for epoch in (0, 1):
        a, b = port.train_loader(), theirs.train_loader()
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        pairs += zip(list(a), list(b))
    pairs += zip(list(port.val_loader()), list(theirs.val_loader()))
    assert len(pairs) == 6
    for x, y in pairs:
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    persons = (pairs[-1][0]["centers"][..., 0, :] > 0).any(-1).sum(-1)
    assert pairs[-1][0]["joints"].shape == (4, P, K, 2)
    assert persons.min() >= 3 and persons.max() <= 8


class _FlaxTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Conv(8, (4, 4), strides=(4, 4), padding="VALID",
                     use_bias=False)(x)
        # the two-pass variance: flax's default E[x^2] - E[x]^2 loses
        # digits in fp32 on these all-positive conv outputs (the step's
        # loss 3.5e-6 from the port's with it, 1.5e-6 without)
        x = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                          epsilon=1e-5, use_fast_variance=False)(x)
        return fnn.Conv(C, (1, 1), use_bias=False)(fnn.relu(x))


class _TorchTiny(nn.Module):
    """``_FlaxTiny`` in NCHW: 1 + 2K maps at a quarter of the input."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 4, 4, bias=False)
        self.bn = BatchNorm2d(8)
        self.head = nn.Conv2d(8, C, 1, bias=False)

    def forward(self, x):
        return self.head(torch.relu(self.bn(self.conv(x))))


def _from_flax(model, params):
    sd = {"conv.weight": params["Conv_0"]["kernel"],
          "bn.weight": params["BatchNorm_0"]["scale"],
          "bn.bias": params["BatchNorm_0"]["bias"],
          "head.weight": params["Conv_1"]["kernel"]}
    with torch.no_grad():
        for k, v in sd.items():
            v = torch.from_numpy(np.array(v))
            model.state_dict()[k].copy_(v.permute(3, 2, 0, 1)
                                        if v.dim() == 4 else v)
    return model


def _jax_step_op_by_op(monkeypatch, batch, key):
    """Replace the JAX step's ``augment_batch`` by its result on the
    step's arguments (train/steps.py:151-161, no CLAHE) computed op by op:
    jitted on the CPU, XLA's fused hue op moves some pixels (ROADMAP Queue
    3)."""
    b = batch["image"].shape[0]
    pts = jnp.concatenate([jnp.asarray(batch["joints"]).reshape(b, P * K, 2),
                           jnp.asarray(batch["centers"]).reshape(b, P, 2)],
                          axis=1)
    valid = (~((pts[..., 0] <= 0) & (pts[..., 1] <= 0))).astype(jnp.float32)
    with jax.disable_jit():
        out = jax_image.augment_batch(
            key, jnp.asarray(batch["image"]), pts, valid, (IN, IN), 30.0,
            (0.6, 1.0), (0.75, 1.33), (0.5, 0.2, 0.5, 0.1), 0.0)
    monkeypatch.setattr(jax_steps, "augment_batch", lambda *args: out)


def test_geometric_train_step_matches_jax_on_the_crowds(val_set, tmp_path,
                                                        monkeypatch):
    """One ``augment_geometric`` train step on the first val batch (4
    images, 26 persons, 10 slots an image) with JAX's draws fed in: the loss
    to 2e-6 relative, each parameter's update to 0.1 of its norm and the
    BN statistics to 1e-4 of their largest (the full-width step's bounds
    in test_torch_port_spm_train.py), nesterov SGD with weight decay under
    yolo_lr shifted by 3 updates (its first update has lr 0).

    Without the recipe's device CLAHE: JAX's CLAHE must run op by op here
    (jitted on the CPU it moves pixels by up to 2 levels) and takes 21 s
    at this size.  The full-width geometric step with CLAHE at p 0.5 is
    held to JAX at 64x64 (test_torch_port_spm_train.py)."""
    _, theirs = _data_modules(val_set, _prefix(val_set, tmp_path, 4))
    batch = {k: next(iter(theirs.val_loader()))[k]
             for k in ("image", "joints", "centers")}
    assert (batch["centers"][..., 0, 0] > 0).sum() >= 12
    key = jax.random.PRNGKey(21)

    jax_yolo = jax_optim.yolo_lr(1e-3, 2, [100], [0.1])
    tx = jax_optim.get_optimizer("sgd", schedule=lambda c: jax_yolo(c + 3),
                                 **SGD)
    model = _FlaxTiny()
    state = create_train_state(model, tx, (1, IN, IN, 3),
                               rng=jax.random.PRNGKey(3))
    params0 = jax.tree_util.tree_map(np.array, state.params)
    _jax_step_op_by_op(monkeypatch, batch, key)
    jax_step, _ = jax_steps.make_spm_steps(
        model, tx, IN, OUT, K, SIGMA,
        augment={"geometric": True})
    with jax.default_matmul_precision("highest"):
        state, want = jax_step(state, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, key)

    port = _from_flax(_TorchTiny(), params0)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    port_yolo = optim.yolo_lr(1e-3, 2, [100], [0.1])
    opt = optim.get_optimizer("sgd", list(port.parameters()),
                              schedule=lambda c: port_yolo(c + 3), **SGD)
    step, _ = make_spm_steps(port, opt, IN, OUT, K, SIGMA, CONF,
                             augment={"geometric": True}, max_persons=P)
    draws = jax_draws(key, 4, (IN, IN), rotate_limit=30.0,
                      scale_range=(0.6, 1.0), ratio_range=(0.75, 1.33))
    got = step({k: torch.from_numpy(v) for k, v in batch.items()},
               draws=draws)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-6)

    new = _from_flax(_TorchTiny(), jax.tree_util.tree_map(np.array,
                                                          state.params))
    jax_sd, sd = new.state_dict(), port.state_dict()
    for name, _ in port.named_parameters():
        moved = float((jax_sd[name] - start[name]).norm())
        gap = float((sd[name] - jax_sd[name]).norm())
        assert moved > 0 and gap <= 0.1 * moved, (name, gap, moved)
    stats = state.batch_stats["BatchNorm_0"]
    for ours, theirs_key in (("bn.running_mean", "mean"),
                             ("bn.running_var", "var")):
        want_s = np.asarray(stats[theirs_key])
        np.testing.assert_allclose(sd[ours].numpy(), want_s, rtol=0,
                                   atol=1e-4 * np.abs(want_s).max())


def test_metric_matches_jax_on_the_crowds(val_set, tmp_path, monkeypatch):
    """On the first 16 val images (87 persons, 10 slots an image): the
    result list and the AP of the same predictions equal JAX's exactly,
    for the ground truth itself (roots at the centers, conf 1; empty slots
    at -1) and for the decode of random logits."""
    path = _prefix(val_set, tmp_path, 16)
    monkeypatch.chdir(tmp_path)  # the metric writes results.json to cwd
    ours = SPMmAPCOCO(path, IN, SIGMA, CONF, P)
    theirs = JaxSPMmAPCOCO(path, IN, SIGMA, CONF, P)
    _, jax_dm = _data_modules(val_set, path)
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
            rng.randn(b, C, OUT, OUT).astype(np.float32) * 3)
        for decoded in ((torch.from_numpy(roots), torch.from_numpy(kps)),
                        decode_spm_batch(logits, IN, SIGMA, CONF, True, P)):
            ours.update_state_decoded(batch, decoded)
            theirs.update_state_decoded(
                batch, tuple(a.numpy() for a in decoded))
    assert len(ours.result_list) > 87  # the 87 GT persons and more
    assert ours.result_list == theirs.result_list
    ap = ours.result(verbose=False)
    assert ap == theirs.result(verbose=False) and ap > 0.4


# --------------------------------------------------------------------------
# the resumed fit
# --------------------------------------------------------------------------

def _fit_cfg(val_set, path, save_dir, epochs):
    return dict(spm_ref.SPM_SYNTH_REF, train_path=path, val_path=path,
                img_dir=val_set[0], input_size=IN, output_size=OUT,
                batch_size=4, workers=2, epochs=epochs, save_dir=save_dir,
                precision="fp32",
                trainer_options={"check_val_every_n_epoch": 3,
                                 "num_sanity_val_steps": 0})


def _fit(cfg, resume=None):
    dm = SPMCOCODataModule(
        cfg["train_path"], cfg["val_path"], cfg["img_dir"], IN, OUT, K,
        SIGMA, 2, cfg["batch_size"], cfg["class_labels"], max_persons=P,
        use_native=False)
    dm.setup()
    trainer = Trainer(cfg, dm, kind="spm", device="cpu")
    assert trainer.augment == {"clahe_prob": 0.5, "geometric": True}
    return trainer.fit(resume=resume)


def test_resumed_cached_geometric_fit_is_bitwise_the_uninterrupted_one(
        val_set, tmp_path, monkeypatch, capsys):
    """``cache_device`` and ``augment_geometric`` on 8 val images (2
    steps an epoch): a fit of 2 epochs resumed with 'auto' for a third
    ends with parameters, BN statistics and momenta bitwise equal to an
    uninterrupted 3-epoch fit, as the row order and the draws continue.
    Resumed from a checkpoint without the generators' states (as written
    before they were saved), the fit replays epoch 0's draws and ends
    elsewhere."""
    monkeypatch.setattr(port_trainer, "build_model",
                        lambda cfg, kind: _TorchTiny())
    path = _prefix(val_set, tmp_path, 8)

    def run(name, plan):
        save = str(tmp_path / name)
        for epochs, resume in plan:
            torch.manual_seed(0)  # the stand-in's init
            state = _fit(_fit_cfg(val_set, path, save, epochs), resume)
        return state, save

    whole, _ = run("whole", [(3, None)])
    resumed, save = run("resumed", [(2, None), (3, "auto")])
    assert "resuming at epoch 2 (global step 4)" in capsys.readouterr().out
    assert whole.step == resumed.step == 6

    def flat(state):
        out = dict(state.model.state_dict())
        for i, s in enumerate(state.optimizer.state_dict()["state"]
                              .values()):
            out.update({f"opt{i}.{k}": v for k, v in s.items()
                        if torch.is_tensor(v)})
        return out

    a, b = flat(whole), flat(resumed)
    assert set(a) == set(b) and any(k.startswith("opt") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k

    last = os.path.join(save, "single-stage-pose-machines_spm-synth-ref",
                        "version_0", "checkpoints", "last")
    blob = torch.load(last, weights_only=True)
    assert len(blob.pop("rng")) == 2
    old = str(tmp_path / "old" / "single-stage-pose-machines_spm-synth-ref"
              / "version_0" / "checkpoints")
    os.makedirs(old)
    torch.save(blob, os.path.join(old, "last"))
    shutil.copy(last + ".meta.json", os.path.join(old, "last.meta.json"))
    replayed, _ = run("old", [(3, "auto")])
    assert replayed.step == 6
    assert not torch.equal(replayed.model.conv.weight,
                           whole.model.conv.weight)
