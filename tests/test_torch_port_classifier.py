"""The port's darknet19 classifier path against the JAX package, on the CPU:
the classifier model and its reference state_dict layout, the weight
bridge, one train step (with JAX's dropout mask), the ImageFolder data,
``train_classifier``, the Trainer's ``backbone_pretrained`` warm start
(from the port's classifier checkpoint and from a reference-layout
``ckpt/darknet19-tiny-imagenet.ckpt``, against the JAX Trainer), and
``registry`` / ``utility``.  fp32; JAX at "highest" matmul precision.

Tolerances: eval logits 1e-4 of the largest (fp32 sums in another order,
as the SBP logits); the train step's loss 1e-5 relative (measured 2.3e-6:
a log-softmax of 10 logits of about 1, each a few 1e-6 off after 19
blocks, where SBP's loss sums thousands of map pixels and agrees to 1e-6),
each parameter's update within the one-ulp yardstick of
tests/_torch_update_gap.py, against JAX with flax's two-pass BN variance,
and BN statistics 1e-4 (the SBP train step's); weights, data, checkpoints
and warm starts: equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from pytorch_pose_estimation_tpu import optim as jax_optim
from pytorch_pose_estimation_tpu import registry as jax_registry
from pytorch_pose_estimation_tpu import utility as jax_utility
from pytorch_pose_estimation_tpu.data.classifier_dataset import \
    ImageFolderDataModule as JaxImageFolder
from pytorch_pose_estimation_tpu.models.darknet import \
    Darknet19 as JaxDarknet19
from pytorch_pose_estimation_tpu.models.summary import count_params as \
    jax_count_params
from pytorch_pose_estimation_tpu.models.torch_import import \
    import_torch_state_dict
from pytorch_pose_estimation_tpu.train.trainer import Trainer as JaxTrainer
from pytorch_pose_estimation_tpu_torch import (optim, registry,
                                               train_classifier, utility)
from pytorch_pose_estimation_tpu_torch.config import make_model_name
from pytorch_pose_estimation_tpu_torch.data import ImageFolderDataModule
from pytorch_pose_estimation_tpu_torch.models import (Darknet19,
                                                      Darknet19Classifier,
                                                      count_params, darknet19,
                                                      from_jax_variables,
                                                      lecun_normal_)
from pytorch_pose_estimation_tpu_torch.models.darknet import (
    STAGE_NAMES, dropout_core, sample_dropout_mask)
from pytorch_pose_estimation_tpu_torch.train import Trainer

import _torch_update_gap as G
from test_classifier import _make_imagefolder

C = 10  # classes
HW = 64
BB = "backbone_features_module."


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_flax_classifier(state_dict) -> dict:
    """The port's classifier state_dict -> flax variables of the JAX
    classifier (stages at the top level), through the JAX importer."""
    v = import_torch_state_dict(state_dict)
    return {col: {**v[col].pop("backbone"), **v[col]}
            for col in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def variables():
    """A seeded flax classifier init whose BN running statistics are the
    batch statistics of a seeded batch (eval activations stay O(1))."""
    model = JaxDarknet19(num_classes=C)
    init = _np(model.init(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3))))
    port = Darknet19Classifier(C)
    port.load_state_dict(from_jax_variables(init, "classifier"))
    for m in port.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    x = torch.from_numpy(np.random.RandomState(0).rand(8, 3, HW, HW)
                         .astype(np.float32))
    with torch.no_grad():
        port.train()(x)
    return _np(to_flax_classifier(port.state_dict()))


def _port(variables):
    model = Darknet19Classifier(C)
    model.load_state_dict(from_jax_variables(variables, "classifier"))
    return model


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_state_dict_is_the_reference_classifier_layout(variables):
    """Stages ``stem``, ``layer1`` .. ``layer5`` at their table positions
    and ``classifier.0``: the JAX importer maps every key, and the weight
    bridge round-trips exactly."""
    sd = _port(variables).state_dict()
    assert {k.split(".")[0] for k in sd} == set(STAGE_NAMES) | {"classifier"}
    assert "layer5.1.conv.weight" in sd and "classifier.0.bn.bias" in sd
    back = _np(to_flax_classifier(sd))
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_factory_and_param_count(variables):
    assert darknet19("tiny-imagenet").num_classes == 200
    assert isinstance(darknet19(features_only=True), Darknet19)
    assert count_params(darknet19(num_classes=C)) == \
        jax_count_params(variables["params"])
    with pytest.raises(ValueError, match="classifier"):
        from_jax_variables(variables, "hourglass")


def test_logits_match_flax_fp32(variables):
    """Eval mode (no dropout): within 1e-4 of the largest logit."""
    x = np.random.RandomState(1).rand(2, 3, HW, HW).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxDarknet19(num_classes=C).apply(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1))))
    with torch.no_grad():
        got = _port(variables).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, C)
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_dropout_sampler_and_core():
    """The core is flax's Dropout for a given keep mask; the sampler keeps
    half, from its generator."""
    x = torch.randn(4, 1024, 2, 2, generator=torch.Generator().manual_seed(0))
    keep = sample_dropout_mask(torch.Generator().manual_seed(1), x.shape)
    again = sample_dropout_mask(torch.Generator().manual_seed(1), x.shape)
    assert torch.equal(keep, again) and abs(float(keep.float().mean())
                                            - 0.5) < 0.03
    got = dropout_core(x, keep)
    assert torch.equal(got[keep], x[keep] * 2) and (got[~keep] == 0).all()
    xb = x.to(torch.bfloat16)
    assert dropout_core(xb, keep).dtype == torch.bfloat16


SGD = dict(momentum=0.9, weight_decay=5e-4, nesterov=True)


def _step_inputs():
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (4, HW, HW, 3), dtype=np.uint8)
    return images, np.array([1, 7, 3, 1], np.int32)


class _TwoPassBatchNorm(fnn.BatchNorm):
    """flax's BatchNorm with its two-pass batch variance."""
    use_fast_variance: bool = False


def _jax_step(variables, two_pass: bool):
    """JAX's train_classifier step (dropout from a key, one-hot
    log-softmax loss, nesterov SGD with weight decay), fp32 at "highest"
    precision; flax's BatchNorm as it is, or with its two-pass variance."""
    images, labels = _step_inputs()
    tx = jax_optim.get_optimizer("sgd", lr=1e-2, **SGD)
    model = JaxDarknet19(num_classes=C)
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(params):
        logits, mutated = model.apply(
            {"params": params, "batch_stats": stats},
            jnp.asarray(images).astype(jnp.float32) / 255.0, train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=True,
            rngs={"dropout": jax.random.PRNGKey(3)})
        onehot = jax.nn.one_hot(labels, C)
        loss = -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits),
                                 axis=-1))
        return loss, (mutated, logits)

    @jax.jit
    def jax_step(params):
        (loss, (mutated, logits)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, mutated, logits, optax.apply_updates(params, updates)

    with pytest.MonkeyPatch.context() as mp:
        if two_pass:
            mp.setattr(fnn, "BatchNorm", _TwoPassBatchNorm)
        with jax.default_matmul_precision("highest"):
            loss, mutated, logits, new_params = jax_step(params)
    dropped = np.asarray(mutated["intermediates"]["dropout"]["__call__"][0])
    want = from_jax_variables({"params": _np(new_params),
                               "batch_stats": _np(mutated["batch_stats"])},
                              "classifier")
    return {"loss": float(loss), "logits": np.asarray(logits),
            "mask": torch.from_numpy(dropped.transpose(0, 3, 1, 2) != 0),
            "state": want}


def _port_step(start: dict, mask: torch.Tensor, bn_momentum=None, **sgd):
    """The port's ``make_classifier_steps`` from state_dict ``start``, fed
    the keep mask; ``bn_momentum`` (name, value) sets one BN's momentum."""
    images, labels = _step_inputs()
    port = Darknet19Classifier(C)
    port.load_state_dict(start)
    if bn_momentum is not None:
        port.get_submodule(bn_momentum[0]).momentum = bn_momentum[1]
    opt = optim.get_optimizer("sgd", list(port.parameters()), lr=1e-2,
                              **dict(SGD, **sgd))
    step, eval_step = train_classifier.make_classifier_steps(port, opt, C)
    loss, acc = step(torch.from_numpy(images), torch.from_numpy(labels),
                     mask=mask)
    return {"loss": float(loss), "acc": float(acc), "eval_step": eval_step,
            "port": port, "state": port.state_dict()}


@pytest.fixture(scope="module")
def step_case(variables):
    """JAX's step with flax's BatchNorm as it is and with its two-pass
    variance, the port's step fed the two-pass run's dropout mask, and the
    one-ulp yardstick (tests/_torch_update_gap.py).  JAX's mask is read
    from the dropout module's output through ``capture_intermediates``
    (kept where it is non-zero; where its input is 0 the mask does not
    matter)."""
    jax_runs = {two_pass: _jax_step(variables, two_pass)
                for two_pass in (False, True)}
    mask = jax_runs[True]["mask"]
    start = from_jax_variables(variables, "classifier")
    port = _port_step(start, mask)
    names = [n for n, _ in port["port"].named_parameters()]
    ulp = G.ulp_gaps(lambda sd: _port_step(sd, mask)["state"], start,
                     port["state"], names)
    return {"jax": jax_runs[False], "jax_two_pass": jax_runs[True],
            "port": port, "start": start, "names": names, "ulp": ulp,
            "mask": mask}


def test_train_step_matches_jax(step_case):
    """One fp32 train step against JAX's, both fed the same dropout mask:
    the loss to 1e-5 relative, the accuracy equal, every parameter's update
    within the one-ulp yardstick's factors (tests/_torch_update_gap.py) of
    JAX's with flax's two-pass BN variance, the BN running statistics to
    1e-4.  Against flax's default one-pass variance the gap is about ten
    times larger: test_one_pass_variance_is_the_classifier_gap."""
    jax_run, port = step_case["jax_two_pass"], step_case["port"]
    _, labels = _step_inputs()
    np.testing.assert_allclose(port["loss"], jax_run["loss"], rtol=1e-5)
    np.testing.assert_allclose(port["loss"], step_case["jax"]["loss"],
                               rtol=1e-5)
    want_acc = float(np.mean(np.argmax(jax_run["logits"], -1) == labels))
    assert port["acc"] == want_acc
    G.assert_update_close(port["state"], jax_run["state"], step_case["start"],
                          step_case["ulp"], step_case["names"],
                          label="classifier train step, two-pass BN")
    images, _ = _step_inputs()
    hits = port["eval_step"](torch.from_numpy(images),
                             torch.from_numpy(labels))
    assert 0 <= float(hits) <= 4 and not port["port"].training


def test_one_pass_variance_is_the_classifier_gap(step_case):
    """ROADMAP Queue 3: against JAX with flax's default BatchNorm, whose
    one-pass batch variance E[x^2] - E[x]^2 XLA's CPU backend sums in a
    running fp32 sum (tests/test_torch_port_bn_variance.py), the port's
    update is over five times further than against the same step with
    flax's two-pass variance, and the yardstick check flags it.  The
    classifier feels it most: its deep BN layers normalize 16 values a
    channel (4 images of 2x2) whose mean is large next to their spread.
    The gap lies in the reference's rounding, not in the port."""
    port, names = step_case["port"]["state"], step_case["names"]
    one = G.update_gaps(port, step_case["jax"]["state"], names,
                        step_case["start"])
    two = G.update_gaps(port, step_case["jax_two_pass"]["state"], names,
                        step_case["start"])
    print(f"classifier update gap to JAX: one-pass BN median "
          f"{np.median(one):.3g}, max {one.max():.3g}; two-pass median "
          f"{np.median(two):.3g}, max {two.max():.3g}")
    assert np.median(one) > 5 * np.median(two)
    assert G.update_failures(port, step_case["jax"]["state"],
                             step_case["start"], step_case["ulp"], names,
                             label="classifier train step, one-pass BN")


MUTATIONS = {
    "weight_decay_5.5e-4": dict(weight_decay=5.5e-4),
    "nesterov_off": dict(nesterov=False),
    "bn_momentum_layer3.1": dict(bn_momentum=("layer3.1.bn", 0.15)),
    "dropout_channel_flipped": dict(flip_channel=0),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_update_check_flags_a_wrong_step(step_case, mutation):
    """The yardstick check flags a step changed in one way, as the fixed
    2e-2 per-parameter limit it replaced does where that one flags it (both
    against the two-pass JAX step, which the unchanged port passes)."""
    over = dict(MUTATIONS[mutation])
    mask = step_case["mask"].clone()
    if "flip_channel" in over:
        c = over.pop("flip_channel")
        mask[:, c] = ~mask[:, c]
    got = _port_step(step_case["start"], mask, **over)["state"]
    want, names = step_case["jax_two_pass"]["state"], step_case["names"]
    flagged = G.update_failures(got, want, step_case["start"],
                                step_case["ulp"], names, label=mutation)
    old = [n for n, g in zip(names, G.update_gaps(got, want, names,
                                                  step_case["start"]))
           if g > 2e-2] + [k for k, g in G.stats_gaps(got, want).items()
                           if g > G.STATS_BOUND]
    print(f"{mutation}: the yardstick flags {flagged[:3]}; the old limit "
          f"{len(old)} tensors")
    assert flagged


# --------------------------------------------------------------------------
# data, the CLI and the warm start
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("imagefolder"))
    train_dir = _make_imagefolder(root, "train", per_class=4)
    val_dir = _make_imagefolder(root, "val", per_class=2, seed=1)
    return train_dir, val_dir


def test_imagefolder_matches_jax(folders, tmp_path):
    """Classes, db sizes and batches (train over two epochs, val) equal the
    JAX module's; a val directory may lack classes; an unreadable image
    raises IOError on both sides."""
    ours = ImageFolderDataModule(*folders, input_size=32, workers=2,
                                 batch_size=4, seed=3)
    theirs = JaxImageFolder(*folders, input_size=32, workers=2,
                            batch_size=4, seed=3)
    ours.setup()
    theirs.setup()
    assert ours.classes == theirs.classes == ["class_0", "class_1",
                                              "class_2"]
    assert (len(ours.train_db), len(ours.val_db)) == (12, 6)
    assert ours.train_db == theirs.train_db and ours.val_db == theirs.val_db
    for epoch in (0, 1):
        a, b = ours.train_loader(), theirs.train_loader()
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        pairs = list(zip(a, b)) + list(zip(ours.val_loader(batch_size=5),
                                           theirs.val_loader(batch_size=5)))
        assert len(pairs) == 3 + 2
        for x, y in pairs:
            for k in ("image", "label"):
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])

    partial = tmp_path / "val"
    os.makedirs(partial / "class_2")
    (partial / "class_2" / "bad.jpg").write_bytes(b"not a jpeg")
    for cls in (ImageFolderDataModule, JaxImageFolder):
        dm = cls(folders[0], str(partial), 32, 0, 2)
        dm.setup()
        assert dm.val_db == [{"path": str(partial / "class_2" / "bad.jpg"),
                              "label": 2}]
        with pytest.raises(IOError, match="cv2.imread failed"):
            next(iter(dm.val_loader()))


def _classifier_cfg(folders, save_dir, **over):
    cfg = {"model": "darknet19", "dataset_name": "tiny-imagenet",
           "input_size": HW, "train_dir": folders[0],
           "val_dir": folders[1], "workers": 0, "batch_size": 4,
           "epochs": 1, "check_val_every_n_epoch": 1, "save_dir": save_dir,
           "precision": "fp32", "optimizer": "sgd",
           "optimizer_options": {"lr": 1e-2, "momentum": 0.9,
                                 "weight_decay": 5e-4, "nesterov": True},
           "scheduler": "cosine_annealing_warm_restarts",
           "scheduler_options": {"T_0": 10, "T_mult": 2, "eta_min": 1e-4}}
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def classifier_run(folders, tmp_path_factory):
    """``python -m ...train_classifier --cfg ... --device cpu``: one epoch
    of 3 steps, validation, checkpoints."""
    save_dir = tmp_path_factory.mktemp("cls")
    cfg = _classifier_cfg(folders, str(save_dir / "saved"))
    path = save_dir / "cls.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in cfg.items()))
    state = train_classifier.main(["--cfg", str(path), "--device", "cpu"])
    ckpts = save_dir / "saved" / "darknet19_tiny-imagenet" / "version_0" / \
        "checkpoints"
    return state, ckpts


def test_train_classifier_cli_trains_and_checkpoints(classifier_run,
                                                     capsys):
    state, ckpts = classifier_run
    assert state.step == 3  # 12 images at batch 4, 3 classes
    assert state.model.classifier[0].conv.weight.shape[0] == 3
    assert sorted(os.listdir(ckpts)) == [
        "best", "best.meta.json", "epoch=0-step=3", "epoch=0-step=3.meta.json",
        "last", "last.meta.json"]
    meta = json.loads((ckpts / "best.meta.json").read_text())
    assert meta["epoch"] == 0 and 0.0 <= meta["val_loss"] <= 1.0
    saved = torch.load(ckpts / "last")["model"]
    assert list(saved) == list(state.model.state_dict())


def test_warm_start_from_the_port_classifier_checkpoint(classifier_run,
                                                        tmp_path, capsys):
    """An SBP Trainer with ``backbone_pretrained`` = the classifier's
    ``last``: all 18 backbone convs and their BN tensors equal the
    classifier's stages, the deconvs and the head keep their init, and
    ``model_pretrained`` (here the first conv of a fresh model) is applied
    after it."""
    state, ckpts = classifier_run
    cfg = {"model": "simple-baselines-pose", "dataset_name": "coco",
           "input_size": [64, 64], "output_size": [16, 16],
           "num_keypoints": 17, "sigma": 2, "conf_threshold": 0.25,
           "precision": "fp32", "optimizer": "sgd",
           "save_dir": str(tmp_path)}
    cold = Trainer(cfg, None, logging=False, device="cpu").model.state_dict()
    first = BB + "0.0.conv.weight"
    torch.save({first: cold[first]}, tmp_path / "partial.pt")
    warm = Trainer(dict(cfg, backbone_pretrained=str(ckpts / "last"),
                        model_pretrained=str(tmp_path / "partial.pt")),
                   None, logging=False, device="cpu").model.state_dict()
    out = capsys.readouterr().out
    assert out.index("backbone warm-started from") < out.index(
        "warm-started from " + str(tmp_path / "partial.pt"))
    src = state.model.state_dict()
    convs = [k for k in warm if k.startswith(BB) and
             k.endswith("conv.weight")]
    assert len(convs) == 18
    n = 0
    for k in warm:
        if k.startswith(BB) and k != first:
            stage, rest = k[len(BB):].split(".", 1)
            assert torch.equal(warm[k], src[f"{STAGE_NAMES[int(stage)]}."
                                            f"{rest}"]), k
            n += 1
        else:
            assert torch.equal(warm[k], cold[k]), k
    assert n == 18 * 6 - 1
    assert not torch.equal(cold[first], src["stem.0.conv.weight"])


def test_warm_start_tiny_imagenet_matches_jax_trainer(tmp_path, monkeypatch,
                                                      capsys):
    """``backbone_pretrained: 'tiny-imagenet'`` reads
    ``<cwd>/ckpt/darknet19-tiny-imagenet.ckpt`` (a Lightning checkpoint in
    the reference's classifier layout, seeded here): the port's backbone
    equals ``from_jax_variables`` of the JAX Trainer's after its own
    ``_warm_start_backbone`` read the same file."""
    monkeypatch.chdir(tmp_path)
    ref = darknet19("tiny-imagenet")
    lecun_normal_(ref, torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(10)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0, 0.1, generator=gen)
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    os.makedirs("ckpt")
    torch.save({"epoch": 3, "state_dict": {
        f"model.{k}": v for k, v in ref.state_dict().items()}},
        "ckpt/darknet19-tiny-imagenet.ckpt")
    cfg = {"model": "simple-baselines-pose", "dataset_name": "coco",
           "input_size": [64, 64], "output_size": [16, 16],
           "num_keypoints": 17, "sigma": 2, "conf_threshold": 0.25,
           "precision": "fp32", "optimizer": "sgd", "devices": 1,
           "train_path": "/nonexistent", "val_path": "/nonexistent",
           "save_dir": str(tmp_path / "saved"),
           "backbone_pretrained": "tiny-imagenet"}
    ours = Trainer(cfg, None, logging=False, device="cpu")

    class NoData:
        train_db, val_db = [], []

    theirs = JaxTrainer(dict(cfg), NoData(), kind="sbp", logging=False)
    want = from_jax_variables({"params": _np(theirs.state.params),
                               "batch_stats": _np(theirs.state.batch_stats)})
    got = ours.model.state_dict()
    bb = [k for k in want if k.startswith(BB)]
    assert len(bb) == 18 * 6
    for k in bb:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got[BB + "0.0.conv.weight"],
                       ref.state_dict()["stem.0.conv.weight"])


def test_warm_start_skips_or_refuses_what_it_cannot_read(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """A missing 'tiny-imagenet' file and an unknown name are reported and
    skipped, as in JAX; an orbax directory, which the port cannot read, and
    a file without a backbone raise."""
    monkeypatch.chdir(tmp_path)
    cfg = {"input_size": [64, 64], "output_size": [16, 16],
           "num_keypoints": 17, "sigma": 2, "conf_threshold": 0.25,
           "precision": "fp32", "optimizer": "sgd",
           "backbone_pretrained": "tiny-imagenet"}
    tr = Trainer(cfg, None, logging=False, device="cpu")
    assert "backbone_pretrained ckpt not found" in capsys.readouterr().out
    base = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr._warm_start_backbone("no/such/file")
    assert "backbone_pretrained not found, skipping" in \
        capsys.readouterr().out
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, base[k]), k
    with pytest.raises(ValueError, match="directory"):
        tr._warm_start_backbone(str(tmp_path))
    torch.save({"sbp_head.0.weight": torch.zeros(1)}, tmp_path / "x.pt")
    with pytest.raises(ValueError, match="no darknet19 backbone"):
        tr._warm_start_backbone(str(tmp_path / "x.pt"))


def test_registry_and_utility_match_jax():
    assert registry.get_model("darknet19") is darknet19
    assert registry.get_model("resnet50") is None
    assert jax_registry.get_model("resnet50") is None
    registry.register_model("tiny", Darknet19)
    try:
        assert registry.get_model("tiny") is Darknet19
    finally:
        registry._MODELS.pop("tiny")
    assert registry.get_optimizer is optim.get_optimizer
    for v in list(range(1, 200, 7)) + [3.5, 16.2, 1000]:
        for d in (1, 4, 8, 16):
            assert utility.make_divisible(v, d) == \
                jax_utility.make_divisible(v, d), (v, d)
    assert utility.set_parameter_requires_grad is optim.freeze_subtrees
    assert utility.make_model_name is make_model_name
    assert make_model_name({"model": "simple-baselines-pose",
                            "dataset_name": "pis"}) == \
        "simple-baselines-pose_pis"
