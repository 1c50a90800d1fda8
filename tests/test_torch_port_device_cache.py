"""The port's device cache (``cache_device``) against the JAX package's, on
the CPU: the order of every epoch, the gathered batches, the disk memo
(each package reads the other's), the batches the cached ``Trainer.fit``
feeds its train step, and where one YAML puts CLAHE in both packages.

Tolerance: none; every comparison is exact (integers, uint8 pixels, and
fp32 joints copied, never computed, on both sides).  The JAX side runs on a
one-device mesh, the port's cache on the CPU.
"""

import os
import shutil

import jax
import numpy as np
import pytest
from flax import linen as fnn
from torch import nn

from pytorch_pose_estimation_tpu.data import \
    SBPCOCODataModule as JaxSBPData
from pytorch_pose_estimation_tpu.data import \
    SBPPISDataModule as JaxPISData
from pytorch_pose_estimation_tpu.data import \
    SPMCOCODataModule as JaxSPMData
from pytorch_pose_estimation_tpu.parallel.mesh import make_mesh
from pytorch_pose_estimation_tpu.train import trainer as jax_trainer
from pytorch_pose_estimation_tpu.train.device_cache import (
    DeviceDataCache as JaxCache, build_device_cache as jax_build)
from pytorch_pose_estimation_tpu_torch.config import get_configs
from pytorch_pose_estimation_tpu_torch.data import (SBPCOCODataModule,
                                                    SBPPISDataModule,
                                                    SPMCOCODataModule)
from pytorch_pose_estimation_tpu_torch.train import (DeviceDataCache,
                                                     build_device_cache)
from pytorch_pose_estimation_tpu_torch.train import trainer as port_trainer

from synth_fixture import COCO_KP_NAMES, make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, OUT, K = (32, 32), (8, 8), 17
KEYS = ("image", "joints", "joints_vis")


def _mesh1():
    return make_mesh(jax.devices()[:1])


def _arrays(n, rng):
    return {"image": rng.randint(0, 256, (n, 4, 3, 3), dtype=np.uint8),
            "joints": rng.uniform(0, 32, (n, 5, 2)).astype(np.float32),
            "joints_vis": (rng.rand(n, 5) > 0.3).astype(np.float32)}


def _assert_batch_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("n,batch,seed,epoch", [
    (16, 4, 0, 0), (17, 4, 3, 1), (10, 10, 7, 5), (64, 16, 11, 2),
    (33, 8, 123456, 9)])
def test_order_and_batches_equal_jax_one_device(n, batch, seed, epoch):
    """epoch_indices, steps_per_epoch, n_total and every gathered batch
    equal JAX's DeviceDataCache on a one-device mesh."""
    arrays = _arrays(n, np.random.RandomState(seed))
    ours = DeviceDataCache(arrays, batch, seed=seed, device="cpu")
    theirs = JaxCache(_mesh1(), arrays, batch, seed=seed)
    assert (ours.n_total, ours.steps_per_epoch) == \
        (theirs.n_total, theirs.steps_per_epoch) == (n, n // batch)
    got, want = ours.epoch_indices(epoch), theirs.epoch_indices(epoch)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert ours.nbytes() == theirs.nbytes()
    batches = list(ours.epoch_batches(epoch))
    assert len(batches) == n // batch
    for b, w in zip(batches, theirs.epoch_batches(epoch)):
        assert all(t.device.type == "cpu" for t in b.values())
        _assert_batch_equal({k: v.numpy() for k, v in b.items()}, w)


def test_cache_errors_match_jax():
    rng = np.random.RandomState(0)
    for arrays, batch in ((_arrays(0, rng), 4), (_arrays(8, rng), 16)):
        with pytest.raises(ValueError) as theirs:
            JaxCache(_mesh1(), arrays, batch)
        with pytest.raises(ValueError) as ours:
            DeviceDataCache(arrays, batch, device="cpu")
        assert str(ours.value) == str(theirs.value)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("devcache"))
    make_dataset(root, "train2017", 12, seed=5)
    make_dataset(root, "val2017", 3, seed=6)
    return root


def _sbp_modules(root):
    ann = os.path.join(root, "annotations", "person_keypoints_train2017.json")
    kw = dict(train_path=ann, val_path=None, img_dir=root, input_size=HW,
              output_size=OUT, num_keypoints=K, sigma=1.0, workers=2,
              batch_size=4, class_labels=COCO_KP_NAMES, seed=0)
    port, theirs = SBPCOCODataModule(**kw), JaxSBPData(**kw)
    port.setup()
    theirs.setup()
    return ann, port, theirs


def _memo_bytes(ann):
    d = ann + ".devcache"
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


def test_disk_memo_interop_both_ways(synth):
    """JAX writes the memo and the port reads it with its decoder broken;
    the port writes it (byte-identical files) and JAX reads it likewise;
    touching the annotation file makes the port decode again."""
    ann, port, theirs = _sbp_modules(synth)
    shutil.rmtree(ann + ".devcache", ignore_errors=True)
    jax_cache = jax_build(theirs, _mesh1(), 4, seed=2)
    jax_memo = _memo_bytes(ann)
    assert sorted(jax_memo) == ["image.npy", "joints.npy", "joints_vis.npy",
                                "meta.json"]

    def check(cache):
        for k in KEYS:
            np.testing.assert_array_equal(
                np.asarray(cache._data[k]), np.asarray(jax_cache._data[k]))

    port._loader = None  # any decode would raise
    check(build_device_cache(port, 4, seed=2, device="cpu"))

    shutil.rmtree(ann + ".devcache")
    port._loader = SBPCOCODataModule._loader.__get__(port)
    check(build_device_cache(port, 4, seed=2, device="cpu"))
    assert _memo_bytes(ann) == jax_memo
    theirs._loader = None
    check(jax_build(theirs, _mesh1(), 4, seed=2))

    with open(ann, "a") as f:  # the memo no longer matches
        f.write(" ")
    port._loader = None
    with pytest.raises(TypeError):
        build_device_cache(port, 4, seed=2, device="cpu")
    port._loader = SBPCOCODataModule._loader.__get__(port)
    again = build_device_cache(port, 4, seed=2, device="cpu")
    assert again.n_total == jax_cache.n_total
    assert _memo_bytes(ann)["image.npy"] == jax_memo["image.npy"]


@pytest.mark.parametrize("use_native", [False, True])
def test_cache_build_leaves_image_caches_alone(synth, use_native):
    """With cache_images on, building the device cache fills no image
    cache, so the val batches stay those of a module without cache_images
    (the JAX package's build fills its val cache with train crops there;
    ROADMAP Queue 3)."""
    ann, _, _ = _sbp_modules(synth)
    kw = dict(train_path=ann, img_dir=synth, input_size=HW, output_size=OUT,
              num_keypoints=K, sigma=1.0, workers=2, batch_size=2,
              class_labels=COCO_KP_NAMES, seed=0, use_native=use_native,
              val_path=ann.replace("train2017", "val2017"))
    cached = SBPCOCODataModule(cache_images=True, **kw)
    plain = SBPCOCODataModule(**kw)
    cached.setup()
    plain.setup()
    assert cached.val_db and cached.train_db[0]["image_path"] != \
        cached.val_db[0]["image_path"]
    build_device_cache(cached, 4, disk_cache=False, device="cpu")
    assert cached._image_cache == {True: {}, False: {}}
    want = list(plain.val_loader())
    for _ in range(2):  # the second pass reads the val cache
        got = list(cached.val_loader())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_batch_equal(g, w)
    assert len(cached._image_cache[False]) == len(cached.val_db)


class _Tiny(nn.Module):
    """A two-conv stand-in for the pose model: 32x32 in, 8x8 maps out."""

    def __init__(self, k=K):
        super().__init__()
        self.net = nn.Sequential(nn.Conv2d(3, 8, 3, 2, 1, bias=False),
                                 nn.BatchNorm2d(8), nn.ReLU(),
                                 nn.Conv2d(8, k, 3, 2, 1, bias=False))

    def forward(self, x):
        return self.net(x)


def _fit_cfg(root, ann, **over):
    cfg = {"model": "simple-baselines-pose", "dataset_name": "devcache",
           "train_path": ann, "val_path": None, "img_dir": root,
           "input_size": list(HW), "output_size": list(OUT),
           "num_keypoints": K, "sigma": 1.0, "conf_threshold": 0.25,
           "workers": 2, "batch_size": 4, "class_labels": COCO_KP_NAMES,
           "epochs": 2, "seed": 2, "precision": "fp32",
           "save_dir": os.path.join(root, "saved"), "cache_device": True,
           "cache_scan": True, "scan_steps_per_dispatch": 1,
           "optimizer": "sgd",
           "optimizer_options": {"lr": 1e-3, "momentum": 0.9,
                                 "weight_decay": 5e-3, "nesterov": True}}
    cfg.update(over)
    return cfg


def _recording(trainer, fed):
    step = trainer.train_step

    def wrapped(batch, *args, **kwargs):
        fed.append({k: v.clone().numpy() for k, v in batch.items()})
        return step(batch, *args, **kwargs)
    trainer.train_step = wrapped


def test_cached_fit_feeds_jax_batches_and_resumes(synth, monkeypatch,
                                                  capsys):
    """Trainer.fit with cache_device feeds, step by step, JAX's
    DeviceDataCache batches of epochs 0 and 1; a resume from 'last' goes on
    with epoch 2's."""
    monkeypatch.setattr(port_trainer, "build_model",
                        lambda cfg, kind: _Tiny())
    ann, port, theirs = _sbp_modules(synth)
    shutil.rmtree(ann + ".devcache", ignore_errors=True)
    jax_cache = jax_build(theirs, _mesh1(), 4, seed=2, disk_cache=False)
    cfg = _fit_cfg(synth, ann)
    fed = []
    tr = port_trainer.Trainer(cfg, port, device="cpu")
    _recording(tr, fed)
    tr.fit()
    out = capsys.readouterr().out
    n = len(port.train_db)
    assert f"device cache: {n} instances" in out and "img/s" in out
    steps = n // 4
    assert tr.state.step == len(fed) == 2 * steps
    want = [b for e in (0, 1) for b in jax_cache.epoch_batches(e)]
    for got, w in zip(fed, want):
        _assert_batch_equal(got, w)

    again = port_trainer.Trainer(dict(cfg, epochs=3), port, device="cpu")
    fed = []
    _recording(again, fed)
    again.fit(resume=os.path.join(tr.version_dir, "checkpoints", "last"))
    assert again.state.step == 3 * steps and len(fed) == steps
    for got, w in zip(fed, jax_cache.epoch_batches(2)):
        _assert_batch_equal(got, w)


# -- where one YAML puts CLAHE in both packages ------------------------------

class _FlaxTiny(fnn.Module):
    k: int = K

    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Conv(self.k, (1, 1), use_bias=False)(x)


def _captured(seen):
    """A make_*_steps that records the augmentation options it is given."""
    def fake(*args, **kwargs):
        seen.append(dict(kwargs.get("augment") or {}))
        return None, None
    return fake


def _modules_for(cfg, kind):
    kw = dict(train_path=None, val_path=None,
              input_size=cfg["input_size"], output_size=cfg["output_size"],
              num_keypoints=cfg["num_keypoints"], sigma=cfg["sigma"],
              workers=0, batch_size=cfg["batch_size"],
              class_labels=cfg["class_labels"])
    if kind == "spm":
        kw.update(img_dir=None, max_persons=cfg.get("max_persons", 30))
        return SPMCOCODataModule(**kw), JaxSPMData(**kw)
    if kind == "pis":
        return SBPPISDataModule(**kw), JaxPISData(**kw)
    return (SBPCOCODataModule(img_dir=None, **kw),
            JaxSBPData(img_dir=None, **kw))


@pytest.mark.parametrize("yaml_name,kind,over", [
    ("sbp_synth_ref.yaml", "sbp", {}),
    ("sbp_pis_synth.yaml", "pis", {}),
    ("spm_synth_ref.yaml", "spm", {}),
    ("sbp_synth_ref.yaml", "sbp", {"clahe": "off"}),
    ("sbp_synth_ref.yaml", "sbp", {"clahe": "device"}),
    ("sbp_coco.yaml", "sbp", {}),
])
def test_cache_device_places_clahe_as_jax(yaml_name, kind, over, tmp_path,
                                          monkeypatch):
    """One YAML (read with the port's get_configs, narrowed) gives the same
    host CLAHE probability on the data module and the same augmentation
    options (CLAHE probability included) in the train step in both
    packages; cache_device moves CLAHE to the device unless clahe is
    off."""
    cfg = dict(get_configs(os.path.join(REPO, "configs", yaml_name)),
               **over)
    if kind == "spm":
        cfg.update(input_size=64, output_size=16)
    else:
        cfg.update(input_size=[64, 48], output_size=[16, 12])
    cfg.update(save_dir=str(tmp_path), devices=1,
               model_pretrained=str(tmp_path / "none"))
    steps = "make_spm_steps" if kind == "spm" else "make_sbp_steps"
    seen = {"port": [], "jax": []}
    monkeypatch.setattr(port_trainer, steps,
                        _captured(seen["port"]))
    monkeypatch.setattr(jax_trainer, steps,
                        _captured(seen["jax"]))
    monkeypatch.setattr(port_trainer, "build_model",
                        lambda c, k: _Tiny(c["num_keypoints"]))
    monkeypatch.setattr(jax_trainer, "build_model",
                        lambda c, k: _FlaxTiny(c["num_keypoints"]))
    port_dm, jax_dm = _modules_for(cfg, kind)
    assert port_dm.clahe_prob == jax_dm.clahe_prob == 0.5
    port_trainer.Trainer(dict(cfg), port_dm, kind=kind, logging=False,
                         device="cpu")
    jax_trainer.Trainer(dict(cfg), jax_dm, kind=kind, logging=False)
    assert port_dm.clahe_prob == jax_dm.clahe_prob
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1
    device_clahe = seen["port"][0].get("clahe_prob", 0.0)
    cached = bool(cfg.get("cache_device"))
    mode = cfg.get("clahe", "device" if cached else "host")
    assert (port_dm.clahe_prob, device_clahe) == {
        "host": (0.5, 0.0), "device": (0.0, 0.5), "off": (0.0, 0.0)}[mode]
