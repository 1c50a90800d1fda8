"""The port's native loader (its own g++ build of native/loader.cc, under
build/native/) against the JAX package's binding of ``make -C native``'s
library, on the CPU: the same blobs and boxes give identical bytes, and the
SBP, PIS and SPM data modules with ``use_native=True`` give JAX's batches
exactly, host CLAHE included.  ``use_native=None`` picks what JAX picks.

Tolerance: none; every comparison is exact.
"""

import cv2
import numpy as np
import pytest

from pytorch_pose_estimation_tpu.data import \
    SBPCOCODataModule as JaxSBPData
from pytorch_pose_estimation_tpu.data import \
    SBPPISDataModule as JaxPISData
from pytorch_pose_estimation_tpu.data import \
    SPMCOCODataModule as JaxSPMData
from pytorch_pose_estimation_tpu.data import native_loader as jax_native
from pytorch_pose_estimation_tpu_torch.data import (SBPCOCODataModule,
                                                    SBPPISDataModule,
                                                    SPMCOCODataModule,
                                                    native_loader)

from synth_fixture import COCO_KP_NAMES, make_dataset, make_pis_dataset


def test_library_is_built_under_build_native():
    """Built by g++ at first use under build/native/<hash>/, never loaded
    from native/ (whose library the JAX package loads)."""
    assert native_loader.available(), native_loader.build_error()
    assert native_loader.build_error() is None
    so = native_loader._BUILD_ROOT / native_loader._source_hash() / \
        "libppe_loader.so"
    assert so.is_file()
    assert so.parent.parent == \
        native_loader._REPO / "build" / "native"
    assert native_loader._lib._name == str(so)


def _jpegs(n, seed):
    rng = np.random.RandomState(seed)
    blobs, boxes = [], []
    for _ in range(n):
        h, w = rng.randint(60, 200), rng.randint(60, 200)
        img = cv2.GaussianBlur(rng.randint(0, 255, (h, w, 3), np.uint8),
                               (5, 5), 2)
        blobs.append(cv2.imencode(".jpg", img)[1].tobytes())
        x1, y1 = rng.randint(0, w // 2), rng.randint(0, h // 2)
        boxes.append((x1, y1, rng.randint(5, w - x1), rng.randint(5, h - y1)))
    return blobs, boxes


def test_binding_bytes_equal_jax():
    """decode_jpeg, batch crops (boxes past the image edge included), whole
    images, and the error on a corrupt blob."""
    blobs, boxes = _jpegs(6, 0)
    boxes[0] = (150, 150, 500, 500)  # clamped into the image by the core
    for args in ((blobs, boxes, 48, 32, 3),
                 (blobs, [(-1, -1, -1, -1)] * 6, 40, 56, 1)):
        got = native_loader.batch_decode_crop_resize(*args)
        want = jax_native.batch_decode_crop_resize(*args)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    for blob in blobs[:2]:
        got = native_loader.decode_jpeg(blob)
        assert got.tobytes() == jax_native.decode_jpeg(blob).tobytes()
    with pytest.raises(RuntimeError, match="1/1 samples failed"):
        native_loader.batch_decode_crop_resize([b"not a jpeg"], [(0, 0, 9, 9)],
                                               8, 8)
    with pytest.raises(RuntimeError, match="JPEG decode failed"):
        native_loader.decode_jpeg(b"not a jpeg")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native"))
    ann = {"train": make_dataset(root, "train2017", 6, seed=7),
           "val": make_dataset(root, "val2017", 3, seed=8)}
    pis = str(tmp_path_factory.mktemp("native_pis"))
    ann_pis = {"train": make_pis_dataset(pis, "train", 6, seed=9),
               "val": make_pis_dataset(pis, "val", 3, seed=10)}
    return root, ann, ann_pis


def _modules(data, kind, use_native):
    root, ann, ann_pis = data
    kw = dict(num_keypoints=17, sigma=2.0, workers=2, batch_size=2,
              class_labels=COCO_KP_NAMES, use_native=use_native,
              clahe_prob=0.5, seed=4)
    if kind == "spm":
        kw.update(train_path=ann["train"], val_path=ann["val"], img_dir=root,
                  input_size=64, output_size=16, max_persons=4)
        classes = SPMCOCODataModule, JaxSPMData
    elif kind == "pis":
        kw.update(train_path=ann_pis["train"], val_path=ann_pis["val"],
                  input_size=[64, 48], output_size=[16, 12], num_keypoints=11,
                  class_labels=COCO_KP_NAMES[:11])
        classes = SBPPISDataModule, JaxPISData
    else:
        kw.update(train_path=ann["train"], val_path=ann["val"], img_dir=root,
                  input_size=[64, 48], output_size=[16, 12])
        classes = SBPCOCODataModule, JaxSBPData
    port, theirs = (cls(**kw) for cls in classes)
    port.setup()
    theirs.setup()
    return port, theirs


@pytest.mark.parametrize("kind", ["sbp", "pis", "spm"])
def test_native_data_module_equals_jax(data, kind):
    """use_native=True in both packages: train batches (shuffled, host
    CLAHE at p=0.5) of two epochs and the val batches are equal, key by key
    and dtype by dtype; the port's default (None) takes the same path."""
    port, theirs = _modules(data, kind, True)
    assert port.use_native and theirs.use_native
    assert _modules(data, kind, None)[0].use_native == \
        _modules(data, kind, None)[1].use_native is True
    pairs = []
    for epoch in (0, 1):
        a, b = port.train_loader(), theirs.train_loader()
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        pairs += zip(list(a), list(b))
    pairs += zip(list(port.val_loader()), list(theirs.val_loader()))
    assert len(pairs) >= 4
    for x, y in pairs:
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    # the host CLAHE ran: without it, some train image of epoch 0 differs
    plain = _modules(data, kind, True)[0]
    plain.clahe_prob = 0.0
    with_clahe = np.concatenate([x["image"] for x, _ in pairs[:len(
        port.train_loader())]])
    without = np.concatenate([x["image"] for x in plain.train_loader()])
    assert not np.array_equal(with_clahe, without)


def test_use_native_default_and_errors(data, monkeypatch):
    """None picks the native loader when it is built and cv2 when not;
    True without the library raises with the build's error at the first
    loader; False is cv2.  Building a data module tries no build."""
    port = _modules(data, "sbp", False)[0]
    assert not port.use_native
    assert port.train_loader().sample_fn is not None
    builds = []

    def failed_build():
        builds.append(1)
        native_loader._error = "g++: no libjpeg"
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", None)
    monkeypatch.setattr(native_loader, "_load", failed_build)
    monkeypatch.setattr(jax_native, "_lib", None)
    port, theirs = _modules(data, "spm", None)
    pis = _modules(data, "pis", True)[0]
    assert not builds
    assert port.use_native is theirs.use_native is False
    assert builds
    assert port.train_loader().sample_fn is not None
    with pytest.raises(RuntimeError, match="g\\+\\+: no libjpeg"):
        pis.train_loader()
