"""The port's inference modules and ``vis`` on the CPU: the drawings are
byte-equal to the JAX package's ``vis.py``; ``inference_sbp`` and
``inference_spm`` run with ``device="cpu"`` on synthetic COCO data and
write their images; the ground-truth images of ``inference_sbp`` (which do
not depend on the weights) are byte-equal to the root ``inference_sbp.py``
CLI's."""

import os

import numpy as np
import pytest

import inference_sbp as jax_inference_sbp
from pytorch_pose_estimation_tpu import vis as jax_vis
from pytorch_pose_estimation_tpu_torch import (inference_sbp, inference_spm,
                                               vis)

from synth_fixture import COCO_KP_NAMES, make_dataset


def _joints(rng, n, k):
    j = np.concatenate([rng.uniform(-5, 70, (n, k, 2)),
                        rng.uniform(0, 1, (n, k, 1))], -1)
    j[:, ::4, 2] = -1  # missing
    j[:, 1::5, :2] = 0  # (0, 0): skipped by the SPM drawing
    return j.astype(np.float32)


@pytest.mark.parametrize("name", ["get_coco_tagged_img_sbp",
                                  "get_pis_tagged_img_sbp",
                                  "get_tagged_img_spm"])
def test_vis_draws_what_jax_vis_draws(name):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (64, 48, 3), dtype=np.uint8)
    if name == "get_tagged_img_spm":
        kps = _joints(rng, 3, 17)
        args = (img, kps[:, 0, :2] + 1, kps[..., :2])
    else:
        args = (img, _joints(rng, 1, 17 if "coco" in name else 11)[0])
    got = getattr(vis, name)(*args)
    want = getattr(jax_vis, name)(*args)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()  # it drew something
    assert (args[0] == img).all()  # on a copy


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    make_dataset(root, "val2017", 2, seed=4, img_size=(256, 256))
    return root


def _cfg(root, **over):
    cfg = {"train_path": None,
           "val_path": os.path.join(root, "annotations",
                                    "person_keypoints_val2017.json"),
           "img_dir": root, "num_keypoints": 17, "workers": 0,
           "class_labels": COCO_KP_NAMES, "precision": "fp32", "seed": 0}
    cfg.update(over)
    return cfg


def test_inference_sbp_writes_images_and_true_ones_equal_jax(synth,
                                                             tmp_path,
                                                             capsys):
    cfg = _cfg(synth, input_size=[64, 48], output_size=[16, 12], sigma=2,
               conf_threshold=0.25, optimizer="sgd")
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    inference_sbp.inference(cfg, None, str(ours), limit=2, device="cpu")
    assert capsys.readouterr().out.count("Inference: ") == 2
    jax_inference_sbp.inference(dict(cfg), None, str(theirs), limit=2)
    names = ["000000_pred.jpg", "000000_true.jpg", "000001_pred.jpg",
             "000001_true.jpg"]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == names
    for name in names[1::2]:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()


def test_inference_spm_writes_images(synth, tmp_path, capsys):
    cfg = _cfg(synth, input_size=64, output_size=16, sigma=1,
               conf_threshold=0.5, max_persons=4)
    out = tmp_path / "spm"
    inference_spm.inference(cfg, None, str(out), limit=2, device="cpu")
    assert capsys.readouterr().out.count("Inference: ") == 2
    assert sorted(os.listdir(out)) == ["000000_pred.jpg", "000001_pred.jpg"]
    assert all((out / n).stat().st_size > 0 for n in os.listdir(out))
