"""The port stands alone: importing any of its modules (and chip_smoke.py)
loads no jax and nothing of the JAX package, and needs neither cv2, PyYAML
nor tensorboardX; its entry points (the Trainer, ``load_for_inference``,
the train and inference modules, the PIS harnesses and
``train_classifier`` among them) default to the GPU and raise without
one; the kernel module imports without nvcc and fails clearly when asked
to build without it; importing the native loader's binding builds
nothing."""

import os
import subprocess
import sys

import pytest
import torch

from pytorch_pose_estimation_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "cv2", "yaml", "tensorboardX"):
    sys.modules[name] = None  # any import of them raises ImportError
import pytorch_pose_estimation_tpu_torch as port
names = [m.name for m in
         pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    __import__(name)
import chip_smoke
roots = ("jax", "jaxlib", "flax", "optax", "pytorch_pose_estimation_tpu")
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m in roots or m.startswith(tuple(r + "." for r in roots))))
print(" ".join(names))
print(bad)
from pytorch_pose_estimation_tpu_torch.data import native_loader
print(native_loader._tried)  # importing tried no build
"""
# modules added with the device cache and the native loader, with data
# parallelism, and with the accuracy path's tools
NEW_MODULES = ("data.native_loader", "train.device_cache",
               "test_coco_keypoints_map", "models.hourglass", "parallel",
               "parallel.mesh", "tools", "tools.ab_angle_groups",
               "tools.tb_trajectory", "tools.convergence")


def test_port_imports_without_jax_cv2_yaml_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names, bad, tried = out.stdout.splitlines()
    names = names.split()
    assert len(names) >= 20  # every module of the package was imported
    for name in NEW_MODULES:
        assert f"pytorch_pose_estimation_tpu_torch.{name}" in names, name
    assert bad.strip() == "[]"
    assert tried == "False"


def _in_a_process_group() -> bool:
    return torch.distributed.is_initialized()


def test_launch_with_one_device_starts_no_process_group():
    """One device: ``fn`` runs in this process, with no group, and the
    helpers are the identity."""
    from pytorch_pose_estimation_tpu_torch import parallel

    assert parallel.launch(_in_a_process_group, ["cpu"]) == [False]
    assert not torch.distributed.is_initialized()
    assert (parallel.rank(), parallel.world_size()) == (0, 1)
    x = torch.arange(6.0).reshape(3, 2)
    assert parallel.local_rows(x) is x and parallel.gather_rows(x) is x


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pytorch_pose_estimation_tpu_torch.train import (load_sbp_predictor,
                                                         validate)
    cfg = {"num_keypoints": 17, "input_size": [256, 192],
           "conf_threshold": 0.25}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_sbp_predictor(cfg, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validate(cfg, None, None)


def test_trainer_and_train_sbp_default_to_cuda_and_raise_without_it(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pytorch_pose_estimation_tpu_torch import train_sbp
    from pytorch_pose_estimation_tpu_torch.train import Trainer
    cfg = {"model": "simple-baselines-pose", "dataset_name": "coco",
           "train_path": str(tmp_path / "none.json"),
           "val_path": str(tmp_path / "none.json"), "img_dir": str(tmp_path),
           "input_size": [64, 48], "output_size": [16, 12],
           "num_keypoints": 17, "sigma": 2, "conf_threshold": 0.25,
           "workers": 0, "batch_size": 2, "class_labels": [], "epochs": 1,
           "save_dir": str(tmp_path / "saved"), "optimizer": "sgd"}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_sbp.train(cfg)
    assert not (tmp_path / "saved").exists()  # nothing written first


def test_spm_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pytorch_pose_estimation_tpu_torch import inference_spm, train_spm
    from pytorch_pose_estimation_tpu_torch.train import (Trainer,
                                                         load_for_inference)
    cfg = {"model": "single-stage-pose-machines", "dataset_name": "coco",
           "train_path": str(tmp_path / "none.json"),
           "val_path": str(tmp_path / "none.json"), "img_dir": str(tmp_path),
           "input_size": 64, "output_size": 16, "num_keypoints": 17,
           "sigma": 1, "conf_threshold": 0.5, "workers": 0, "batch_size": 2,
           "class_labels": [], "epochs": 1, "optimizer": "sgd",
           "save_dir": str(tmp_path / "saved")}
    calls = [lambda: Trainer(cfg, None, kind="spm"),
             lambda: load_for_inference(cfg, None, "spm"),
             lambda: train_spm.train(cfg),
             lambda: inference_spm.inference(cfg, None,
                                             str(tmp_path / "out"))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "saved").exists()  # nothing written first
    assert not (tmp_path / "out").exists()


def test_pis_and_classifier_entry_points_default_to_cuda_and_raise(
        tmp_path):
    """``Trainer(kind="pis")``, ``train_sbp_pis``, ``inference_sbp_pis``,
    both behaviour harnesses and ``train_classifier``: each raises before
    it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pytorch_pose_estimation_tpu_torch import (inference_sbp_pis,
                                                   pis_falling_down_test_code,
                                                   pis_handle_test_code,
                                                   train_classifier,
                                                   train_sbp_pis)
    from pytorch_pose_estimation_tpu_torch.train import Trainer
    none = str(tmp_path / "none.json")
    cfg = {"model": "simple-baselines-pose", "dataset_name": "pis",
           "train_path": none, "val_path": none, "input_size": [64, 48],
           "output_size": [16, 12], "num_keypoints": 11, "sigma": 2,
           "conf_threshold": 0.25, "workers": 0, "batch_size": 2,
           "class_labels": [], "epochs": 1, "optimizer": "sgd",
           "save_dir": str(tmp_path / "saved")}
    cls_cfg = {"model": "darknet19", "dataset_name": "tiny-imagenet",
               "input_size": 64, "train_dir": str(tmp_path),
               "val_dir": str(tmp_path), "workers": 0, "batch_size": 2,
               "epochs": 1, "optimizer": "sgd",
               "save_dir": str(tmp_path / "saved")}
    calls = [lambda: Trainer(cfg, None, kind="pis"),
             lambda: train_sbp_pis.train(cfg),
             lambda: inference_sbp_pis.inference(cfg, None, "handle_grip",
                                                 str(tmp_path / "out")),
             lambda: pis_handle_test_code.run(cfg, None),
             lambda: pis_falling_down_test_code.run(cfg, None),
             lambda: train_classifier.train(cls_cfg)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "saved").exists()  # nothing written first
    assert not (tmp_path / "out").exists()


def test_kernel_wrappers_take_only_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.sbp_heatmaps_cuda(torch.zeros(1, 17, 2), (64, 48), 2.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.decode_sbp_cuda(torch.zeros(1, 17, 64, 48), 192, 0.25)
    assert kernels.sbp_heatmaps_cuda.launches == 0
    assert kernels.decode_sbp_cuda.launches == 0


def test_kernel_build_without_nvcc_raises_clearly(monkeypatch):
    monkeypatch.setattr(kernels, "_nvcc_candidates", lambda: [])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
