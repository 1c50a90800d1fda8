"""The convergence recipe of tests/test_convergence_e2e.py, for the port:
SBP trained from scratch on 16 synthetic images (train and val the same
set) must reach AP@.5 >= 0.55 through the full path (data module, the
device cache, the fused train step, the decode and the OKS metric).

``recipe_cfg`` is configs/sbp_coco.yaml (written here inline, so no
PyYAML is needed) updated with the JAX test's dict; ``run_rounds`` trains
it in rounds of 4 epochs, each with its own augmentation seed, and
validates until the threshold is crossed.  The recipe asks for 2 devices:
as 2 ranks (``parallel.launch``) the cache is the JAX test's 2-device
cache (16 images hold 31 instances, padded to 32: 2 steps an epoch); one
process takes 1 step an epoch.  The recipe sits on the all-background
plateau for thousands of steps in both packages, far past the JAX test's
20 rounds (``chip_smoke.py`` phase 12 says how far).  The tier-1 tests
hold ``SBP_COCO`` and ``recipe_cfg`` to the YAML and to the JAX test's
dict.

From the repo root (the set is written by tests/synth_fixture.py, loaded
by its path; several ranks share the one card over gloo):

    python -m pytorch_pose_estimation_tpu_torch.tools.convergence \
        [--rounds 20] [--ranks 2] [--device cuda]

prints each round and, last, one JSON line: the rounds' AP@.5, the round
that crossed, the train steps and the seconds.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import tempfile
import time

from .. import parallel
from ..data import SBPCOCODataModule
from ..train import Trainer

AP_THRESHOLD = 0.55
EPOCHS_PER_ROUND = 4
MAX_ROUNDS = 20
COCO_KP_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]
# configs/sbp_coco.yaml, every key
SBP_COCO = {
    "model": "simple-baselines-pose", "model_pretrained": "",
    "backbone": "darknet19", "backbone_pretrained": "",
    "dataset_name": "coco-keypoints", "input_size": [256, 192],
    "output_size": [64, 48], "in_channels": 3, "num_keypoints": 17,
    "sigma": 2, "class_labels": COCO_KP_NAMES, "conf_threshold": 0.25,
    "epochs": 365,
    "train_path": "./data/coco_2017/annotations/"
                  "person_keypoints_train2017.json",
    "val_path": "./data/coco_2017/annotations/person_keypoints_val2017.json",
    "img_dir": "./data/coco_2017", "workers": 8, "batch_size": 256,
    "save_dir": "./saved", "save_freq": 5,
    "trainer_options": {"check_val_every_n_epoch": 5,
                        "num_sanity_val_steps": 0},
    "accelerator": "tpu", "devices": "auto", "precision": "bf16",
    "optimizer": "sgd",
    "optimizer_options": {"lr": 1e-3, "momentum": 0.9, "weight_decay": 5e-3,
                          "nesterov": True},
    "scheduler": "yolo_lr",
    "scheduler_options": {"burn_in": 2000, "steps": [105000],
                          "scales": [0.1]},
}


def recipe_cfg(root: str) -> dict:
    """sbp_coco.yaml updated as tests/test_convergence_e2e.py updates it,
    for the set that ``make_dataset(root, "train2017"|"val2017", 16,
    seed=7)`` wrote."""
    cfg = dict(SBP_COCO)
    cfg.update({
        "train_path": os.path.join(
            root, "annotations", "person_keypoints_train2017.json"),
        "val_path": os.path.join(
            root, "annotations", "person_keypoints_val2017.json"),
        "img_dir": root,
        "input_size": [128, 96],
        "output_size": [32, 24],
        "batch_size": 16,
        "workers": 2,
        "epochs": EPOCHS_PER_ROUND,
        "precision": "fp32",
        "devices": 2,
        "cache_device": True,
        "augment_options": {"rotate_limit": 15.0, "rotate_prob": 0.3,
                            "jitter_prob": 0.3,
                            "scale_range": [0.8, 1.0],
                            "ratio_range": [0.9, 1.1]},
        "clahe": "off",
        "trainer_options": {"check_val_every_n_epoch": 10 ** 9},
        "scheduler_options": {"burn_in": 10, "steps": [10 ** 6],
                              "scales": [0.1]},
    })
    return cfg


def run_rounds(cfg: dict, device="cuda", max_rounds: int = MAX_ROUNDS,
               threshold: float = AP_THRESHOLD, val_every: int = 1) -> dict:
    """Train ``cfg`` in rounds of ``cfg['epochs']`` epochs (seed 7 + round)
    and validate after every ``val_every``-th round and the last, until
    the best AP@.5 reaches ``threshold`` or ``max_rounds`` have run.  A
    validation changes nothing in the training, so ``val_every`` only
    delays the stop.  Rank 0 prints each validation.  Returns the
    validated rounds and their APs, the best, the round that crossed
    (None if none did), the train steps, the val batches of one
    validation and the seconds."""
    t0 = time.perf_counter()
    dm = SBPCOCODataModule(
        train_path=cfg["train_path"], val_path=cfg["val_path"],
        img_dir=cfg["img_dir"], input_size=cfg["input_size"],
        output_size=cfg["output_size"], num_keypoints=cfg["num_keypoints"],
        sigma=cfg["sigma"], workers=cfg["workers"],
        batch_size=cfg["batch_size"], class_labels=cfg["class_labels"])
    dm.setup()
    trainer = Trainer(cfg, dm, kind="sbp", logging=False, device=device)
    rounds, aps, best, crossed = [], [], 0.0, None
    for rnd in range(max_rounds):
        # fit() seeds its augmentation stream from cfg['seed']: a new seed
        # a round, so the rounds do not replay the same augmented batches
        trainer.cfg["seed"] = 7 + rnd
        trainer.fit()
        if (rnd + 1) % val_every and rnd + 1 < max_rounds:
            continue
        _, val_map = trainer.validate(verbose=False)
        rounds.append(rnd)
        aps.append(float(val_map))
        best = max(best, float(val_map))
        if parallel.is_main():
            print(f"round {rnd}: val_mAP={val_map:.3f} (best {best:.3f}, "
                  f"step {trainer.global_step})", flush=True)
        if best >= threshold:
            crossed = rnd
            break
    return {"rounds": rounds, "aps": aps, "best": best, "crossed": crossed,
            "steps": trainer.global_step,
            "val_batches": len(dm.val_loader()),
            "seconds": time.perf_counter() - t0}


def make_sets(root: str, fixture: str = "tests/synth_fixture.py") -> None:
    """The recipe's train and val sets: ``make_dataset(root, split, 16,
    seed=7)`` of the repo's synthetic fixture (it needs cv2), loaded by its
    path."""
    spec = importlib.util.spec_from_file_location("synth_fixture", fixture)
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    for split in ("train2017", "val2017"):
        synth.make_dataset(root, split, 16, seed=7)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=MAX_ROUNDS)
    parser.add_argument("--ranks", type=int, default=2,
                        help="processes, all on --device (gloo)")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    device = "cuda:0" if args.device == "cuda" else args.device
    with tempfile.TemporaryDirectory() as root:
        make_sets(root)
        cfg = recipe_cfg(root)
        cwd = os.getcwd()
        os.chdir(root)  # the metric writes results.json to the cwd
        try:
            result = parallel.launch(run_rounds, [device] * args.ranks,
                                     "gloo" if args.ranks > 1 else None,
                                     args=(cfg, args.device, args.rounds))[0]
        finally:
            os.chdir(cwd)
    result["ranks"] = args.ranks
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
