"""SPM at reference scale: configs/spm_synth_ref.yaml's corpus, rebuilt from
the repo's synthetic fixture, and the config's copy for a run of fewer
epochs.  From the repo root:

    python -m pytorch_pose_estimation_tpu_torch.tools.spm_ref corpus \\
        [ROOT=./data/spm_ref] [--fixture tests/synth_fixture.py]
    python -m pytorch_pose_estimation_tpu_torch.tools.spm_ref config OUT \\
        [--epochs 90] [--src configs/spm_synth_ref.yaml]

``corpus`` writes the 640x512 JPEG images and their annotation files
(hard multi-person scenes: 3-8 overlapping persons, 8 distractor shapes,
torso occlusion at p 0.3, 36-300 px scale jitter) and fails unless the
counts are the ones behind the JAX package's run (``PARITY.md``: 500 val
images, 2,774 instances).  ``config`` copies the YAML with its ``epochs``
line replaced and nothing else changed.  ``SPM_SYNTH_REF`` holds the
YAML's values inline, for callers without PyYAML.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re

# make_dataset's arguments beside the split, the image count and the seed
CORPUS = dict(img_size=(512, 640), min_persons=3, max_persons=8, clutter=8,
              occlude_prob=0.3, scale_jitter=True)
# split -> (images, seed, instances); the val counts are PARITY.md's, the
# train seed follows the fixture's CLI (train 0, val 1)
SPLITS = {"train2017": (5000, 0, 27656), "val2017": (500, 1, 2774)}
CONFIG = "configs/spm_synth_ref.yaml"
COCO_KP_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]
# configs/spm_synth_ref.yaml, every key
SPM_SYNTH_REF = {
    "model": "single-stage-pose-machines", "model_pretrained": "",
    "backbone": "darknet19", "backbone_pretrained": "",
    "dataset_name": "spm-synth-ref", "input_size": 512, "output_size": 128,
    "in_channels": 3, "num_keypoints": 17, "sigma": 1,
    "class_labels": COCO_KP_NAMES, "conf_threshold": 0.5, "max_persons": 10,
    "epochs": 200,
    "train_path": "./data/spm_ref/annotations/person_keypoints_train2017.json",
    "val_path": "./data/spm_ref/annotations/person_keypoints_val2017.json",
    "img_dir": "./data/spm_ref", "workers": 8, "batch_size": 32,
    "save_dir": "./saved", "save_freq": 5,
    "trainer_options": {"check_val_every_n_epoch": 5,
                        "num_sanity_val_steps": 0},
    "accelerator": "tpu", "devices": "auto", "precision": "bf16",
    "optimizer": "sgd",
    "optimizer_options": {"lr": 1e-3, "momentum": 0.9, "weight_decay": 5e-3,
                          "nesterov": True},
    "scheduler": "yolo_lr",
    "scheduler_options": {"burn_in": 156, "steps": [20000], "scales": [0.1]},
    "augment_geometric": True, "cache_device": True,
    "scan_steps_per_dispatch": 24,
}


def load_fixture(path: str = "tests/synth_fixture.py"):
    """The repo's synthetic fixture (it imports cv2), loaded by its path:
    ``import tests.synth_fixture`` can find another package named
    ``tests``."""
    spec = importlib.util.spec_from_file_location("synth_fixture", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_corpus(root: str, fixture: str = "tests/synth_fixture.py",
                splits=tuple(SPLITS)) -> dict:
    """Write ``splits`` of the corpus under ``root``; returns split ->
    (annotation path, images, instances).  Raises if a count is not the
    recipe's."""
    make_dataset = load_fixture(fixture).make_dataset
    out = {}
    for split in splits:
        n, seed, want = SPLITS[split]
        path = make_dataset(root, split, n, seed=seed, **CORPUS)
        with open(path) as f:
            db = json.load(f)
        got = (len(db["images"]), len(db["annotations"]))
        if got != (n, want):
            raise RuntimeError(f"{split}: {got[0]} images and {got[1]} "
                               f"instances, the recipe's are {n} and {want}")
        out[split] = (path, *got)
    return out


def write_config(out: str, epochs: int, src: str = CONFIG) -> str:
    """Copy ``src`` to ``out`` with ``epochs: <epochs>``; every other line
    stays as it is."""
    with open(src) as f:
        text = f.read()
    text, n = re.subn(r"(?m)^epochs:[ \t]*\d+[ \t]*$", f"epochs: {int(epochs)}",
                      text)
    if n != 1:
        raise ValueError(f"{src}: {n} 'epochs:' lines, expected 1")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write(text)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command", required=True)
    corpus = sub.add_parser("corpus")
    corpus.add_argument("root", nargs="?", default="./data/spm_ref")
    corpus.add_argument("--fixture", default="tests/synth_fixture.py")
    config = sub.add_parser("config")
    config.add_argument("out")
    config.add_argument("--epochs", type=int, default=90)
    config.add_argument("--src", default=CONFIG)
    args = parser.parse_args(argv)
    if args.command == "corpus":
        for split, (path, n, inst) in make_corpus(args.root,
                                                  args.fixture).items():
            print(f"{split}: {n} images, {inst} instances: {path}")
    else:
        print(write_config(args.out, args.epochs, args.src))


if __name__ == "__main__":
    main()
