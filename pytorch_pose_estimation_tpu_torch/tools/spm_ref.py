"""SPM on the synthetic corpora: the corpora of configs/spm_synth_ref.yaml
(``ref``) and configs/spm_synth_hard.yaml (``hard``, and ``hard3`` beside
it), rebuilt from the repo's synthetic fixture, and each config's copy for
a run of another length.  From the repo root:

    python -m pytorch_pose_estimation_tpu_torch.tools.spm_ref corpus \\
        [ROOT] [--recipe ref|hard|hard3] [--fixture tests/synth_fixture.py]
    python -m pytorch_pose_estimation_tpu_torch.tools.spm_ref config OUT \\
        [--recipe ref|hard|hard3] [--epochs 90] [--src YAML]

``corpus`` writes the JPEG images and their annotation files under ROOT
(the recipe's ``./data/spm_ref``, ``./data/spm_hard`` or
``./data/spm_hard3`` by default), prints the image and instance counts it
wrote, and fails on an image count, or on an instance count where the
recipe has one, that is not the recipe's.  ``config`` copies the YAML with
its ``epochs`` line replaced and nothing else changed, but for a recipe
whose root is not the YAML's ``img_dir`` (``hard3``): its copy reads the
corpus from that root and saves under ``./saved/<root's name>``.

* ``ref``: 640x512 hard multi-person scenes (3-8 overlapping persons, 8
  distractor shapes, torso occlusion at p 0.3, 36-300 px scale jitter),
  5,000 train and 500 val images with the counts behind the JAX
  package's run (``PARITY.md``: 500 val images, 2,774 instances).
  ``SPM_SYNTH_REF`` holds the YAML's values inline, for callers without
  PyYAML.
* ``hard``: ``make_dataset``'s defaults (400x320, no clutter, occlusion
  or scale jitter) with ``min_persons=5, max_persons=8``, the YAML
  header's 5-8 persons an image; 256 train images with seed 0 and 48 val
  with seed 1.  The seeds are the fixture CLI's, the counts
  ``PARITY.md``'s.  JAX recorded no
  instance counts, so the image counts are the only gate.  At batch 32
  an epoch is 8 steps, so the YAML's 250 epochs are the 2,000 steps that
  ``yolo_lr``'s ``steps: [2000]`` assumes (``burn_in`` 300: 37.5
  epochs).  The header's "2.5k-step run" does not fit 256 train images:
  250 epochs of them are 2,000 steps.  ``SPM_SYNTH_HARD`` holds the
  YAML's values inline.
* ``hard3``: the 1-3-person corpus (``make_dataset``'s defaults, PARITY.md's
  "3-person" reading of the JAX run), with ``hard``'s counts and seeds and
  configs/spm_synth_hard.yaml otherwise, under ``./data/spm_hard3``.
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
# the hard recipe: no instance count to hold (None)
HARD_CORPUS = dict(min_persons=5, max_persons=8)
HARD_SPLITS = {"train2017": (256, 0, None), "val2017": (48, 1, None)}
HARD_CONFIG = "configs/spm_synth_hard.yaml"
# recipe -> (make_dataset's arguments, splits, YAML, default root)
RECIPES = {"ref": (CORPUS, SPLITS, CONFIG, "./data/spm_ref"),
           "hard": (HARD_CORPUS, HARD_SPLITS, HARD_CONFIG, "./data/spm_hard"),
           "hard3": ({}, HARD_SPLITS, HARD_CONFIG, "./data/spm_hard3")}
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
# configs/spm_synth_hard.yaml, every key
SPM_SYNTH_HARD = {
    **{k: v for k, v in SPM_SYNTH_REF.items()
       if k not in ("cache_device", "scan_steps_per_dispatch")},
    "dataset_name": "spm-synth-hard", "input_size": 256, "output_size": 64,
    "epochs": 250,
    "train_path": "./data/spm_hard/annotations/person_keypoints_train2017.json",
    "val_path": "./data/spm_hard/annotations/person_keypoints_val2017.json",
    "img_dir": "./data/spm_hard",
    "scheduler_options": {"burn_in": 300, "steps": [2000], "scales": [0.1]},
    "cache_images": True,
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
                splits=("train2017", "val2017"), recipe: str = "ref") -> dict:
    """Write ``splits`` of ``recipe``'s corpus under ``root``; returns split
    -> (annotation path, images, instances).  Raises if a count is not the
    recipe's."""
    make_dataset = load_fixture(fixture).make_dataset
    corpus, recipe_splits = RECIPES[recipe][:2]
    out = {}
    for split in splits:
        n, seed, want = recipe_splits[split]
        path = make_dataset(root, split, n, seed=seed, **corpus)
        with open(path) as f:
            db = json.load(f)
        got = (len(db["images"]), len(db["annotations"]))
        if got[0] != n or want not in (None, got[1]):
            raise RuntimeError(f"{split}: {got[0]} images and {got[1]} "
                               f"instances, the recipe's are {n} and {want}")
        out[split] = (path, *got)
    return out


def write_config(out: str, epochs: int, src: str = CONFIG,
                 root: str | None = None) -> str:
    """Copy ``src`` to ``out`` with ``epochs: <epochs>``; every other line
    stays as it is, but where ``root`` is given and is not the YAML's
    ``img_dir``: then the data paths read ``root`` and ``save_dir`` is
    ``./saved/<root's name>``."""
    with open(src) as f:
        text = f.read()
    text, n = re.subn(r"(?m)^epochs:[ \t]*\d+[ \t]*$", f"epochs: {int(epochs)}",
                      text)
    if n != 1:
        raise ValueError(f"{src}: {n} 'epochs:' lines, expected 1")
    img_dir = re.search(r"(?m)^img_dir *: *'([^']*)'", text).group(1)
    if root is not None and root != img_dir:
        text = re.sub(r"(?<=')" + re.escape(img_dir) + r"(?=[/'])", root,
                      text)
        text = re.sub(r"(?m)^save_dir *:.*$",
                      f"save_dir : './saved/{os.path.basename(root)}'", text)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write(text)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command", required=True)
    corpus = sub.add_parser("corpus")
    corpus.add_argument("root", nargs="?")
    corpus.add_argument("--fixture", default="tests/synth_fixture.py")
    config = sub.add_parser("config")
    config.add_argument("out")
    config.add_argument("--epochs", type=int, default=90)
    config.add_argument("--src")
    for command in (corpus, config):
        command.add_argument("--recipe", choices=sorted(RECIPES),
                             default="ref")
    args = parser.parse_args(argv)
    _, _, yaml_path, root = RECIPES[args.recipe]
    if args.command == "corpus":
        for split, (path, n, inst) in make_corpus(
                args.root or root, args.fixture,
                recipe=args.recipe).items():
            print(f"{split}: {n} images, {inst} instances: {path}")
    else:
        print(write_config(args.out, args.epochs, args.src or yaml_path,
                           root))


if __name__ == "__main__":
    main()
