"""configs/spm_synth_hard.yaml in the port, on the CPU: the ``hard`` recipe
of ``tools.spm_ref`` (its corpus: ``make_dataset`` with 5-8 persons an
image, 256 train images with seed 0 and 48 val with seed 1) and the
``hard3`` one beside it (``make_dataset``'s 1-3 persons, the same counts
and seeds, its own root and ``save_dir``), the config copies of the
accuracy arm, the inline ``SPM_SYNTH_HARD`` of chip_smoke.py's phase 15,
and what ``tools/accuracy_on_card.sh`` writes into the configs of its
``spm`` arm (a ``seed`` for each entry of ``SPM_SEEDS``) and of its
``spm_hard`` arm (each corpus of ``HARD_RECIPES``, each seed of
``SPM_SEEDS``), run with a stand-in interpreter that records each
training command's config and runs ``tools.spm_ref config`` for real.
Every comparison is exact.
"""

import json
import os
import subprocess
import sys

import pytest

from pytorch_pose_estimation_tpu import config as jax_config
from pytorch_pose_estimation_tpu_torch import config
from pytorch_pose_estimation_tpu_torch.tools import spm_ref

from synth_fixture import make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "synth_fixture.py")
YAML = os.path.join(REPO, spm_ref.HARD_CONFIG)
REF_YAML = os.path.join(REPO, spm_ref.CONFIG)
SCRIPT = os.path.join(REPO, "pytorch_pose_estimation_tpu_torch", "tools",
                      "accuracy_on_card.sh")
TINY = {"train2017": (3, 0, None), "val2017": (2, 1, None)}


def test_hard_recipe_pins_the_runs_counts_and_seeds():
    """256 train images with seed 0 and 48 val with seed 1 (the fixture
    CLI's seeds, PARITY.md's counts), no instance count to hold, 5-8
    persons an image at make_dataset's defaults otherwise, the YAML's
    corpus root."""
    assert spm_ref.HARD_SPLITS == {"train2017": (256, 0, None),
                                   "val2017": (48, 1, None)}
    assert spm_ref.HARD_CORPUS == {"min_persons": 5, "max_persons": 8}
    assert spm_ref.RECIPES["hard"] == (spm_ref.HARD_CORPUS,
                                       spm_ref.HARD_SPLITS,
                                       "configs/spm_synth_hard.yaml",
                                       "./data/spm_hard")
    assert spm_ref.RECIPES["hard3"] == ({}, spm_ref.HARD_SPLITS,
                                        "configs/spm_synth_hard.yaml",
                                        "./data/spm_hard3")
    assert sorted(spm_ref.RECIPES) == ["hard", "hard3", "ref"]
    assert spm_ref.SPM_SYNTH_HARD["img_dir"] == "./data/spm_hard"


def test_hard3_corpus_is_make_dataset_defaults(tmp_path):
    """At tiny counts, ``--recipe hard3`` writes the annotation files as
    ``make_dataset`` with its defaults (1-3 persons an image) does, with
    the hard recipe's seeds."""
    tiny = dict(spm_ref.RECIPES)
    tiny["hard3"] = (spm_ref.RECIPES["hard3"][0], TINY) + \
        spm_ref.RECIPES["hard3"][2:]
    root = str(tmp_path / "recipe")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spm_ref, "RECIPES", tiny)
        spm_ref.main(["corpus", root, "--recipe", "hard3", "--fixture",
                      FIXTURE])
    for split, (n, seed, _) in TINY.items():
        direct = make_dataset(str(tmp_path / "direct"), split, n, seed=seed)
        path = os.path.join(root, "annotations", os.path.basename(direct))
        with open(path, "rb") as a, open(direct, "rb") as b:
            assert a.read() == b.read()
        with open(path) as f:
            db = json.load(f)
        per_image = [sum(a["image_id"] == im["id"] for a in db["annotations"])
                     for im in db["images"]]
        assert min(per_image) >= 1 and max(per_image) <= 3


def test_hard3_config_copy_reads_its_own_root(tmp_path):
    """``config --recipe hard3``: the hard YAML with ``epochs``, the three
    data paths (``./data/spm_hard3``) and ``save_dir``
    (``./saved/spm_hard3``) changed, every other key as JAX reads the
    YAML."""
    out = str(tmp_path / "hard3.yaml")
    spm_ref.main(["config", out, "--recipe", "hard3", "--epochs", "9",
                  "--src", YAML])
    ours, theirs = config.get_configs(out), jax_config.get_configs(YAML)
    changed = {"epochs": 9, "img_dir": "./data/spm_hard3",
               "train_path": "./data/spm_hard3/annotations/"
                             "person_keypoints_train2017.json",
               "val_path": "./data/spm_hard3/annotations/"
                           "person_keypoints_val2017.json",
               "save_dir": "./saved/spm_hard3"}
    assert {k: ours[k] for k in changed} == changed
    assert {k: v for k, v in ours.items() if k not in changed} == \
        {k: v for k, v in theirs.items() if k not in changed}


@pytest.mark.parametrize("split", sorted(TINY))
def test_hard_corpus_is_make_dataset_with_the_pinned_arguments(
        split, tmp_path, monkeypatch, capsys):
    """At tiny counts, ``tools.spm_ref corpus --recipe hard`` writes the
    annotation file and every image byte for byte as ``make_dataset``
    called with the pinned arguments directly, 5-8 persons an image, and
    prints the image and instance counts it wrote."""
    monkeypatch.setitem(spm_ref.RECIPES, "hard",
                        (spm_ref.RECIPES["hard"][0], TINY) +
                        spm_ref.RECIPES["hard"][2:])
    root = str(tmp_path / "recipe")
    spm_ref.main(["corpus", root, "--recipe", "hard", "--fixture", FIXTURE])
    n, seed, _ = TINY[split]
    lo, hi = 5, 8
    direct = make_dataset(str(tmp_path / "direct"), split, n, seed=seed,
                          min_persons=lo, max_persons=hi)
    path = os.path.join(root, "annotations", os.path.basename(direct))
    with open(path, "rb") as a, open(direct, "rb") as b:
        assert a.read() == b.read()
    with open(path) as f:
        db = json.load(f)
    for im in db["images"]:
        with open(os.path.join(root, split, im["file_name"]), "rb") as a, \
                open(os.path.join(tmp_path, "direct", split,
                                  im["file_name"]), "rb") as b:
            assert a.read() == b.read()
    per_image = [sum(a["image_id"] == im["id"] for a in db["annotations"])
                 for im in db["images"]]
    assert len(per_image) == n and min(per_image) >= lo and \
        max(per_image) <= hi
    assert f"{split}: {n} images, {sum(per_image)} instances: {path}" in \
        capsys.readouterr().out.splitlines()


def test_inline_hard_recipe_is_the_yaml():
    """``SPM_SYNTH_HARD`` (phase 15's config, without PyYAML) equals the
    YAML read by the port's and by the JAX package's ``get_configs``."""
    assert spm_ref.SPM_SYNTH_HARD == config.get_configs(YAML) == \
        jax_config.get_configs(YAML)


@pytest.mark.parametrize("epochs", [250, 2])
def test_hard_config_copy_differs_in_epochs_only(epochs, tmp_path):
    """``tools.spm_ref config OUT --recipe hard --epochs N`` copies the
    YAML with one line changed, ``epochs``; read by the port it equals the
    JAX package's ``get_configs`` of the YAML in every other key."""
    out = str(tmp_path / "hard.yaml")
    spm_ref.main(["config", out, "--recipe", "hard", "--epochs",
                  str(epochs), "--src", YAML])
    ours, theirs = config.get_configs(out), jax_config.get_configs(YAML)
    assert ours["epochs"] == epochs and theirs["epochs"] == 250
    assert {k: v for k, v in ours.items() if k != "epochs"} == \
        {k: v for k, v in theirs.items() if k != "epochs"}
    with open(out) as a, open(YAML) as b:
        diff = [(x, y) for x, y in zip(a, b) if x != y]
    assert diff == ([] if epochs == 250 else
                    [(f"epochs: {epochs}\n", "epochs: 250\n")])


# A stand-in for python3 in the script: it runs `-c` programs and
# `tools.spm_ref config` for real, copies each train_spm config to $REC
# and makes the run's version directory with a `best` sidecar; every other
# command only echoes.
STUB = r"""#!/usr/bin/env bash
case " $* " in
  *" -c "*|*"tools.spm_ref config"*) exec "$REAL_PY" "$@" ;;
  *train_spm*)
    while [ $# -gt 0 ]; do [ "$1" = --cfg ] && cfg=$2; shift; done
    cp "$cfg" "$REC/cfg_$(ls "$REC" | wc -l).yaml"
    save=$(sed -nE "s/^save_dir *: *'?([^' ]*)'?.*/\1/p" "$cfg")
    ds=$(sed -nE "s/^dataset_name *: *'?([^' ]*)'?.*/\1/p" "$cfg")
    d="$save/single-stage-pose-machines_$ds/version_0/checkpoints"
    mkdir -p "$d" && echo '{}' > "$d/best.meta.json"
    echo "device cache: 1 instances, 8 steps/epoch" ;;
  *) echo "stub: $*" ;;
esac
"""


def _run_script(tmp_path, env):
    """The script in a scratch directory (``configs`` linked to the
    repo's) with the stand-in interpreter; returns the recorded configs in
    order."""
    stub = tmp_path / "python_stub"
    stub.write_text(STUB)
    stub.chmod(0o755)
    rec, work = tmp_path / "rec", tmp_path / "work"
    rec.mkdir()
    work.mkdir()
    (work / "configs").symlink_to(os.path.join(REPO, "configs"))
    (tmp_path / "tmp").mkdir()
    run_env = dict(os.environ, PYTHON=str(stub), REAL_PY=sys.executable,
                   REC=str(rec), TMPDIR=str(tmp_path / "tmp"),
                   PYTHONPATH=REPO, **env)
    done = subprocess.run(["bash", SCRIPT, str(tmp_path / "out")],
                          cwd=work, env=run_env, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
    assert done.stdout.splitlines()[-1] == "done"
    return [(rec / f"cfg_{i}.yaml").read_text()
            for i in range(len(os.listdir(rec)))]


def _lines_apart(text, yaml):
    """The lines of ``text`` that the YAML has not, and the YAML's that
    ``text`` has not, in order."""
    with open(yaml) as f:
        src = f.read().splitlines()
    got = text.splitlines()
    return ([ln for ln in got if ln not in src],
            [ln for ln in src if ln not in got])


def test_script_writes_each_spm_seed_into_its_config(tmp_path):
    """``ARMS=spm SPM_SEEDS="3 4"``: one training config a seed, each the
    YAML with ``epochs: $SPM_EPOCHS``, its own ``save_dir`` (so that
    ``--resume auto`` finds only that seed's checkpoints) and ``seed: N``
    appended; nothing else changed."""
    texts = _run_script(tmp_path, {"ARMS": "spm", "SPM_SEEDS": "3 4",
                                   "SPM_EPOCHS": "65"})
    assert len(texts) == 2
    for seed, text in zip((3, 4), texts):
        assert text.endswith(f"\nseed: {seed}\n")
        assert _lines_apart(text, REF_YAML) == (
            ["epochs: 65", f"save_dir : './saved/spm_s{seed}'",
             f"seed: {seed}"],
            ["epochs: 200", "save_dir : './saved'"])


def test_script_hard_arm_config_differs_in_epochs_and_last_only(tmp_path):
    """``ARMS=spm_hard``: one training config, the hard YAML with ``epochs:
    $HARD_EPOCHS`` (250 by default, as the YAML) and
    ``save_last_every_n_epochs: 25`` appended; no ``seed``."""
    texts = _run_script(tmp_path, {"ARMS": "spm_hard", "HARD_EPOCHS": "7"})
    assert len(texts) == 1
    assert _lines_apart(texts[0], YAML) == (
        ["epochs: 7", "save_last_every_n_epochs: 25"], ["epochs: 250"])


def test_script_writes_each_hard_seed_and_corpus_into_its_config(tmp_path):
    """``ARMS=spm_hard SPM_SEEDS="3 4" HARD_RECIPES="hard hard3"``: one
    training config a corpus and seed, each the hard YAML with ``epochs``,
    ``save_last_every_n_epochs: 25``, ``seed: N`` and its own ``save_dir``
    (``./saved/spm_<recipe>_s<N>``); the hard3 copies read
    ``./data/spm_hard3``."""
    texts = _run_script(tmp_path, {"ARMS": "spm_hard", "SPM_SEEDS": "3 4",
                                   "HARD_RECIPES": "hard hard3",
                                   "HARD_EPOCHS": "7"})
    assert len(texts) == 4
    paths = ["train_path", "val_path", "img_dir"]
    src = dict(ln.split(" : ", 1) for ln in open(YAML).read().splitlines()
               if ln.split(" : ", 1)[0] in paths)
    for (recipe, seed), text in zip([("hard", 3), ("hard", 4), ("hard3", 3),
                                     ("hard3", 4)], texts):
        moved = [f"{k} : {src[k].replace('spm_hard', 'spm_hard3')}"
                 for k in paths] if recipe == "hard3" else []
        assert _lines_apart(text, YAML) == (
            ["epochs: 7"] + moved +
            [f"save_dir : './saved/spm_{recipe}_s{seed}'", f"seed: {seed}",
             "save_last_every_n_epochs: 25"],
            ["epochs: 250"] + ([f"{k} : {src[k]}" for k in paths]
                               if moved else []) + ["save_dir : './saved'"])


# --------------------------------------------------------------------------
# phase 15's first steps at full lr, against JAX
# --------------------------------------------------------------------------

def test_phase_15_config_is_the_recipe_cut_to_size(tmp_path):
    """chip_smoke.py's ``hard_config`` (phase 15's corpus and config, and
    tests/spm_hard_witness.py's): 64 train and 16 val images of the hard
    corpus, 5-8 persons an image, and ``SPM_SYNTH_HARD`` with only the
    paths, ``save_dir``, the epochs (2), a validation every epoch and
    yolo_lr's burn-in (1 step of 4, as 300 is of 2,000) changed."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cfg, counts = chip_smoke.hard_config(str(tmp_path))
    assert {s: c[0] for s, c in counts.items()} == \
        {"train2017": 64, "val2017": 16}
    assert all(c[2] >= 5 and c[3] <= 8 for c in counts.values())
    changed = {k for k in cfg if cfg[k] != spm_ref.SPM_SYNTH_HARD.get(k)}
    assert changed == {"train_path", "val_path", "img_dir", "save_dir",
                       "epochs", "trainer_options", "scheduler_options"}
    assert cfg["epochs"] == 2 and cfg["trainer_options"] == \
        {"check_val_every_n_epoch": 1, "num_sanity_val_steps": 0}
    assert cfg["scheduler_options"] == {"burn_in": 1, "steps": [2000],
                                        "scales": [0.1]}


def test_first_full_lr_steps_match_jax_and_raise_val_loss(tmp_path,
                                                          monkeypatch):
    """Phase 15's fit in small: 2 epochs of 2 geometric train steps at
    full lr (yolo_lr with phase 15's burn-in of 1 step, nesterov SGD with
    weight decay) at 256 -> 64 with ``max_persons`` 10, on 8 train images
    of the hard corpus (batch 4, 5-8 persons an image, in order), JAX's
    draws fed in each step, the val loss of 4 val images after each
    epoch; the stand-in model of test_torch_port_spm_ref.py, fp32, no
    CLAHE (its op-by-op JAX run is too slow at 256).

    The port's train and val losses follow JAX's within 5e-5 relative
    (the readings: at most 5.6e-6, at the third step; the first step's
    loss within 2e-6, the 64x64 step's bound) and the val loss rises in
    both (98.42 to 101.78 here), as phase 15's does on the card and the
    JAX package's fit of it on the CPU (tests/spm_hard_witness.py)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from pytorch_pose_estimation_tpu import optim as jax_optim
    from pytorch_pose_estimation_tpu.ops import image as jax_image
    from pytorch_pose_estimation_tpu.train import steps as jax_steps
    from pytorch_pose_estimation_tpu.train.state import create_train_state
    from pytorch_pose_estimation_tpu_torch import optim
    from pytorch_pose_estimation_tpu_torch.data import SPMCOCODataModule
    from pytorch_pose_estimation_tpu_torch.train import (make_spm_eval_step,
                                                         make_spm_steps)
    from test_torch_port_augment import jax_draws
    from test_torch_port_spm_ref import _FlaxTiny, _from_flax, _TorchTiny

    cfg = spm_ref.SPM_SYNTH_HARD
    s, out, k, p = cfg["input_size"], cfg["output_size"], 17, \
        cfg["max_persons"]
    sigma, conf = float(cfg["sigma"]), cfg["conf_threshold"]
    opt_kw = {k_: v for k_, v in cfg["optimizer_options"].items()
              if k_ != "lr"}
    lr = cfg["optimizer_options"]["lr"]
    steps = cfg["scheduler_options"]["steps"]

    def batches(split, n, seed):
        path = make_dataset(str(tmp_path), split, n, seed=seed,
                            **spm_ref.HARD_CORPUS)
        dm = SPMCOCODataModule(path, path, str(tmp_path), s, out, k, sigma,
                               2, 4, spm_ref.COCO_KP_NAMES, max_persons=p,
                               use_native=False, clahe_prob=0.0, seed=0)
        dm.setup()
        return [{key: b[key] for key in ("image", "joints", "centers")}
                for b in dm.val_loader()]

    train, val = batches("train2017", 8, 0), batches("val2017", 4, 1)
    assert [b["joints"].shape for b in train] == [(4, p, k, 2)] * 2

    jax_yolo = jax_optim.yolo_lr(lr, 1, steps, [0.1])
    tx = jax_optim.get_optimizer("sgd", schedule=jax_yolo, **opt_kw)
    model = _FlaxTiny()
    state = create_train_state(model, tx, (1, s, s, 3),
                               rng=jax.random.PRNGKey(3))
    port = _from_flax(_TorchTiny(), jax.tree_util.tree_map(np.array,
                                                           state.params))
    port_yolo = optim.yolo_lr(lr, 1, steps, [0.1])
    opt = optim.get_optimizer("sgd", list(port.parameters()),
                              schedule=port_yolo, **opt_kw)
    step, _ = make_spm_steps(port, opt, s, out, k, sigma, conf,
                             augment={"geometric": True}, max_persons=p)
    port_eval = make_spm_eval_step(port, s, out, k, sigma, conf, p)

    def jax_step(state, batch, key):
        """The JAX step with its augment_batch computed op by op (jitted
        on the CPU, XLA's fused hue op moves pixels)."""
        b = len(batch["image"])
        pts = jnp.concatenate(
            [jnp.asarray(batch["joints"]).reshape(b, p * k, 2),
             jnp.asarray(batch["centers"]).reshape(b, p, 2)], axis=1)
        valid = (~((pts[..., 0] <= 0) & (pts[..., 1] <= 0))
                 ).astype(jnp.float32)
        with jax.disable_jit():
            aug = jax_image.augment_batch(
                key, jnp.asarray(batch["image"]), pts, valid, (s, s), 30.0,
                (0.6, 1.0), (0.75, 1.33), (0.5, 0.2, 0.5, 0.1), 0.0)
        monkeypatch.setattr(jax_steps, "augment_batch", lambda *args: aug)
        run, _ = jax_steps.make_spm_steps(model, tx, s, out, k, sigma,
                                          augment={"geometric": True})
        with jax.default_matmul_precision("highest"):
            return run(state, {key_: jnp.asarray(v)
                               for key_, v in batch.items()}, key)

    _, jax_eval = jax_steps.make_spm_steps(model, None, s, out, k, sigma)
    got, want = {"train": [], "val": []}, {"train": [], "val": []}
    for epoch in range(2):
        port.train()
        for i, batch in enumerate(train):
            key = jax.random.PRNGKey(100 + 2 * epoch + i)
            state, loss = jax_step(state, batch, key)
            want["train"].append(float(loss))
            draws = jax_draws(key, 4, (s, s), rotate_limit=30.0,
                              scale_range=(0.6, 1.0),
                              ratio_range=(0.75, 1.33))
            got["train"].append(float(step(
                {key_: torch.from_numpy(v) for key_, v in batch.items()},
                draws=draws)))
        port.eval()
        with jax.default_matmul_precision("highest"):
            want["val"].append(float(np.mean(np.concatenate(
                [np.asarray(jax_eval(state, {key_: jnp.asarray(v) for
                                             key_, v in b.items()})[0])
                 for b in val]))))
        got["val"].append(float(np.mean(np.concatenate(
            [port_eval({key_: torch.from_numpy(v)
                        for key_, v in b.items()})[0].numpy()
             for b in val]))))
    print(f"port {got}; JAX {want}")
    np.testing.assert_allclose(got["train"][0], want["train"][0], rtol=2e-6)
    for key_ in ("train", "val"):
        np.testing.assert_allclose(got[key_], want[key_], rtol=5e-5)
    assert got["train"][-1] < got["train"][0]
    assert got["val"][-1] > got["val"][0] and want["val"][-1] > want["val"][0]
