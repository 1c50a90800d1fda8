"""The port's accuracy tools on the CPU: ``tools.ab_angle_groups`` builds
the JAX tool's config and runs end to end; ``tools.tb_trajectory`` prints
the JAX tool's table from the same event files; ``tools.convergence``
holds tests/test_convergence_e2e.py's recipe, and (marked slow) trains it
on 2 gloo ranks to the JAX test's AP threshold.  Also what the accuracy
runs on the card met: the surgery into a new directory, the long
schedule, and the falling-down harness's ceiling on its fixture."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch
import yaml

from pytorch_pose_estimation_tpu.config import get_configs
from pytorch_pose_estimation_tpu_torch import parallel
from pytorch_pose_estimation_tpu_torch.tools import (ab_angle_groups,
                                                     convergence,
                                                     tb_trajectory)

from synth_fixture import COCO_KP_NAMES, make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "ab_angle_groups.py")
JAX_TB = os.path.join(REPO, "tools", "tb_trajectory.py")
JAX_TEST = os.path.join(REPO, "tests", "test_convergence_e2e.py")


def _update_dict(path, names):
    """The dict literal that ``path`` passes to ``cfg.update``, evaluated
    with ``names`` bound."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == "update" and \
                isinstance(node.args[0], ast.Dict):
            return eval(compile(ast.Expression(node.args[0]), path, "eval"),
                        dict(names))
    raise AssertionError(f"no cfg.update({{...}}) in {path}")


def _module_constants(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return {t.id: ast.literal_eval(n.value) for n in tree.body
            if isinstance(n, ast.Assign) for t in n.targets
            if isinstance(t, ast.Name) and isinstance(n.value, ast.Constant)}


@pytest.mark.parametrize("G", [16, 256])
def test_make_cfg_is_the_jax_tools_config(G):
    want = get_configs(os.path.join(REPO, "configs", "sbp_synth_ref.yaml"))
    want.update(_update_dict(JAX_TOOL, {"G": G, "EPOCHS": 60}))
    cwd = os.getcwd()
    os.chdir(REPO)  # the tool reads the config relative to the repo root
    try:
        got = ab_angle_groups.make_cfg(G)
        assert ab_angle_groups.make_cfg(G, 7)["epochs"] == 7
    finally:
        os.chdir(cwd)
    assert got == want
    # a whole key is replaced, as dict.update does in the JAX tool
    assert got["trainer_options"] == {"check_val_every_n_epoch": 10}
    assert got["augment_options"] == {"angle_groups": G}


def test_recipe_cfg_is_the_jax_convergence_tests_config(tmp_path):
    assert convergence.SBP_COCO == get_configs(
        os.path.join(REPO, "configs", "sbp_coco.yaml"))
    assert convergence.COCO_KP_NAMES == COCO_KP_NAMES
    root = str(tmp_path)
    want = get_configs(os.path.join(REPO, "configs", "sbp_coco.yaml"))
    want.update(_update_dict(JAX_TEST, {
        "os": os, "synth_root": root,
        "EPOCHS_PER_ROUND": convergence.EPOCHS_PER_ROUND}))
    assert convergence.recipe_cfg(root) == want
    consts = _module_constants(JAX_TEST)
    assert (convergence.AP_THRESHOLD, convergence.EPOCHS_PER_ROUND,
            convergence.MAX_ROUNDS) == (consts["AP_THRESHOLD"],
                                        consts["EPOCHS_PER_ROUND"],
                                        consts["MAX_ROUNDS"])


def test_yolo_lr_over_a_long_run_matches_jax():
    """The ref-scale recipe's schedule at every step of 150 epochs (38
    steps each) and around its x0.1 boundary: the 2,000-step quartic
    burn-in and the plateau, as the JAX package computes them."""
    import jax
    import numpy as np

    from pytorch_pose_estimation_tpu import optim as jax_optim
    from pytorch_pose_estimation_tpu_torch import optim

    args = (1e-3, 2000, [105000], [0.1])
    t = np.concatenate([np.arange(0, 150 * 38 + 1),
                        np.arange(104990, 105011)])
    want = np.asarray(jax.vmap(jax_optim.yolo_lr(*args))(t))
    port = optim.yolo_lr(*args)
    got = np.array([port(int(s)) for s in t])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and got[2000] == 1e-3 and got[-1] == 1e-4


def test_saving_weights_makes_the_out_directory(tmp_path, monkeypatch):
    """The PIS chain's surgery command writes into a run directory that
    does not exist yet (``--out ./saved/<model>_<dataset>/
    pretrained_weights``, configs/sbp_pis_synth.yaml's
    ``model_pretrained``): the JAX CLI's orbax save makes it, and so must
    the port's."""
    from pytorch_pose_estimation_tpu_torch import saving_weights

    src = tmp_path / "best"
    torch.save({"backbone_features_module.0.0.conv.weight": torch.ones(2, 3),
                "sbp_head.0.weight": torch.zeros(4)}, src)
    monkeypatch.chdir(tmp_path)
    rel = "./saved/simple-baselines-pose_synth-ref-scale/pretrained_weights"
    out = saving_weights.main(["--ckpt", str(src), "--out", rel])
    assert out == os.path.abspath(rel)
    got = torch.load(out, weights_only=True)
    assert list(got) == ["backbone_features_module.0.0.conv.weight"]
    assert torch.equal(got["backbone_features_module.0.0.conv.weight"],
                       torch.ones(2, 3))


def _gt_predictor(data_module):
    """A predictor that returns each val batch's ground-truth joints (in
    input pixels, -1 where invisible), batch by batch in loader order."""
    import numpy as np

    batches = iter(data_module.val_loader())

    def predict(images):
        b = next(batches)
        j = np.asarray(b["joints"], np.float32)[..., :2]
        vis = np.asarray(b["joints_vis"]).reshape(j.shape[:2] + (-1,))
        conf = np.where(vis[..., 0] > 0, 1.0, -1.0)[..., None]
        return np.concatenate([j, conf], -1).astype(np.float32)
    return predict


def test_fall_harness_ceiling_on_the_behaviour_fixture(tmp_path,
                                                       monkeypatch):
    """The PIS accuracy run's falling-down val set
    (``make_pis_behavior_dataset`` with its defaults, seed 0): 3 of its 100
    upright samples have a ground-truth nose-to-shoulder gradient inside
    the harness's fallen band (-1, 8), so perfect joints score 98.50%,
    through the port's harness and the root CLI alike."""
    import numpy as np

    import pis_falling_down_test_code as jax_fall_cli
    from pytorch_pose_estimation_tpu.data import \
        SBPPISDataModule as JaxPISData
    from pytorch_pose_estimation_tpu_torch import pis_falling_down_test_code
    from pytorch_pose_estimation_tpu_torch.pis_handle_test_code import \
        pis_val_data
    from synth_fixture import make_pis_behavior_dataset

    _, _, fall_json = make_pis_behavior_dataset(str(tmp_path / "pis"))
    with open(fall_json) as f:
        db = json.load(f)
    names = {im["id"]: im["file_name"] for im in db["images"]}
    off = []
    for ann in db["annotations"]:
        k = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
        c = (k[5, :2] + k[6, :2]) / 2
        g = (k[0, 1] - c[1]) / (k[0, 0] - c[0] + 1e-6)
        if names[ann["image_id"]].split(os.sep)[-2] == "normal" and \
                -1 <= g <= 8:
            off.append(g)
    assert len(db["annotations"]) == 200 and len(off) == 3
    assert all(5 < g < 7 for g in off)

    cfg = get_configs(os.path.join(REPO, "configs", "sbp_pis_synth.yaml"))
    cfg.update(val_path=fall_json, workers=2, batch_size=64)
    dm = pis_val_data(cfg)
    got = pis_falling_down_test_code.evaluate(_gt_predictor(dm), dm,
                                              cfg["input_size"], -2)
    assert tuple(got) == (97, 100, 0, 3)  # 98.50%

    jax_dm = JaxPISData(
        train_path=None, val_path=fall_json, input_size=cfg["input_size"],
        output_size=cfg["output_size"], num_keypoints=cfg["num_keypoints"],
        sigma=cfg["sigma"], workers=2, batch_size=64,
        class_labels=cfg["class_labels"])
    jax_dm.setup()
    predict = _gt_predictor(jax_dm)
    monkeypatch.setattr(jax_fall_cli, "load_sbp_predictor",
                        lambda cfg, ckpt: predict)
    jax_cfg = dict(cfg, train_path=None)
    assert tuple(jax_fall_cli.run(jax_cfg, None, label_depth=-2)) == \
        (97, 100, 0, 3)


# --------------------------------------------------------------------------
# tb_trajectory
# --------------------------------------------------------------------------

def _write_events(logdir, rows, suffix):
    from tensorboardX import SummaryWriter

    w = SummaryWriter(str(logdir), filename_suffix=suffix)
    for step, loss, ap in rows:
        w.add_scalar("val_loss", loss, step)
        if ap is not None:
            w.add_scalar("val_mAP", ap, step)
    w.close()


@pytest.fixture(scope="module")
def events(tmp_path_factory):
    """Two event files: step 76 written twice in the first, step 114 again
    in the second (each later value the larger, where the JAX tool's rule
    and the last write agree); step 152 has no val_mAP."""
    d = tmp_path_factory.mktemp("events")
    _write_events(d, [(38, 564.95, 0.0), (76, 34.19, 0.0), (76, 35.5, 0.25),
                      (114, 28.09, 0.0)], ".a")
    _write_events(d, [(114, 29.5, 0.5), (152, 14.43, None),
                      (190, 7.958, 0.98)], ".b")
    assert len([f for f in os.listdir(d) if "events.out" in f]) == 2
    return str(d)


def _both(*args):
    jax = subprocess.run([sys.executable, JAX_TB, *args], cwd=REPO,
                         capture_output=True, timeout=120)
    port = subprocess.run(
        [sys.executable, "-m",
         "pytorch_pose_estimation_tpu_torch.tools.tb_trajectory", *args],
        cwd=REPO, capture_output=True, timeout=120)
    return jax, port


@pytest.mark.parametrize("extra", [[], ["--steps-per-epoch", "38"]])
def test_tb_trajectory_prints_the_jax_tools_table(events, extra):
    jax, port = _both(events, *extra)
    assert jax.returncode == port.returncode == 0, port.stderr
    assert port.stdout == jax.stdout
    lines = port.stdout.decode().splitlines()
    assert len(lines) == 6  # header and steps 38, 76, 114, 152, 190
    assert "| 152 |" in lines[4] and lines[4].endswith("| - |")
    assert "35.5 | 0.25" in lines[2] and "29.5 | 0.5" in lines[3]


def test_tb_trajectory_exits_1_on_a_missing_tag(events):
    jax, port = _both(events, "--tags", "val_loss,train_loss")
    assert jax.returncode == port.returncode == 1
    assert jax.stdout == port.stdout == b""
    assert b"'train_loss' not found" in port.stderr


def test_tb_trajectory_keeps_the_last_write_of_a_step(tmp_path):
    """A resumed run logs a step again with a lower loss: the value
    written last wins.  (The JAX tool sorts (step, value) pairs, so there
    it keeps the larger value.)"""
    _write_events(tmp_path, [(10, 9.0, 0.9), (10, 4.0, 0.2)], ".a")
    data = tb_trajectory.scalars(str(tmp_path))
    lines = tb_trajectory.table(data, ["val_loss", "val_mAP"])
    assert lines == ["| step | val_loss | val_mAP |", "| 10 | 4 | 0.2 |"]


def test_tb_trajectory_reads_the_trainers_printed_lines(events, tmp_path):
    """``--log``: the Trainer's validation lines (4 decimals) give the
    event files' table, a validation after epoch E standing at step
    (E + 1) * N; without N the rows are epochs."""
    text = "\n".join([
        "device cache: 9956 instances, 1400 MB on cuda, 38 steps/epoch",
        "epoch 0: train_loss=160.7342 (1790.1 img/s)",
        "epoch 0: val_loss=564.9500 val_mAP=0.0000",
        "epoch 1: val_loss=34.1900 val_mAP=0.0000",
        "epoch 1: val_loss=35.5000 val_mAP=0.2500",  # a resumed epoch
        "epoch 2: val_loss=29.5000 val_mAP=0.5000",
        "epoch 4: val_loss=7.9580 val_mAP=0.9800", ""])
    log = tmp_path / "train.log"
    log.write_text(text)
    main = "pytorch_pose_estimation_tpu_torch.tools.tb_trajectory"
    port = subprocess.run(
        [sys.executable, "-m", main, "--log", str(log), "--steps-per-epoch",
         "38"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert port.returncode == 0, port.stderr
    jax, _ = _both(events, "--steps-per-epoch", "38")
    want = [ln for ln in jax.stdout.decode().splitlines() if "| 152 |" not in
            ln]
    assert port.stdout.splitlines() == want
    rows = tb_trajectory.table(tb_trajectory.log_scalars(text),
                               ["val_loss", "val_mAP"], key="epoch")
    assert rows[0] == "| epoch | val_loss | val_mAP |"
    assert rows[2] == "| 1 | 35.5 | 0.25 |" and len(rows) == 5
    missing = subprocess.run(
        [sys.executable, "-m", main, "--log", str(log), "--tags",
         "val_loss,lr-step"], cwd=REPO, capture_output=True, timeout=120)
    assert missing.returncode == 1


# --------------------------------------------------------------------------
# the runners
# --------------------------------------------------------------------------

def test_ab_angle_groups_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ab_angle_groups.main(["16", "1"])
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def synth16(tmp_path_factory):
    """The convergence recipe's set: the same 16 images for train and
    val (31 instances)."""
    root = str(tmp_path_factory.mktemp("conv16"))
    make_dataset(root, "train2017", 16, seed=7)
    make_dataset(root, "val2017", 16, seed=7)
    return root


def test_ab_angle_groups_runs_end_to_end_on_the_cpu(synth16, tmp_path,
                                                    monkeypatch, capsys):
    """The runner's arm (``main`` without the card check) on 16 images at
    128x96 and batch 16 for 2 epochs: fit, validate, checkpoints under
    saved_ab/, and the JAX tool's JSON line."""
    cfg = get_configs(os.path.join(REPO, "configs", "sbp_synth_ref.yaml"))
    cfg.update(
        train_path=os.path.join(synth16, "annotations",
                                "person_keypoints_train2017.json"),
        val_path=os.path.join(synth16, "annotations",
                              "person_keypoints_val2017.json"),
        img_dir=synth16, input_size=[128, 96], output_size=[32, 24],
        batch_size=16, workers=2)
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    out = ab_angle_groups.run_arm(ab_angle_groups.make_cfg(16, 2, str(path)),
                                  16, "cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(line)
    assert result == out
    assert list(result) == ["G", "epochs", "val_loss", "ap50", "wall_s",
                            "version_dir"]
    assert (result["G"], result["epochs"]) == (16, 2)
    assert 0.0 <= result["ap50"] <= 1.0 and result["val_loss"] > 0
    ckpts = os.path.join(result["version_dir"], "checkpoints")
    assert result["version_dir"].startswith("./saved_ab/") and \
        "last" in os.listdir(ckpts)


def test_run_rounds_on_two_ranks_takes_the_jax_meshs_steps(synth16,
                                                           tmp_path,
                                                           monkeypatch):
    """One round of one epoch on 2 gloo ranks: the 31 instances padded to
    32 give 2 steps an epoch (the JAX test's 2-device cache), and both
    ranks return the same AP."""
    monkeypatch.chdir(tmp_path)
    cfg = dict(convergence.recipe_cfg(synth16), epochs=1)
    ranks = parallel.launch(convergence.run_rounds, ["cpu", "cpu"], "gloo",
                            args=(cfg, "cpu", 1, 0.0))
    assert ranks[0]["aps"] == ranks[1]["aps"] and len(ranks[0]["aps"]) == 1
    assert ranks[0]["steps"] == ranks[1]["steps"] == 2
    assert ranks[0]["crossed"] == 0 and 0.0 <= ranks[0]["best"] <= 1.0


def test_run_rounds_validates_every_nth_round_and_the_last(synth16,
                                                          tmp_path,
                                                          monkeypatch):
    """One process (31 instances: 1 step an epoch), 3 rounds of 1 epoch,
    a validation after every 2nd round and the last; the kernels' plain
    versions run on the CPU and count no launch."""
    from pytorch_pose_estimation_tpu_torch.ops import kernels

    monkeypatch.chdir(tmp_path)
    cfg = dict(convergence.recipe_cfg(synth16), epochs=1)
    before = [k.launches for k in kernels.KERNELS]
    r = convergence.run_rounds(cfg, "cpu", 3, 1.1, val_every=2)
    assert r["rounds"] == [1, 2] and len(r["aps"]) == 2
    assert r["steps"] == 3 and r["val_batches"] == 2
    assert r["crossed"] is None and r["best"] == max(r["aps"])
    assert [k.launches for k in kernels.KERNELS] == before


@pytest.mark.slow
def test_sbp_trains_to_ap_threshold(synth16, tmp_path, monkeypatch):
    """tests/test_convergence_e2e.py's recipe and threshold on 2 gloo
    ranks (the JAX test's 2-device mesh)."""
    monkeypatch.chdir(tmp_path)  # results.json stays in tmp
    cfg = convergence.recipe_cfg(synth16)
    ranks = parallel.launch(convergence.run_rounds, ["cpu", "cpu"], "gloo",
                            args=(cfg, "cpu"))
    result = ranks[0]
    print(f"rounds' AP@.5 {result['aps']}, crossed at round "
          f"{result['crossed']}, {result['steps']} steps, "
          f"{result['seconds']:.0f} s")
    assert ranks[1]["aps"] == result["aps"]
    assert result["best"] >= convergence.AP_THRESHOLD, (
        f"AP@.5 reached only {result['best']:.3f} after "
        f"{convergence.MAX_ROUNDS * convergence.EPOCHS_PER_ROUND} epochs")
