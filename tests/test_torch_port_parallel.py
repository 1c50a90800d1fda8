"""The port's data parallelism (``parallel``) on the CPU: ranks spawned by
``parallel.launch`` over gloo, against the JAX package's mesh (the
conftest's 8 virtual CPU devices) and against the port's one process on
the global batch.

One module fixture starts two ranks once and runs every case in them
(``_torch_parallel_worker.rank_main``); a second starts four for the
cross-replica BatchNorm.  The cases: BatchNorm; the SBP train step with
JAX's draws fed in, on the JAX tests' stride-4 stand-in (two steps) and on
the full-width SBP (one step), each with one angle per sample and with
one angle group spanning both ranks; the full-width SPM and classifier
steps (draws and dropout masks from generators seeded alike);
``validate`` with a ragged last batch; and a cached ``Trainer.fit`` with a
resume from 'auto'.

Tolerances:
* BatchNorm: 1e-6 of each tensor's largest value (the global statistics
  are combined from per-rank moments, in another order);
* the stand-in's two steps: the loss 1e-5 relative; parameters, BN
  running statistics and momentum traces rtol 2e-4, atol 1e-5
  (tests/test_multihost.py's: sharded sums run in another order);
* a full-width step: the loss 1e-5 relative; each parameter's update and
  momentum trace within 2e-2 of its norm, BN running statistics 1e-4 of
  the largest value (tests/test_torch_port_train.py's full-width bounds).
  At this init the update is ill-conditioned (see that file): 2 ranks
  against one process measured 0.35% (SBP), 1.2% (SPM) and 8e-5
  (classifier), 2 ranks against JAX's mesh 0.79% (SBP), the same as one
  process against JAX; a second step amplifies the gap, so the full-width
  cases take one;
* validation: the loss 1e-6 relative, the AP exactly;
* the ranks' final parameters, buffers and traces: bitwise equal;
* loader shards, cache rows and fed batches: exact.
"""

import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pytorch_pose_estimation_tpu import optim as jax_optim
from pytorch_pose_estimation_tpu.data.pipeline import HostLoader as JaxLoader
from pytorch_pose_estimation_tpu.models import SBP as JaxSBP
from pytorch_pose_estimation_tpu.parallel import (batch_sharding, make_mesh,
                                                  replicated_sharding)
from pytorch_pose_estimation_tpu.parallel import \
    select_devices as jax_select_devices
from pytorch_pose_estimation_tpu.train.device_cache import \
    DeviceDataCache as JaxCache
from pytorch_pose_estimation_tpu.train.state import create_train_state
from pytorch_pose_estimation_tpu.train.steps import \
    make_sbp_steps as jax_make_sbp_steps
from pytorch_pose_estimation_tpu_torch import parallel
from pytorch_pose_estimation_tpu_torch.data import HostLoader
from pytorch_pose_estimation_tpu_torch.models import from_jax_variables
from pytorch_pose_estimation_tpu_torch.ops.image import (replica_draws,
                                                         sample_augment)
from pytorch_pose_estimation_tpu_torch.train import DeviceDataCache

import _torch_parallel_worker as W
import _torch_update_gap as G
from synth_fixture import COCO_KP_NAMES, make_dataset
from test_torch_port_augment import jax_draws
from test_torch_port_models import calibrated_jax_variables

HW, OUT, K = W.HW, W.OUT, W.K
B = 4  # the global batch of the full-width steps: 2 rows a rank
KEYS = [jax.random.PRNGKey(101)]
DRAW_OPTS = dict(clahe_prob=0.5, angle_groups=16)
TINY_B = 8  # the stand-in's global batch (tests/_mh_common.py's)
TINY_KEYS = [jax.random.fold_in(jax.random.PRNGKey(42), i) for i in range(2)]
TIMEOUT = datetime.timedelta(seconds=300)


class FlaxTinyStride4(fnn.Module):
    """tests/test_parallel.py's stride-4 stand-in for SBP."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Conv(8, (3, 3), strides=(2, 2), use_bias=False,
                     name="c1")(x)
        x = fnn.BatchNorm(use_running_average=not train, name="bn1")(x)
        x = fnn.relu(x)
        x = fnn.Conv(8, (3, 3), strides=(2, 2), use_bias=False,
                     name="c2")(x)
        x = fnn.BatchNorm(use_running_average=not train, name="bn2")(x)
        x = fnn.relu(x)
        return fnn.Conv(3, (1, 1), use_bias=False, name="head")(x)


def _tiny_to_port(variables) -> dict:
    """The stand-in's flax variables as ``TinyStride4``'s state_dict
    (numpy); a params-shaped tree alone (a momentum trace) gives the
    weights only."""
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    out = {name: params[name]["kernel"].transpose(3, 2, 0, 1)
           for name in ("c1", "c2", "head")}
    for name in ("bn1", "bn2"):
        out[name + ".weight"] = params[name]["scale"]
        out[name + ".bias"] = params[name]["bias"]
        if "batch_stats" in variables:
            stats = variables["batch_stats"][name]
            out[name + ".running_mean"] = np.asarray(stats["mean"])
            out[name + ".running_var"] = np.asarray(stats["var"])
            out[name + ".num_batches_tracked"] = np.zeros((), np.int64)
    return {k if "." in k else k + ".weight": np.ascontiguousarray(v)
            for k, v in out.items()}


def _tiny_batch():
    rng = np.random.RandomState(0)  # tests/_mh_common.py's batch
    return {"image": rng.randint(0, 255, (TINY_B, 32, 32, 3), np.uint8),
            "joints": rng.uniform(2, 30, (TINY_B, 3, 2)).astype(np.float32),
            "joints_vis": np.ones((TINY_B, 3), np.float32)}


def _sbp_batch():
    rng = np.random.RandomState(3)
    return {"image": rng.randint(0, 256, (B,) + HW + (3,), dtype=np.uint8),
            "joints": np.stack([rng.uniform(0, HW[1], (B, K)),
                                rng.uniform(0, HW[0], (B, K))],
                               -1).astype(np.float32),
            "joints_vis": (rng.rand(B, K) > 0.2).astype(np.float32)}


def _fit_cfg(root, train, val):
    return {"model": "simple-baselines-pose", "dataset_name": "parallel",
            "train_path": train, "val_path": val, "img_dir": root,
            "input_size": [32, 32], "output_size": [8, 8],
            "num_keypoints": K, "sigma": 1.0, "conf_threshold": 0.25,
            "workers": 0, "batch_size": 4, "class_labels": COCO_KP_NAMES,
            "epochs": 2, "seed": 2, "precision": "fp32",
            "save_dir": os.path.join(root, "saved"), "cache_device": True,
            "optimizer": "sgd",
            "optimizer_options": {"lr": 1e-3, "momentum": 0.9,
                                  "weight_decay": 5e-3, "nesterov": True},
            "trainer_options": {"check_val_every_n_epoch": 1}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Inputs, the data sets and the calibrated SBP weights."""
    root = str(tmp_path_factory.mktemp("parallel"))
    variables = calibrated_jax_variables(input_hw=HW)
    model_path = os.path.join(root, "sbp.pt")
    torch.save(from_jax_variables(variables), model_path)
    batch = _sbp_batch()
    draws = {"groups4": [jax_draws(k, B, HW, **DRAW_OPTS) for k in KEYS],
             "groups1": [jax_draws(k, B, HW, clahe_prob=0.5, angle_groups=1)
                         for k in KEYS]}
    train = make_dataset(root, "train2017", 8, seed=21)
    val = make_dataset(root, "val2017", 4, seed=22)
    cfg = _fit_cfg(root, train, val)
    spm_cfg = {"val_path": val, "img_dir": root, "input_size": 64,
               "output_size": 16, "sigma": 1.0, "conf_threshold": 0.5,
               "batch_size": 3, "class_labels": COCO_KP_NAMES,
               "num_keypoints": K, "max_persons": 3, "seed": 5}
    tiny = jax.tree_util.tree_map(np.asarray, FlaxTinyStride4().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    tiny_draws = {f"groups{g}": ([jax_draws(k, TINY_B, (32, 32),
                                            angle_groups=g)
                                  for k in TINY_KEYS], g) for g in (16, 1)}
    return {"cwd": root, "variables": variables, "bn": W.bn_inputs(B),
            "tiny_variables": tiny,
            "tiny": {"state": _tiny_to_port(tiny), "batch": _tiny_batch(),
                     "draws": tiny_draws},
            "sbp": {"model": model_path, "batch": batch, "draws": draws},
            "spm": W.spm_batch(B), "classifier": W.classifier_batch(B),
            "validate": (cfg, 5), "spm_validate": spm_cfg, "fit": cfg}


@pytest.fixture(scope="module")
def two(setup):
    spec = {k: v for k, v in setup.items()
            if k not in ("variables", "tiny_variables")}
    return parallel.launch(W.rank_main, ["cpu", "cpu"], "gloo",
                           args=(spec,), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def four(setup):
    spec = {"cwd": setup["cwd"], "bn": setup["bn"]}
    return parallel.launch(W.rank_main, ["cpu"] * 4, "gloo", args=(spec,),
                           timeout=TIMEOUT)


def _step_gaps(got: dict, want: dict, start: dict) -> dict:
    """Per parameter, |update got - update want| / |update want| (updates
    from ``start``) and |trace got - trace want| / |trace want|; per BN
    buffer, the largest difference over the largest value."""
    gaps = {}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            gaps[k] = float((got[k] - w).abs().max() / w.abs().max())
        elif k.startswith("trace."):
            gaps[k] = float((got[k] - w).norm() / w.norm())
        else:
            gaps[k] = float((got[k] - w).norm() / (w - start[k]).norm())
    return gaps


def _assert_full_width_step_close(got: dict, want: dict, start: dict):
    """The full-width bounds of tests/test_torch_port_train.py: each
    parameter's update and momentum trace within 2e-2 of its norm, BN
    running statistics within 1e-4 of the largest value."""
    assert sorted(got) == sorted(want)
    for k, gap in _step_gaps(got, want, start).items():
        bound = 1e-4 if "running" in k else 2e-2
        assert gap <= bound, (k, gap)


def _assert_state_close(got: dict, want: dict):
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    assert sorted(keys) == sorted(k for k in got
                                  if not k.endswith("num_batches_tracked"))
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=1e-5, err_msg=k)


# --------------------------------------------------------------------------
# the ranks' runs
# --------------------------------------------------------------------------

def _flax_bn(x, g, w, b):
    """flax's train-mode BatchNorm (momentum 0.9, eps 1e-5) of NCHW ``x``
    on one device: y, dx, dw, db and the running statistics from mean 0.3
    and var 2."""
    from flax import linen as fnn

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, axis=1)
    variables = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": {"mean": jnp.full(3, 0.3),
                                 "var": jnp.full(3, 2.0)}}

    def loss(params, x):
        y, mutated = bn.apply({**variables, "params": params}, x,
                              mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mutated["batch_stats"])

    with jax.default_matmul_precision("highest"):
        (_, (y, stats)), (dp, dx) = jax.value_and_grad(
            loss, (0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
    return {"y": y, "dx": dx, "dw": dp["scale"], "db": dp["bias"],
            "running_mean": stats["mean"], "running_var": stats["var"]}


@pytest.mark.parametrize("world", [2, 4])
def test_cross_replica_batchnorm_matches_one_process_and_flax(
        setup, two, four, world):
    """Each rank normalizes its rows with the global batch's statistics:
    outputs and input gradients (concatenated over the ranks), weight and
    bias gradients (summed: each rank's share of sum(y * g)) and the
    running statistics (flax's rule with the global count) equal one
    process's on the global batch and flax's."""
    runs = two if world == 2 else four
    assert [r["world"] for r in runs] == [world] * world
    ranks = [r["bn"] for r in runs]
    got = {"y": torch.cat([r["y"] for r in ranks]),
           "dx": torch.cat([r["dx"] for r in ranks]),
           "dw": sum(r["dw"] for r in ranks),
           "db": sum(r["db"] for r in ranks),
           "running_mean": ranks[0]["running_mean"],
           "running_var": ranks[0]["running_var"]}
    for r in ranks[1:]:
        assert torch.equal(r["running_mean"], got["running_mean"])
        assert torch.equal(r["running_var"], got["running_var"])
    one = W.bn_case(*setup["bn"])
    flax = _flax_bn(*setup["bn"])
    for name, want in (("one process", one), ("flax", flax)):
        for k, v in want.items():
            v = np.asarray(v)
            np.testing.assert_allclose(
                got[k].numpy(), v, rtol=0, atol=1e-6 * np.abs(v).max(),
                err_msg=f"{k} vs {name}")


def _trace(opt_state):
    """The momentum trace tree in an optax chain's state."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _trace(s)
            if found is not None:
                return found
    return None


def _jax_mesh_steps(model, variables, batch, keys, hw, out, k, sigma,
                    augment, devices=2):
    """JAX's make_sbp_steps on a ``devices``-device mesh (batch sharded,
    state replicated), one step per key; returns (losses, state, traces)
    with the flax trees of the state's params and batch_stats and of the
    momentum trace."""
    tx = jax_optim.get_optimizer("sgd", **W.SGD)
    state = create_train_state(model, tx, (1,) + tuple(hw) + (3,))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    step, _ = jax_make_sbp_steps(model, tx, list(hw), out, k, sigma,
                                 augment=augment)
    mesh = make_mesh(jax.devices()[:devices])
    state = jax.device_put(state, replicated_sharding(mesh))
    sharded = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh))
               for k, v in batch.items()}
    losses = []
    with jax.default_matmul_precision("highest"):
        for key in keys:
            state, loss = step(state, sharded, key)
            losses.append(float(loss))
    tree = jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})
    return losses, tree, jax.tree_util.tree_map(np.asarray,
                                                _trace(state.opt_state))


def _jax_mesh_sbp(variables, batch, keys):
    """The full-width SBP's steps on JAX's 2-device mesh: (losses, state
    and traces ('trace.<name>') under the port's names)."""
    losses, tree, trace = _jax_mesh_steps(
        JaxSBP(num_keypoints=K), variables, batch, keys, HW, OUT, K,
        W.SIGMA, W.AUGMENT)
    out = from_jax_variables(tree)
    traces = from_jax_variables({"params": trace,
                                 "batch_stats": tree["batch_stats"]})
    out.update({"trace." + k: v for k, v in traces.items()
                if not k.endswith(("running_mean", "running_var",
                                   "num_batches_tracked"))})
    return losses, out


def _ranks_state(two, setup, name):
    """Rank 0's state of case ``name`` (the ranks agree bitwise)."""
    assert all(r[name]["same"] for r in two), name
    assert two[0][name]["losses"] == two[1][name]["losses"]
    return two[0][name]["losses"], torch.load(
        os.path.join(setup["cwd"], name + ".pt"), weights_only=True)


@pytest.mark.parametrize("groups", [16, 1])
def test_tiny_sbp_steps_two_ranks_match_jax_mesh_and_one_process(
        setup, two, groups):
    """Two SBP train steps of the stand-in (tests/_mh_common.py's batch,
    keys and nesterov SGD) on 2 ranks against JAX's make_sbp_steps on a
    2-device mesh with the same weights and draws, and against the port's
    one process.  With 16 requested groups every sample has its angle;
    with 1, one angle rotates the whole batch and each rank holds half of
    its group."""
    name = f"groups{groups}"
    losses, state = _ranks_state(two, setup, "tiny_" + name)
    state = {k: v for k, v in state.items()
             if not k.endswith("num_batches_tracked")}
    want_losses, tree, trace = _jax_mesh_steps(
        FlaxTinyStride4(), setup["tiny_variables"], setup["tiny"]["batch"],
        TINY_KEYS, (32, 32), (8, 8), 3, 1.0, {"angle_groups": groups})
    want = _tiny_to_port(tree)
    want.update({"trace." + k: v
                 for k, v in _tiny_to_port({"params": trace}).items()})
    want = {k: torch.from_numpy(np.array(v)) for k, v in want.items()
            if not k.endswith("num_batches_tracked")}
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_state_close(state, want)
    draws, _ = setup["tiny"]["draws"][name]
    one = W.tiny_case(setup["tiny"]["state"], setup["tiny"]["batch"], draws,
                      groups)
    np.testing.assert_allclose(losses, one["losses"], rtol=1e-5)
    _assert_state_close(state, one["state"])


def test_sbp_step_two_ranks_matches_jax_mesh(setup, two):
    """One full-width SBP train step (device CLAHE, one angle per sample,
    K1's plain version, nesterov SGD) on 2 ranks against JAX's
    make_sbp_steps on a 2-device mesh, from the same weights (through
    ``from_jax_variables``) and draws: each update and momentum trace
    within the one-ulp yardstick of tests/_torch_update_gap.py (measured
    on the port's one process) and within 2e-2 of its norm, the BN running
    statistics within 1e-4."""
    losses, state = _ranks_state(two, setup, "sbp_groups4")
    want_losses, want = _jax_mesh_sbp(setup["variables"],
                                      setup["sbp"]["batch"], KEYS)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    start = torch.load(setup["sbp"]["model"], weights_only=True)
    assert sorted(state) == sorted(want)
    names = [k for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    batch, draws = setup["sbp"]["batch"], setup["sbp"]["draws"]["groups4"]
    noisy_path = os.path.join(setup["cwd"], "sbp_noisy.pt")

    def one_process(sd):
        torch.save(sd, noisy_path)
        return W.sbp_case(noisy_path, batch, draws)["state"]

    ulp = G.ulp_gaps(one_process, start, one_process(start), names)
    G.assert_update_close(state, want, start, ulp, names, bound=2e-2,
                          label="sbp step, 2 ranks vs JAX's 2-device mesh")


@pytest.mark.parametrize("groups", ["groups4", "groups1"])
def test_sbp_step_two_ranks_matches_one_process(setup, two, groups):
    """The same step against the port's one process on the global batch;
    'groups1' rotates the whole batch with one angle."""
    losses, state = _ranks_state(two, setup, "sbp_" + groups)
    one = W.sbp_case(setup["sbp"]["model"], setup["sbp"]["batch"],
                     setup["sbp"]["draws"][groups])
    np.testing.assert_allclose(losses, one["losses"], rtol=1e-5)
    _assert_full_width_step_close(
        state, one["state"],
        torch.load(setup["sbp"]["model"], weights_only=True))


def test_spm_step_two_ranks_matches_one_process(setup, two):
    losses, state = _ranks_state(two, setup, "spm")
    one = W.spm_case(setup["spm"])
    np.testing.assert_allclose(losses, one["losses"], rtol=1e-5)
    _assert_full_width_step_close(state, one["state"],
                                  W.spm_start().state_dict())


def test_classifier_step_two_ranks_matches_one_process(setup, two):
    """One classifier step with the global batch's dropout mask: the loss,
    the accuracy and the state."""
    losses, state = _ranks_state(two, setup, "classifier")
    one = W.classifier_case(*setup["classifier"])
    np.testing.assert_allclose(losses, one["losses"], rtol=1e-5)
    _assert_full_width_step_close(state, one["state"],
                                  W.classifier_start().state_dict())


def test_validate_with_ragged_batch_matches_one_process(setup, two,
                                                        monkeypatch):
    """5 val instances at batch 4: the last batch of 1 is padded to 2 rows
    for the 2 ranks; every rank returns one process's val_loss and AP,
    and rank 0's metric holds one process's predictions, the 5 real rows
    only."""
    monkeypatch.chdir(setup["cwd"])
    cfg, n_val = setup["validate"]
    assert len(W.data_module(cfg).val_db) >= n_val
    want_loss, want_map, want_pred = W.validate_case(cfg, n_val)
    assert len(want_pred) == n_val
    for r in two:
        loss, ap, pred = r["validate"]
        assert loss == pytest.approx(want_loss, rel=1e-6, abs=0)
        assert ap == want_map
        assert pred == (want_pred if r["rank"] == 0 else None)


def test_spm_validate_two_ranks_matches_one_process(setup, two,
                                                   monkeypatch):
    """SPM's sharded validation (the decoded roots and keypoints gathered
    as a tuple): 4 val images at batch 3, both batches padded for the 2
    ranks; one process's val_loss, AP and predictions."""
    monkeypatch.chdir(setup["cwd"])
    want_loss, want_map, want_pred = W.spm_validate_case(
        setup["spm_validate"])
    assert want_pred
    for r in two:
        loss, ap, pred = r["spm_validate"]
        assert loss == pytest.approx(want_loss, rel=1e-6, abs=0)
        assert ap == want_map
        assert pred == (want_pred if r["rank"] == 0 else None)


def test_cached_fit_two_ranks_feeds_jax_batches_and_resumes(setup, two):
    """The cached Trainer.fit on 2 ranks: each rank holds half the cache
    and is fed, step by step, its columns of JAX's 2-device cache batches;
    a resume from 'auto' continues at the same step on both ranks with
    epoch 2's batches; rank 0 alone wrote checkpoints; the final states
    agree bitwise."""
    cfg = setup["fit"]
    memo = cfg["train_path"] + ".devcache"
    arrays = {k: np.load(os.path.join(memo, k + ".npy"))
              for k in ("image", "joints", "joints_vis")}
    jax_cache = JaxCache(make_mesh(jax.devices()[:2]), arrays, 4, seed=2)
    data = {k: np.asarray(v) for k, v in jax_cache._data.items()}
    n_local, pb = jax_cache.n_local, jax_cache.per_device_batch
    steps = jax_cache.steps_per_epoch
    for d, r in enumerate(two):
        fit = r["fit"]
        assert (fit["n_total"], fit["n_local"]) == (jax_cache.n_total,
                                                    n_local)
        assert fit["nbytes"] * 2 == jax_cache.nbytes()
        assert fit["steps"] == (2 * steps, 3 * steps)
        # rank 0: an epoch checkpoint and 'last' for each of 3 epochs
        assert fit["writes"] == (0 if d else 6)
        assert fit["same"]
        for epoch, fed in ((0, fit["fed"][:steps]),
                           (1, fit["fed"][steps:]), (2, fit["fed_resumed"])):
            assert len(fed) == steps
            idx = jax_cache.epoch_indices(epoch)[:, d * pb:(d + 1) * pb]
            for s, batch in enumerate(fed):
                for k, v in batch.items():
                    np.testing.assert_array_equal(
                        v, data[k][d * n_local + idx[s]],
                        err_msg=f"rank {d} epoch {epoch} step {s} {k}")


# --------------------------------------------------------------------------
# one process: devices, loader shards, cache shards, draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("devices", ["auto", None, 2, [0, 3], 1])
def test_select_devices_counts_as_jax(devices):
    want = len(jax_select_devices(devices))
    got = parallel.select_devices(devices, available=len(jax.devices()))
    assert len(got) == want
    assert all(d.type == "cuda" for d in got)


def test_default_backend():
    assert parallel.default_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert parallel.default_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert parallel.default_backend(["cpu", "cpu"]) == "gloo"


@pytest.mark.parametrize("n", [16, 17, 31])
@pytest.mark.parametrize("count", [2, 3])
def test_loader_shards_equal_jax(n, count):
    """Every process's indices and batches equal JAX's HostLoader, with
    and without shuffle, in epochs 0 and 1."""
    for shuffle in (False, True):
        for epoch in (0, 1):
            for p in range(count):
                kw = dict(batch_size=4, shuffle=shuffle, seed=7,
                          drop_last=shuffle, process_index=p,
                          process_count=count)
                ours = HostLoader(list(range(n)), lambda r, i, e: {"x": r},
                                  **kw)
                theirs = JaxLoader(list(range(n)), lambda r, i, e: {"x": r},
                                   **kw)
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
                np.testing.assert_array_equal(ours._indices(),
                                              theirs._indices())
                assert len(ours) == len(theirs)
                got = [b["x"].tolist() for b in ours]
                assert got == [b["x"].tolist() for b in theirs]


def test_split_rows_are_the_global_batches_rows():
    """On one node each rank builds rows r*b:(r+1)*b of every global
    batch, in the one-process order; a batch that does not split
    raises."""
    def loader():
        ld = HostLoader(list(range(22)), lambda r, i, e: {"x": r}, 6,
                        shuffle=True, seed=3, drop_last=True)
        ld.set_epoch(1)
        return ld

    whole = [b["x"] for b in loader()]
    parts = [[b["x"] for b in loader().split_rows(r, 3)] for r in range(3)]
    assert len(whole) == 3
    for s, batch in enumerate(whole):
        np.testing.assert_array_equal(
            np.concatenate([p[s] for p in parts]), batch)
    with pytest.raises(ValueError, match="not divisible"):
        loader().split_rows(0, 4)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("n,batch,seed", [(17, 4, 3), (64, 16, 11),
                                          (30, 8, 5)])
def test_cache_shards_equal_jax_mesh(world, n, batch, seed):
    """Rank r's cache holds 1/world of the bytes, and its rows of every
    step are its columns of JAX's DeviceDataCache.epoch_indices on a
    world-device mesh, gathered from its shard."""
    rng = np.random.RandomState(seed)
    arrays = {"image": rng.randint(0, 256, (n, 4, 3, 3), dtype=np.uint8),
              "joints": rng.uniform(0, 32, (n, 5, 2)).astype(np.float32)}
    theirs = JaxCache(make_mesh(jax.devices()[:world]), arrays, batch,
                      seed=seed)
    data = {k: np.asarray(v) for k, v in theirs._data.items()}
    pb = batch // world
    for r in range(world):
        ours = DeviceDataCache(arrays, batch, seed=seed, device="cpu",
                               rank=r, world=world)
        assert (ours.n_total, ours.n_local, ours.steps_per_epoch) == \
            (theirs.n_total, theirs.n_local, theirs.steps_per_epoch)
        assert ours.nbytes() * world == theirs.nbytes()
        for epoch in (0, 3):
            idx = theirs.epoch_indices(epoch)
            np.testing.assert_array_equal(ours.epoch_indices(epoch), idx)
            cols = idx[:, r * pb:(r + 1) * pb]
            for s, got in enumerate(ours.epoch_batches(epoch)):
                for k, v in got.items():
                    np.testing.assert_array_equal(
                        v.numpy(), data[k][r * ours.n_local + cols[s]])


@pytest.mark.parametrize("batch,groups,world", [(8, 4, 2), (8, 2, 4),
                                                (12, 4, 2), (12, 3, 2),
                                                (8, 1, 2)])
def test_replica_draws_keep_the_global_rows_and_angles(batch, groups,
                                                       world):
    """Each rank's draws are its rows of the global batch's, and every
    sample keeps the angle of its global group: a rank may hold several
    groups, a part of one, or groups cut at its edges."""
    gen = torch.Generator().manual_seed(9)
    draws = sample_augment(gen, batch, (16, 12), angle_groups=groups,
                           clahe_prob=0.5)
    g = draws.angles.shape[0]
    per_sample = draws.angles.repeat_interleave(batch // g)
    b = batch // world
    for r in range(world):
        mine = replica_draws(draws, r, world)
        local = mine.angles.repeat_interleave(b // mine.angles.shape[0])
        torch.testing.assert_close(local, per_sample[r * b:(r + 1) * b],
                                   rtol=0, atol=0)
        for k in ("rotate", "brightness", "x0", "clahe", "clahe_clip"):
            assert torch.equal(getattr(mine, k),
                               getattr(draws, k)[r * b:(r + 1) * b]), k
        assert mine.jitter_order == draws.jitter_order
    assert replica_draws(draws, 0, 1) is draws


def test_launch_raises_a_failing_ranks_error_without_hanging():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        parallel.launch(W.fail_on_rank_1, ["cpu", "cpu"], "gloo",
                        timeout=datetime.timedelta(seconds=60))



_FROM_STDIN = """
from pytorch_pose_estimation_tpu_torch import parallel
parallel.launch(parallel.rank, ["cpu", "cpu"], "gloo",
                args=(), timeout=__import__("datetime").timedelta(seconds=30))
"""


def test_launch_from_standard_input_raises_at_once():
    """spawn re-imports the main module in each rank; a program read from
    standard input has none, and with arguments over a pipe's buffer
    spawn's parent used to block for good on the dead ranks: ``launch``
    raises before it starts them."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-"], input=_FROM_STDIN,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "run the program from a file" in out.stderr, out.stderr[-2000:]
