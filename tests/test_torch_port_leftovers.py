"""The port's ``test_coco_keypoints_map``, ``weight_initialize``, the
hourglass blocks, ``save_params`` / ``restore_params`` and ``summarize``
against the JAX package's, on the CPU.

Tolerances: the 10 COCO stats 1e-12 (the same NumPy arithmetic on both
sides); the Xavier bounds 1e-7 relative (float32 in JAX, float64 here);
the hourglass outputs, fp32, JAX at "highest" matmul precision, 1e-5 of
the largest value in eval mode (measured 2e-7 to 3e-7: the convolutions
sum in another order) and 1e-4 in train mode (measured 1e-5 to 2.4e-5:
flax takes the batch variance as E[x^2] - E[x]^2, torch in two passes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_coco_keypoints_map as jax_map_cli
from pytorch_pose_estimation_tpu.models import SBP as JaxSBP
from pytorch_pose_estimation_tpu.models.hourglass import \
    Hourglass as JaxHourglass
from pytorch_pose_estimation_tpu.models.hourglass import \
    Residual as JaxResidual
from pytorch_pose_estimation_tpu.models import SPM as JaxSPM
from pytorch_pose_estimation_tpu.models.darknet import \
    Darknet19 as JaxDarknet19
from pytorch_pose_estimation_tpu.models.initialize import \
    weight_initialize as jax_weight_initialize
from pytorch_pose_estimation_tpu.models.summary import \
    summarize as jax_summarize
from pytorch_pose_estimation_tpu_torch import test_coco_keypoints_map
from pytorch_pose_estimation_tpu_torch.models import (
    SBP, SPM, Darknet19Classifier, from_jax_variables, lecun_normal_,
    load_state_dict_file, print_summary, summarize)
from pytorch_pose_estimation_tpu_torch.models.hourglass import (
    Hourglass, Residual, hourglass_state_dict)
from pytorch_pose_estimation_tpu_torch.models.initialize import (
    weight_initialize, xavier_limit)
from pytorch_pose_estimation_tpu_torch.train import (
    TrainState, restore_checkpoint_flexible, restore_params, save_params)

from synth_fixture import make_dataset


def test_coco_keypoints_map_stats_equal_jax(tmp_path, monkeypatch, capsys):
    """The ground truth fed back as results: the port's 10 stats equal
    those the root script computes, and AP@.5 is the ceiling 1.0."""
    monkeypatch.chdir(tmp_path)
    val = make_dataset(str(tmp_path), "val2017", 6, seed=12)
    cfg = {"val_path": val}
    want = []
    run = jax_map_cli.KeypointEvaluator.run

    def recording(self, verbose=True):
        want.append(run(self, verbose))
        return want[-1]

    monkeypatch.setattr(jax_map_cli.KeypointEvaluator, "run", recording)
    jax_map_cli.main(cfg)
    got = test_coco_keypoints_map.main(cfg)
    assert got.shape == (10,) and len(want) == 1
    np.testing.assert_allclose(got, np.asarray(want[0]), rtol=0, atol=1e-12)
    assert got[1] == pytest.approx(1.0)
    assert capsys.readouterr().out.count("AP@OKS=.50 (stats[1]) = 1.0000") \
        == 2


def test_weight_initialize_bounds_equal_jax():
    """Per conv and deconv tensor, the port's Xavier bound equals the limit
    JAX computes from the flax kernel, and the draws fill it; BN weight 1,
    bias 0; the draws are seeded."""
    shapes = jax.eval_shape(JaxSBP(num_keypoints=3).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    jax_limits = []
    for path, leaf in flat:
        if path[-1].key == "kernel":
            rf = leaf.shape[0] * leaf.shape[1]
            jax_limits.append(float(np.sqrt(
                6.0 / (rf * leaf.shape[2] + rf * leaf.shape[3]))))
    re_init = jax_weight_initialize(variables["params"],
                                    jax.random.PRNGKey(7))
    sd = from_jax_variables({"params": re_init,
                             "batch_stats": variables["batch_stats"]})
    model = weight_initialize(SBP(3), torch.Generator().manual_seed(7))
    ours = model.state_dict()
    convs = [k for k, v in ours.items() if v.dim() == 4]
    assert len(convs) == len(jax_limits) == 22  # 18 + 3 deconvs + head
    by_name = {k: xavier_limit(ours[k]) for k in convs}
    np.testing.assert_allclose(sorted(by_name.values()), sorted(jax_limits),
                               rtol=1e-7)
    for k in convs:
        limit = by_name[k]
        # the same bound for JAX's re-drawn kernel of this tensor
        assert float(sd[k].abs().max()) <= limit * (1 + 1e-6), k
        assert 0.9 * limit < float(ours[k].abs().max()) <= limit, k
    for k, v in ours.items():
        if k.endswith("bn.weight") or k.endswith(".1.weight"):
            assert bool((v == 1).all()), k
        elif k.endswith("bn.bias") or k.endswith(".1.bias"):
            assert bool((v == 0).all()), k
    again = weight_initialize(SBP(3), torch.Generator().manual_seed(7))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in
               ours.items())
    linear = weight_initialize(torch.nn.Linear(400, 300),
                               torch.Generator().manual_seed(1))
    assert abs(float(linear.weight.detach().std()) - 0.01) < 1e-3
    assert bool((linear.bias == 0).all())


def _calibrated(module, x):
    """flax variables with BN running statistics moved off (0, 1), so that
    the eval-mode comparison reads them."""
    variables = jax.jit(module.init)(jax.random.PRNGKey(3), x)
    _, updates = _apply(module, variables, x, True)
    return {"params": variables["params"],
            "batch_stats": updates["batch_stats"]}


def _apply(module, variables, x, train):
    """module.apply, jitted: (out, BN updates) in train mode, else out."""
    if train:
        return jax.jit(lambda v, x: module.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, x)
    return jax.jit(module.apply)(variables, x)


@pytest.mark.parametrize("name,cin,features,depth", [
    ("residual", 16, 32, None), ("hourglass", 8, 16, 2)])
def test_hourglass_blocks_match_flax(name, cin, features, depth):
    """Converted weights: the port's Residual and Hourglass equal flax's
    in eval and train mode (batch statistics), fp32.  The depth-2
    hourglass holds residuals with and without the skip conv and a depth-1
    hourglass inside."""
    x = np.random.RandomState(depth or 0).rand(2, 16, 16, cin).astype(
        np.float32)
    if name == "residual":
        jax_module = JaxResidual(features)
        port = Residual(cin, features)
    else:
        jax_module = JaxHourglass(depth, features)
        port = Hourglass(depth, cin, features)
    variables = _calibrated(jax_module, jnp.asarray(x))
    port.load_state_dict(hourglass_state_dict(variables))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with jax.default_matmul_precision("highest"):
        for train in (False, True):
            want = _apply(jax_module, variables, x, train)
            want = np.asarray(want[0] if train else want).transpose(
                0, 3, 1, 2)
            port.train(train)
            with torch.no_grad():
                got = port(xt).numpy()
            assert got.shape == want.shape == (2, features, 16, 16)
            tol = 1e-4 if train else 1e-5
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=tol * np.abs(want).max())


# --------------------------------------------------------------------------
# save_params / restore_params and summarize
# --------------------------------------------------------------------------

def test_save_params_round_trips_and_flexible_restore_reads_it(tmp_path):
    """A bare state_dict (BN running statistics included, no optimizer
    state) round-trips bit for bit, leaves no temporary file, and the
    readers of a model file take it: ``restore_checkpoint_flexible`` (as
    JAX's falls back to ``restore_params``, train/checkpoint.py:110-118)
    and ``load_state_dict_file``."""
    model = lecun_normal_(SBP(17), torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                b.uniform_(0.5, 1.5, generator=gen)
    want = model.state_dict()
    path = save_params(str(tmp_path / "params.pt"), want)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["params.pt"]
    for got in (restore_params(path), load_state_dict_file(path)):
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    state = TrainState(SBP(17), None, None)
    assert restore_checkpoint_flexible(path, state) == {}
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    other = SBP(17).state_dict()
    assert save_params(path, other) == path  # overwritten
    assert torch.equal(restore_params(path)["sbp_head.0.weight"],
                       other["sbp_head.0.weight"])


SUMMARY_MODELS = {
    "sbp": (lambda: SBP(17), lambda: JaxSBP(num_keypoints=17),
            {"backbone": "backbone_features_module", "head": "sbp_head"}),
    "spm": (lambda: SPM(17), lambda: JaxSPM(num_keypoints=17),
            {"backbone": "backbone_features_module", "head": "spm_head"}),
    "classifier": (lambda: Darknet19Classifier(10),
                   lambda: JaxDarknet19(num_classes=10), {}),
}


@pytest.mark.parametrize("kind", sorted(SUMMARY_MODELS))
def test_summarize_matches_jax(kind, capsys):
    """The same dict as JAX's ``summarize`` at a 64x64 input, NCHW for
    NHWC and the reference's module names for flax's; ``print_summary``
    prints it and returns it."""
    port, jax_model, names = SUMMARY_MODELS[kind]
    got = summarize(port(), (1, 3, 64, 64))
    want = jax_summarize(jax_model(), (1, 64, 64, 3))
    def nhwc(shape):
        return (shape[0],) + shape[2:] + shape[1:2] if len(shape) == 4 \
            else shape

    assert nhwc(got["input_shape"]) == want["input_shape"]
    assert nhwc(got["output_shape"]) == want["output_shape"]
    assert got["params_per_module"] == {
        names.get(k, k): n for k, n in want["params_per_module"].items()}
    assert (got["total_params"], got["batch_stats"]) == \
        (want["total_params"], want["batch_stats"])
    assert print_summary(port(), (1, 3, 64, 64)) == got
    assert f"{got['total_params']:,}" in capsys.readouterr().out
