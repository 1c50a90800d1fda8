"""The port's SBP (pytorch_pose_estimation_tpu_torch.models) against the JAX
SBP: same weights through ``from_jax_variables``, eval-mode logits, the
reference state_dict keys, the weight bridge in both directions and the
parameter count.  Runs on the CPU at a 64x48 input (full channel widths)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_pose_estimation_tpu.models import SBP as JaxSBP
from pytorch_pose_estimation_tpu.models import SPM as JaxSPM
from pytorch_pose_estimation_tpu.models.summary import count_params as \
    jax_count_params
from pytorch_pose_estimation_tpu.models.torch_import import \
    import_torch_state_dict
from pytorch_pose_estimation_tpu_torch.models import (
    SBP, SPM, count_params, from_jax_variables, lecun_normal_,
    load_state_dict_file)
from pytorch_pose_estimation_tpu_torch.train import build_model

from test_torch_import import _ref_style_sbp

INPUT_HW = (64, 48)
CONV = "backbone_features_module.5.1.conv"


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def calibrated_jax_variables(x=None, seed=0, kind="sbp", input_hw=INPUT_HW,
                             num_keypoints=17):
    """A seeded flax SBP (or SPM, ``kind``) init of ``num_keypoints``
    joints whose BN running statistics are then set to the batch
    statistics of ``x`` (NCHW fp32;
    default a seeded uniform batch at ``input_hw``), so that eval-mode
    activations stay O(1) through the 22 blocks (with the init's mean 0 /
    var 1 they shrink to ~1e-5 at the logits, where every comparison is
    trivial).  The statistics are taken with the port in train mode
    (momentum 1) and carried back through the JAX package's own
    importer."""
    jax_cls, port_cls = (JaxSPM, SPM) if kind == "spm" else (JaxSBP, SBP)
    model = jax_cls(num_keypoints=num_keypoints)
    variables = _to_np(model.init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1,) + tuple(input_hw) + (3,))))
    port = port_cls(num_keypoints)
    port.load_state_dict(from_jax_variables(variables, kind))
    for m in port.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    if x is None:
        x = np.random.RandomState(seed).rand(8, 3, *input_hw)
    x = torch.from_numpy(np.asarray(x, np.float32))
    with torch.no_grad():
        port.train()(x)
        # logits within +-1 here: fp32 reordering error grows with them
        getattr(port, f"{kind}_head")[0].weight /= \
            port.eval()(x).abs().max()
    return _to_np(import_torch_state_dict(port.state_dict()))


@pytest.fixture(scope="module")
def jax_variables():
    return calibrated_jax_variables()


def _port(variables, dtype=torch.float32):
    model = SBP(17, dtype=dtype)
    model.load_state_dict(from_jax_variables(variables))
    return model.eval()


def _jax_logits_nchw(variables, x_nchw, dtype=jnp.float32):
    model = JaxSBP(num_keypoints=17, dtype=dtype)
    with jax.default_matmul_precision("highest"):
        out = model.apply(variables,
                          jnp.asarray(np.transpose(x_nchw, (0, 2, 3, 1))))
    return np.transpose(np.asarray(out, np.float32), (0, 3, 1, 2))


def test_logits_match_jax_fp32(jax_variables):
    """fp32 eval logits; atol 1e-4 covers fp32 sums over up to 9216 terms
    taken in another order by XLA and by torch's CPU convolutions."""
    x = np.random.RandomState(1).rand(2, 3, *INPUT_HW).astype(np.float32)
    want = _jax_logits_nchw(jax_variables, x)
    with torch.no_grad():
        got = _port(jax_variables)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 17, 16, 8) and got.dtype == np.float32
    assert np.abs(want).max() > 0.1  # the calibration gives O(1) logits
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_logits_bf16_follow_jax_precision_rule(jax_variables):
    """bf16 compute (convs in bf16, BN in fp32, fp32 logits) against the
    JAX model at dtype bf16.  Both round each block's output to bf16 but at
    slightly different points inside XLA and torch convolutions, so the
    tolerance is bf16-sized.  Measured as max |diff| / max |logit| on these
    inputs: 0.059 with the rule as written, 0.221 with BatchNorm run in
    bf16, 0.267 with the port in fp32.  The tolerance, 0.11, lies about
    2x from each side."""
    x = np.random.RandomState(2).rand(2, 3, *INPUT_HW).astype(np.float32)
    want = _jax_logits_nchw(jax_variables, x, jnp.bfloat16)
    with torch.no_grad():
        got = _port(jax_variables, torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    tol = 0.11 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_state_dict_keys_are_the_reference_keys():
    assert list(SBP(17).state_dict().keys()) == \
        list(_ref_style_sbp().state_dict().keys())


def test_weight_bridge_round_trips_exactly(jax_variables):
    port = _port(jax_variables)
    back = _to_np(import_torch_state_dict(port.state_dict()))
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(jax_variables)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_count_params_matches_jax(jax_variables):
    n = count_params(SBP(17))
    assert n == jax_count_params(jax_variables["params"]) == 36_606_368


def test_load_state_dict_file_reads_lightning_and_bare(tmp_path):
    src = SBP(17)
    lecun_normal_(src, torch.Generator().manual_seed(3))
    sd = src.state_dict()
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()},
                "epoch": 4}, tmp_path / "lightning.ckpt")
    torch.save(sd, tmp_path / "bare.pt")
    for name in ("lightning.ckpt", "bare.pt"):
        got = load_state_dict_file(str(tmp_path / name))
        assert list(got) == list(sd)
        for k in sd:
            assert torch.equal(got[k], sd[k]), k


def test_build_model_is_seeded_lecun_normal():
    cfg = {"num_keypoints": 17, "precision": "fp32", "seed": 5}
    a, b = build_model(cfg), build_model(cfg)
    c = build_model(dict(cfg, seed=6))
    w = a.get_submodule(CONV).weight.detach()  # 3x3, 512 -> 1024
    assert torch.equal(w, b.get_submodule(CONV).weight)
    assert not torch.equal(w, c.get_submodule(CONV).weight)
    std = (1.0 / (512 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert a.dtype == torch.float32
