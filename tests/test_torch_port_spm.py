"""The port's SPM model, targets, loss and decode against the JAX package's,
on the CPU, with numpy-seeded inputs: a 64x64 input (16x16 maps), full
channel widths, at most 8 persons.

Tolerances:
* logits: 1e-4 of the largest, in fp32 (the SBP test's bound: fp32 sums
  over up to 9216 terms in another order);
* targets: 1e-6.  Jitted, XLA rounds the division by z otherwise on the
  CPU; run op by op JAX agrees more closely (both gaps are printed, run
  with ``-s``);
* loss and per-sample loss: 1e-5 relative;
* peak NMS, keypoints, ``decode_spm_batch(pred=False)`` and ``DecodeSPM``:
  exact, the JAX side run op by op (``jax.disable_jit``): jitted, XLA
  contracts ``dx * z + x`` into one FMA on the CPU and moves keypoints by
  an ulp of the coordinate (within 1e-4 map px, printed);
* ``decode_spm_batch(pred=True)``: roots exact (the sigmoids agree on
  these inputs), keypoints within 1e-4 input px: torch's and XLA's tanh
  may differ by an ulp, times z * input / S = 724.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_pose_estimation_tpu import losses as JL
from pytorch_pose_estimation_tpu.models import SPM as JaxSPM
from pytorch_pose_estimation_tpu.models.summary import count_params as \
    jax_count_params
from pytorch_pose_estimation_tpu.models.torch_import import \
    import_torch_state_dict
from pytorch_pose_estimation_tpu.ops import decode as JD
from pytorch_pose_estimation_tpu.ops import targets as JT
from pytorch_pose_estimation_tpu_torch import losses as PL
from pytorch_pose_estimation_tpu_torch.models import (SPM, count_params,
                                                      from_jax_variables)
from pytorch_pose_estimation_tpu_torch.ops import decode as PD
from pytorch_pose_estimation_tpu_torch.ops import targets as PT

from test_torch_port_models import calibrated_jax_variables

HW = (64, 64)
S = 16  # map size
IN = 64
K = 17
P = 8


def nhwc(x):
    return jnp.asarray(np.transpose(np.asarray(x), (0, 2, 3, 1)))


@pytest.fixture(scope="module")
def variables():
    return calibrated_jax_variables(kind="spm", input_hw=HW)


def _port(variables):
    model = SPM(K)
    model.load_state_dict(from_jax_variables(variables, "spm"))
    return model.eval()


def test_spm_logits_match_jax_fp32(variables):
    x = np.random.RandomState(1).rand(2, 3, *HW).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = JaxSPM(num_keypoints=K).apply(variables, nhwc(x))
    want = np.transpose(np.asarray(want), (0, 3, 1, 2))
    with torch.no_grad():
        got = _port(variables)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1 + 2 * K, S, S) and got.dtype == np.float32
    scale = np.abs(want).max()
    assert scale > 0.1  # the calibration gives O(1) logits
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_spm_weights_round_trip_and_count(variables):
    """The head's key is the reference's, the bridge inverts the JAX
    importer exactly, and full-width SPM has 36,615,584 parameters
    (SBP's 36,606,368 - 512 * 17 + 512 * 35)."""
    port = _port(variables)
    assert list(port.state_dict())[-1] == "spm_head.0.weight"
    back = import_torch_state_dict(port.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    assert count_params(port) == jax_count_params(variables["params"]) \
        == 36_615_584


# --------------------------------------------------------------------------
# targets
# --------------------------------------------------------------------------

def _people(seed, b=3):
    """Integer map coordinates as the train step floors them: overlapping
    persons, a joint at (0, y>0) (present) and one at (0, 0) (absent),
    joints past the map, padded persons."""
    rng = np.random.RandomState(seed)
    joints = np.floor(rng.uniform(-2, S + 2, (b, P, K, 2))).astype(np.float32)
    centers = np.floor(rng.uniform(0, S, (b, P, 1, 2))).astype(np.float32)
    joints[0, 0, 0] = [0, 5]
    joints[0, 0, 1] = [0, 0]
    centers[0, 1, 0] = [0, 7]
    centers[1, 3:] = 0  # three persons, five padded
    joints[1, 3:] = 0
    centers[2, 1, 0] = centers[2, 0, 0] + 1  # overlapping boxes
    return centers, joints


@pytest.mark.parametrize("sigma", [1.0, 1.5])
def test_spm_target_matches_jax(sigma):
    centers, joints = _people(0)
    want = np.asarray(jax.vmap(lambda c, j: JT.spm_target(
        c, j, S, K, sigma))(centers, joints))
    got = PT.spm_target(torch.from_numpy(centers), torch.from_numpy(joints),
                        S, K, sigma)
    assert got.shape == (3, 1 + 2 * K, S, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    with jax.disable_jit():
        op_by_op = np.asarray(jax.vmap(lambda c, j: JT.spm_target(
            c, j, S, K, sigma))(centers, joints))
    print(f"spm_target sigma={sigma}: port vs JAX jitted "
          f"{np.abs(got.numpy() - want).max():.3g}, op by op "
          f"{np.abs(got.numpy() - op_by_op).max():.3g}")
    # the present joint at (0, 5): its field is non-zero in the person's box
    assert np.abs(want[0, 1:3]).max() > 0
    one = PT.SPMTargetGenerator(S, K, sigma)(centers[1], joints[1])
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())


@pytest.mark.parametrize("sigma", [1.0, 1.5])
def test_spm_masks_and_heatmaps_match_jax(sigma):
    """The parts: masks exact (box tests on integers), heatmaps to 1e-6
    (exp of torch and XLA), on float centers too (no int/clip)."""
    centers, _ = _people(1)
    centers = centers + np.float32(0.5) * (centers > 0)
    for c in centers:
        np.testing.assert_array_equal(
            PT.spm_masks(torch.from_numpy(np.floor(c)), S, sigma).numpy(),
            np.asarray(JT.spm_masks(jnp.floor(c), S, sigma)))
        np.testing.assert_allclose(
            PT.spm_heatmaps(torch.from_numpy(c), S, 1, sigma).numpy(),
            np.asarray(JT.spm_heatmaps(c, S, 1, sigma)), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def test_spm_loss_matches_jax():
    """A hand-made target whose displacement channels are non-zero off the
    root mask: those terms count (only the prediction is masked)."""
    rng = np.random.RandomState(2)
    logits = (rng.randn(3, 1 + 2 * K, S, S) * 2).astype(np.float32)
    target = rng.uniform(-0.5, 0.5, logits.shape).astype(np.float32)
    target[:, 0] = np.where(rng.rand(3, S, S) < 0.3,
                            rng.rand(3, S, S), 0.0)
    target[:, 1:, :4] *= 3  # |x| >= 1: SmoothL1's linear part
    want = float(JL.spm_loss(nhwc(logits), nhwc(target)))
    want_per = np.asarray(JL.spm_loss_per_sample(nhwc(logits), nhwc(target)))
    lt, tt = torch.from_numpy(logits), torch.from_numpy(target)
    np.testing.assert_allclose(float(PL.spm_loss(lt, tt)), want, rtol=1e-5)
    np.testing.assert_allclose(PL.spm_loss_per_sample(lt, tt).numpy(),
                               want_per, rtol=1e-5)
    np.testing.assert_allclose(want_per.mean(), want, rtol=1e-5)
    masked = target.copy()
    masked[:, 1:] *= target[:, :1] > 0
    assert abs(float(PL.spm_loss(lt, torch.from_numpy(masked))) - want) \
        > 1e-2 * want  # the off-mask targets matter


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _heatmaps():
    """[4, S, S] after the sigmoid: saturated ties; peaks at distance 4
    (suppressed: d <= 4) and sqrt(17) (kept); fewer peaks than M; none
    above the threshold."""
    rng = np.random.RandomState(3)
    hm = np.zeros((4, S, S), np.float32)
    hm[0] = 1 / (1 + np.exp(-(rng.randn(S, S) * 3)))
    hm[0, 2, 3] = hm[0, 9, 1] = hm[0, 12, 12] = 1.0  # sigmoid(x > 17)
    hm[1, 5, 5] = 0.9
    hm[1, 5, 9] = 0.8   # distance 4: suppressed
    hm[1, 9, 6] = 0.7   # distance sqrt(17) from (5, 5): kept
    hm[1, 1, 14] = 0.6
    hm[2] = rng.rand(S, S) * 0.4  # nothing above 0.5
    hm[3, 7, 7] = hm[3, 7, 8] = 0.95  # tie: the first wins, the next goes
    return hm


def test_peak_nms_matches_jax():
    hm = _heatmaps()
    for m in (3, 8):
        want = np.stack([np.asarray(JD._spm_peak_nms(jnp.asarray(h), 0.5,
                                                     4.0, m)) for h in hm])
        got = PD._spm_peak_nms(torch.from_numpy(hm), 0.5, 4.0, m).numpy()
        np.testing.assert_array_equal(got, want)
    assert got[1, :3, :2].tolist() == [[5, 5], [6, 9], [14, 1]]
    assert got[1, 3:].tolist() == [[-1, -1, -1]] * 5  # fewer than M
    assert (got[2] == -1).all()
    assert got[0, :3, :2].tolist() == [[3, 2], [1, 9], [12, 12]]
    assert got[3, :2, :2].tolist() == [[7, 7], [-1, -1]]


def test_keypoints_match_jax():
    hm = _heatmaps()
    disp = np.tanh(np.random.RandomState(4).randn(4, 2 * K, S, S) * 0.05
                   ).astype(np.float32)
    roots = PD._spm_peak_nms(torch.from_numpy(hm), 0.5, 4.0, 8)
    got = PD._spm_keypoints(roots, torch.from_numpy(disp), 4.0).numpy()
    args = [(jnp.asarray(r), jnp.asarray(d), 4.0)
            for r, d in zip(roots.numpy(), disp)]
    with jax.disable_jit():
        want = np.stack([np.asarray(JD._spm_keypoints(*a)) for a in args])
    np.testing.assert_array_equal(got, want)
    jitted = np.stack([np.asarray(JD._spm_keypoints(*a)) for a in args])
    fma = np.abs(got - jitted).max()
    print(f"_spm_keypoints: port vs JAX jitted {fma:.3g} map px")
    assert fma <= 1e-4
    kept = got[..., 2] != 0
    assert 0 < kept.sum() < kept.size  # both sides of the threshold
    assert (got[2] == 0).all()  # empty slots are all-zero rows


@pytest.mark.parametrize("pred", [False, True])
def test_decode_spm_batch_matches_jax(pred):
    centers, joints = _people(5)
    x = PT.spm_target(torch.from_numpy(centers), torch.from_numpy(joints),
                      S, K, 1.0).numpy()
    if pred:
        x = (np.random.RandomState(6).randn(*x.shape) * 3 - 6).astype(
            np.float32)
    with jax.disable_jit():
        want_r, want_j = (np.asarray(a) for a in JD.decode_spm_batch(
            nhwc(x), IN, 1.0, 0.5, pred, P))
    got_r, got_j = (a.numpy() for a in PD.decode_spm_batch(
        torch.from_numpy(x), IN, 1.0, 0.5, pred, P))
    assert got_r.shape == (3, P, 3) and got_j.shape == (3, P, K, 3)
    found = got_r[..., 2] >= 0
    assert 0 < found.sum() < found.size
    np.testing.assert_array_equal(got_r, want_r)
    if pred:
        np.testing.assert_array_equal(got_j[..., 2], want_j[..., 2])
        np.testing.assert_allclose(got_j, want_j, rtol=0, atol=1e-4)
    else:
        np.testing.assert_array_equal(got_j, want_j)


def test_decode_spm_strips_empty_slots_like_jax():
    centers, joints = _people(7)
    x = PT.spm_target(torch.from_numpy(centers), torch.from_numpy(joints),
                      S, K, 1.0).numpy()
    for one in x:
        got = PD.DecodeSPM(IN, 1.0, 0.5, pred=False, max_persons=P)(
            torch.from_numpy(one)[None])
        with jax.disable_jit():
            want = JD.DecodeSPM(IN, 1.0, 0.5, pred=False, max_persons=P)(
                jnp.asarray(one))
        assert len(got[0]) < P and (got[0][:, 2] >= 0).all()
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
