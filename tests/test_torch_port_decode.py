"""The port's SBP decode (plain version of kernel K2) against the JAX
package: ``decode_sbp_pallas`` run in interpret mode and the XLA
``decode_sbp_batch``.  The port takes NCHW logits, JAX NHWK.  x and y must
be equal and conf within 1e-6 (an ulp or two of a sigmoid value <= 1,
computed by torch and by XLA): both decode the first index of the max."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_pose_estimation_tpu.ops import DecodeSBP as JaxDecodeSBP
from pytorch_pose_estimation_tpu.ops import decode_sbp as jax_decode_sbp
from pytorch_pose_estimation_tpu.ops import \
    decode_sbp_batch as jax_decode_sbp_batch
from pytorch_pose_estimation_tpu.ops.pallas import decode_sbp_pallas
from pytorch_pose_estimation_tpu_torch.ops import (
    DecodeSBP, decode_sbp, decode_sbp_batch, decode_sbp_fast,
    sbp_heatmaps_batch)


def _both_jax(logits_nchw, input_w, thr, pred):
    nhwk = jnp.asarray(np.transpose(logits_nchw, (0, 2, 3, 1)))
    return (np.asarray(decode_sbp_pallas(nhwk, input_w, thr, pred)),
            np.asarray(jax_decode_sbp_batch(nhwk, input_w, thr, pred)))


def _assert_same(got, want):
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-6)


def _random_logits(h=64, w=48):
    return (np.random.RandomState(1).randn(4, 17, h, w) * 3
            ).astype(np.float32)


def _tie_logits(h=64, w=48):
    """Channel 0: all 30 (sigmoid saturates to 1.0 everywhere) -> index 0.
    Channel 1: 25 at index 100 and 20 at index 50, both 1.0 after the
    sigmoid -> index 50, although the raw logits' argmax is 100.
    Channel 2: two equal maxima -> the first.  Channel 3: all -20 -> below
    any threshold -> sentinel."""
    x = np.full((2, 4, h, w), -5.0, np.float32)
    x[:, 0] = 30.0
    x[:, 1].reshape(2, -1)[:, 100] = 25.0
    x[:, 1].reshape(2, -1)[:, 50] = 20.0
    x[:, 2].reshape(2, -1)[:, [700, 300]] = 2.0
    x[:, 3] = -20.0
    return x


@pytest.mark.parametrize("case,h,w", [
    pytest.param("random", 64, 48, id="random"),
    pytest.param("ties", 64, 48, id="ties"),
    # H*W % 4 != 0: maps off 16-byte boundaries on the card
    pytest.param("random", 63, 47, id="random-63x47"),
    pytest.param("ties", 63, 47, id="ties-63x47")])
def test_decode_matches_jax_pallas_and_xla(case, h, w):
    logits = _random_logits(h, w) if case == "random" else _tie_logits(h, w)
    got = decode_sbp_batch(torch.from_numpy(logits), 192, 0.25).numpy()
    assert got.shape == logits.shape[:2] + (3,)
    for want in _both_jax(logits, 192, 0.25, True):
        _assert_same(got, want)
    if case == "ties":
        s = np.float32(192 / w)  # coordinates are fp32 products
        np.testing.assert_array_equal(got[:, 0], [[0, 0, 1]] * 2)
        np.testing.assert_array_equal(
            got[:, 1], [[np.float32(50 % w) * s, np.float32(50 // w) * s,
                         1]] * 2)
        np.testing.assert_array_equal(
            got[:, 2, :2], [[np.float32(300 % w) * s,
                             np.float32(300 // w) * s]] * 2)
        np.testing.assert_array_equal(got[:, 3], [[-s, -s, -1]] * 2)


def test_decode_sentinels_below_threshold():
    logits = np.zeros((2, 3, 64, 48), np.float32)  # sigmoid 0.5 everywhere
    got = decode_sbp_batch(torch.from_numpy(logits), 192, 0.9).numpy()
    for want in _both_jax(logits, 192, 0.9, True):
        _assert_same(got, want)
    np.testing.assert_array_equal(got,
                                  np.broadcast_to([-4, -4, -1], got.shape))


def test_decode_gt_mode_recovers_stamped_joints():
    """pred=False on stamped targets: the peak (exactly 1.0) clears 0.99 at
    the truncated joint, so decode gives back trunc(joint) * 4."""
    joints = np.array([[[10, 20], [40, 60], [-1, -1], [47, 63],
                        [5.7, 30.2]]], np.float32)
    maps = sbp_heatmaps_batch(torch.from_numpy(joints), (64, 48), 5, 2.0)
    got = decode_sbp_batch(maps, 192, 0.99, pred=False).numpy()
    for want in _both_jax(maps.numpy(), 192, 0.99, False):
        _assert_same(got, want)
    for (x, y), (dx, dy, conf) in zip(joints[0], got[0]):
        if x < 0:
            assert conf == -1.0
        else:
            assert (dx, dy, conf) == (int(x) * 4, int(y) * 4, 1.0)


def test_decode_sbp_single_and_fast_on_cpu():
    logits = _random_logits()[:2]
    got = decode_sbp_batch(torch.from_numpy(logits), 192, 0.25).numpy()
    np.testing.assert_array_equal(
        decode_sbp_fast(torch.from_numpy(logits), 192, 0.25).numpy(), got)
    single = decode_sbp(torch.from_numpy(logits[1]), (256, 192), 0.25)
    np.testing.assert_array_equal(single.numpy(), got[1])
    _assert_same(single.numpy(),
                 np.asarray(jax_decode_sbp(logits[1], (256, 192), 0.25)))


@pytest.mark.parametrize("batch", [1, 3])
def test_decode_object_shapes(batch):
    logits = _random_logits()[:batch]
    got = DecodeSBP((256, 192), 0.25)(logits).numpy()
    want = np.asarray(JaxDecodeSBP((256, 192), 0.25)(logits))
    assert got.shape == ((17, 3) if batch == 1 else (batch, 17, 3))
    _assert_same(got, want)
