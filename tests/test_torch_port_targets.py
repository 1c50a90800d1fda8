"""The port's SBP Gaussian targets (plain version of kernel K1) against the
JAX package: ``sbp_heatmaps_pallas`` run in interpret mode and the vmapped
``sbp_heatmaps``.  atol 1e-6: the window arithmetic is exact in fp32 (integer
and half-integer values), so only expf and the division may differ, by an
ulp or so of values <= 1.  Also the SBP loss on those targets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_pose_estimation_tpu.losses import sbp_loss as jax_sbp_loss
from pytorch_pose_estimation_tpu.losses import \
    sbp_loss_per_sample as jax_sbp_loss_per_sample
from pytorch_pose_estimation_tpu.ops import sbp_heatmaps as jax_sbp_heatmaps
from pytorch_pose_estimation_tpu.ops.pallas import sbp_heatmaps_pallas
from pytorch_pose_estimation_tpu_torch.losses import (sbp_loss,
                                                     sbp_loss_per_sample)
from pytorch_pose_estimation_tpu_torch.ops import (
    SBPHeatmapGenerator, sbp_heatmaps, sbp_heatmaps_batch)

OUT = (64, 48)
ODD = (63, 47)  # H*W % 4 != 0: maps off 16-byte boundaries on the card


def _joints(seed, b=4, k=17):
    """Random joints with ~30% invisible, plus the map's edges: corners,
    coordinates past the map (clipped), fractional ones just inside, and
    negatives on one axis only (invisible)."""
    rng = np.random.RandomState(seed)
    j = rng.uniform(-10, 70, size=(b, k, 2)).astype(np.float32)
    j[rng.rand(b, k) < 0.3] = -1
    edges = np.array([[0, 0], [47, 63], [47.9, 63.9], [48.5, 64.5],
                      [100, 2], [0.5, 63.5], [-0.5, 10], [10, -3],
                      [0, 0.99]], np.float32)
    n = min(k, len(edges))
    j[0, :n] = edges[:n]
    return j


@pytest.mark.parametrize("sigma,out", [
    pytest.param(2.0, OUT, id="2.0"), pytest.param(1.5, OUT, id="1.5"),
    pytest.param(2.0, ODD, id="2.0-63x47"),
    pytest.param(1.5, ODD, id="1.5-63x47")])
def test_heatmaps_match_jax_pallas_and_xla(sigma, out):
    joints = _joints(int(sigma * 10))
    got = sbp_heatmaps_batch(torch.from_numpy(joints), out, 17, sigma)
    assert got.shape == (4, 17) + out and got.dtype == torch.float32
    got = got.numpy()
    pallas = np.asarray(sbp_heatmaps_pallas(jnp.asarray(joints), out, sigma))
    xla = np.asarray(jax.vmap(
        lambda j: jax_sbp_heatmaps(j, out, 17, sigma))(jnp.asarray(joints)))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-6)
    # the edge joints stamp (clipped centers) or stay empty (invisible)
    assert got[0, 2].max() > 0.5 and got[0, 3].max() > 0.5
    assert got[0, 6].max() == 0.0 and got[0, 7].max() == 0.0


def test_half_to_even_window_rounding():
    """sigma=1.5 puts the window bound c-3s-1 on x.5: round-half-even and
    round-half-away differ there, and so would the stamp's first column."""
    joints = np.array([[[10.0, 20.0], [11.0, 21.0]]], np.float32)
    got = sbp_heatmaps_batch(torch.from_numpy(joints), OUT, 2, 1.5).numpy()
    want = np.asarray(sbp_heatmaps_pallas(jnp.asarray(joints), OUT, 1.5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # center 10: round(4.5) = 4 (half-even), window starts at column 4
    assert got[0, 0, 20, 4] > 0 and got[0, 0, 20, 3] == 0
    # center 11: round(5.5) = 6, window starts at column 6
    assert got[0, 1, 21, 6] > 0 and got[0, 1, 21, 5] == 0


def test_generator_single_and_batch():
    joints = _joints(7, b=2, k=5)
    gen = SBPHeatmapGenerator(OUT, 5)  # sigma -1 -> output_res[0] / 64
    assert gen.sigma == 1.0
    batch = gen.batch(joints).numpy()
    single = np.stack([gen(j).numpy() for j in joints])
    np.testing.assert_array_equal(batch, single)
    np.testing.assert_array_equal(
        single[1], sbp_heatmaps(torch.from_numpy(joints[1]), OUT, 5,
                                1.0).numpy())
    want = np.asarray(sbp_heatmaps_pallas(jnp.asarray(joints), OUT, 1.0))
    np.testing.assert_allclose(batch, want, rtol=0, atol=1e-6)


def test_sbp_loss_matches_jax():
    """NCHW in the port, NHWK in JAX; rtol 1e-5 for fp32 sums over
    4*17*64*48 terms taken in another order."""
    joints = _joints(11)
    target = sbp_heatmaps_batch(torch.from_numpy(joints), OUT, 17, 2.0)
    logits = torch.from_numpy(
        (np.random.RandomState(12).randn(4, 17, *OUT) * 2).astype(np.float32))
    nhwk = [jnp.asarray(np.transpose(t.numpy(), (0, 2, 3, 1)))
            for t in (logits, target)]
    per = sbp_loss_per_sample(logits, target).numpy()
    np.testing.assert_allclose(
        per, np.asarray(jax_sbp_loss_per_sample(*nhwk)), rtol=1e-5)
    np.testing.assert_allclose(float(sbp_loss(logits, target)),
                               float(jax_sbp_loss(*nhwk)), rtol=1e-5)
    np.testing.assert_allclose(float(sbp_loss(logits, target)), per.mean(),
                               rtol=1e-6)
