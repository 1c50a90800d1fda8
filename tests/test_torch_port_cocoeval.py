"""The port's ``evaluate_keypoints`` and ``KeypointEvaluator(sigmas=...)``
against the JAX package's (eval/cocoeval.py) on the CPU: fixture GT (12
images of 1-5 persons) and numpy-seeded results that move each keypoint,
drop some persons, add false detections and score them at random.  The ten
stats agree within 1e-12 for the default and a custom sigma vector, with
the results given as a list and as a json path.  Both are plain NumPy in
float64, so anything larger is a difference of the algorithm.
"""

import json

import numpy as np
import pytest

from pytorch_pose_estimation_tpu.data.coco import \
    CocoAnnotations as JaxCocoAnnotations
from pytorch_pose_estimation_tpu.eval import cocoeval as jax_cocoeval
from pytorch_pose_estimation_tpu_torch.data.coco import (COCO_KPT_SIGMAS,
                                                         CocoAnnotations)
from pytorch_pose_estimation_tpu_torch.eval import (KeypointEvaluator,
                                                    evaluate_keypoints)

from synth_fixture import make_dataset

SIGMAS = {"default": None, "coco_x1.5": COCO_KPT_SIGMAS * 1.5}


@pytest.fixture(scope="module")
def gt_and_results(tmp_path_factory):
    """(GT json path, results list): each GT person kept with p 0.85, its
    labelled keypoints moved by N(0, 0.03 * sqrt(area)), an unlabelled one
    put anywhere in the box; one false person in every third image; scores
    uniform in (0, 1)."""
    root = tmp_path_factory.mktemp("cocoeval")
    gt_json = make_dataset(str(root), "val2017", 12, seed=5, max_persons=5)
    with open(gt_json) as f:
        db = json.load(f)
    rng = np.random.RandomState(11)
    results = []
    for ann in db["annotations"]:
        if rng.rand() > 0.85:
            continue
        kp = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
        x, y, w, h = ann["bbox"]
        step = 0.03 * np.sqrt(ann["area"])
        moved = kp[:, :2] + rng.randn(len(kp), 2) * step
        anywhere = np.stack([x + rng.rand(len(kp)) * w,
                             y + rng.rand(len(kp)) * h], 1)
        xy = np.where(kp[:, 2:] > 0, moved, anywhere)
        results.append({
            "image_id": ann["image_id"], "category_id": 1,
            "keypoints": np.concatenate(
                [xy, np.ones((len(kp), 1))], 1).ravel().tolist(),
            "score": float(rng.rand())})
    for im in db["images"][::3]:
        xy = rng.rand(17, 2) * [im["width"], im["height"]]
        results.append({
            "image_id": im["id"], "category_id": 1,
            "keypoints": np.concatenate(
                [xy, np.ones((17, 1))], 1).ravel().tolist(),
            "score": float(rng.rand())})
    return gt_json, results


@pytest.mark.parametrize("given", ["list", "json"])
@pytest.mark.parametrize("sigmas", sorted(SIGMAS))
def test_evaluate_keypoints_matches_jax(gt_and_results, tmp_path, sigmas,
                                        given):
    """``evaluate_keypoints(gt_json, results, sigmas)`` returns JAX's ten
    stats within 1e-12; the stats are not trivial (neither 0 nor 1 at
    AP@.5:.95), and the wider sigmas raise AP@.5:.95."""
    gt_json, results = gt_and_results
    if given == "json":
        path = tmp_path / "results.json"
        path.write_text(json.dumps(results))
        results = str(path)
    sig = SIGMAS[sigmas]
    got = evaluate_keypoints(gt_json, results, sigmas=sig, verbose=False)
    want = jax_cocoeval.evaluate_keypoints(gt_json, results, sigmas=sig,
                                           verbose=False)
    assert got.shape == (10,) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert 0.0 < got[0] < 1.0
    if sig is not None:
        plain = evaluate_keypoints(gt_json, results, verbose=False)
        assert got[0] > plain[0]


@pytest.mark.parametrize("sigmas", sorted(SIGMAS))
def test_keypoint_evaluator_sigmas_match_jax(gt_and_results, sigmas):
    """``KeypointEvaluator(gt, dt, sigmas=...)`` keeps the sigmas in float64
    (``None``: COCO's) and its ``run`` gives JAX's stats, precision and
    recall within 1e-12."""
    gt_json, results = gt_and_results
    sig = SIGMAS[sigmas]
    gt = CocoAnnotations(gt_json)
    ours = KeypointEvaluator(gt, gt.load_results(results), sigmas=sig)
    jgt = JaxCocoAnnotations(gt_json)
    theirs = jax_cocoeval.KeypointEvaluator(jgt, jgt.load_results(results),
                                            sigmas=sig)
    want_sigmas = COCO_KPT_SIGMAS if sig is None else sig
    assert ours.sigmas.dtype == np.float64
    np.testing.assert_array_equal(ours.sigmas, want_sigmas)
    np.testing.assert_array_equal(ours.sigmas, theirs.sigmas)
    np.testing.assert_allclose(ours.run(verbose=False),
                               theirs.run(verbose=False), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.precision, theirs.precision, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(ours.recall, theirs.recall, rtol=0,
                               atol=1e-12)
