"""COCO keypoint OKS evaluation in pure NumPy.

A copy of pytorch_pose_estimation_tpu/eval/cocoeval.py: the port imports
nothing of the JAX package, whose __init__ imports jax.

The reference scores with pycocotools' COCOeval "keypoints" mode
(reference: utils/sbp_utils.py:166-189); that C/Python package is not part
of this framework, so the published OKS-AP algorithm is implemented here
from its specification with the same parameters and matching rules:

* OKS(dt, gt) = mean over labeled keypoints of exp(-d_i^2 / (2 s^2 k_i^2)),
  with k_i = 2*sigma_i (the published per-keypoint constants) and s^2 the
  ground-truth annotation area; unlabeled-gt fallback measures distance to
  the doubled gt box.
* Greedy matching per OKS threshold in detection-score order; already
  matched gts are skipped (crowds can be re-matched); ignored gts only
  match after all non-ignored fail; detections matched to ignored gts or
  outside the area range are ignored rather than counted as FPs.
* Precision/recall accumulated over 10 OKS thresholds (.5:.05:.95),
  101 recall points, maxDets=20, area ranges all/medium/large.
* ``stats`` mirrors COCOeval.stats for keypoints; stats[1] = AP@OKS=.50.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..data.coco import COCO_KPT_SIGMAS, CocoAnnotations


class KeypointEvaluator:
    """OKS keypoint AP evaluator over a CocoAnnotations GT + results pair."""

    def __init__(self, coco_gt: CocoAnnotations, coco_dt: CocoAnnotations,
                 sigmas: Optional[np.ndarray] = None):
        self.gt = coco_gt
        self.dt = coco_dt
        self.sigmas = np.asarray(sigmas if sigmas is not None
                                 else COCO_KPT_SIGMAS, np.float64)
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        self.max_dets = 20
        self.area_rngs = [(0.0, 1e5 ** 2), (32 ** 2, 96 ** 2),
                          (96 ** 2, 1e5 ** 2)]
        self.area_lbls = ["all", "medium", "large"]
        self.img_ids: List[int] = sorted(self.gt.get_img_ids())
        self.cat_ids: List[int] = sorted(self.gt.get_cat_ids())
        self.stats: Optional[np.ndarray] = None
        self._eval_imgs: Dict = {}
        self.precision = None
        self.recall = None

    # ------------------------------------------------------------------
    def _collect(self, coco: CocoAnnotations, img_id: int, cat_id: int):
        anns = [coco.anns[a] for a in coco.get_ann_ids(img_id)]
        return [a for a in anns if a.get("category_id") == cat_id]

    def _oks(self, dts: List[dict], gts: List[dict]) -> np.ndarray:
        k = len(self.sigmas)
        variances = (self.sigmas * 2.0) ** 2
        ious = np.zeros((len(dts), len(gts)), np.float64)
        for j, g in enumerate(gts):
            gk = np.asarray(g["keypoints"], np.float64)
            xg, yg, vg = gk[0::3], gk[1::3], gk[2::3]
            labeled = vg > 0
            k1 = int(np.count_nonzero(labeled))
            bb = g["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            for i, d in enumerate(dts):
                dk = np.asarray(d["keypoints"], np.float64)
                xd, yd = dk[0::3], dk[1::3]
                if k1 > 0:
                    dx, dy = xd - xg, yd - yg
                else:
                    z = np.zeros(k)
                    dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                    dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
                e = (dx ** 2 + dy ** 2) / variances / \
                    (g["area"] + np.spacing(1)) / 2.0
                if k1 > 0:
                    e = e[labeled]
                ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
        return ious

    def _evaluate_img(self, gts: List[dict], dts: List[dict],
                      ious: np.ndarray, area_rng) -> Optional[dict]:
        if not gts and not dts:
            return None
        for g in gts:
            out_of_rng = g["area"] < area_rng[0] or g["area"] > area_rng[1]
            g["_ignore"] = 1 if (g.get("_base_ignore", 0) or out_of_rng) else 0

        gt_order = np.argsort([g["_ignore"] for g in gts], kind="stable")
        gts = [gts[i] for i in gt_order]
        dt_order = np.argsort([-d["score"] for d in dts], kind="stable")
        dts = [dts[i] for i in dt_order[: self.max_dets]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts]
        ious = ious[:, gt_order] if ious.size else ious

        T, G, D = len(self.iou_thrs), len(gts), len(dts)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gt_ig = np.array([g["_ignore"] for g in gts], np.float64)
        dt_ig = np.zeros((T, D))
        if ious.size:
            for t_i, thr in enumerate(self.iou_thrs):
                for d_i, d in enumerate(dts):
                    best = min(thr, 1.0 - 1e-10)
                    match = -1
                    for g_i in range(G):
                        if gtm[t_i, g_i] > 0 and not iscrowd[g_i]:
                            continue
                        # gts are sorted non-ignored first; once a valid
                        # match exists, stop at the ignored tail
                        if match > -1 and gt_ig[match] == 0 and gt_ig[g_i] == 1:
                            break
                        if ious[d_i, g_i] < best:
                            continue
                        best = ious[d_i, g_i]
                        match = g_i
                    if match == -1:
                        continue
                    dt_ig[t_i, d_i] = gt_ig[match]
                    dtm[t_i, d_i] = gts[match]["id"]
                    gtm[t_i, match] = d["id"]
        out_of_rng = np.array(
            [d["area"] < area_rng[0] or d["area"] > area_rng[1] for d in dts]
        )
        if D:
            dt_ig = np.logical_or(
                dt_ig, np.logical_and(dtm == 0, np.tile(out_of_rng, (T, 1)))
            )
        return {
            "dtMatches": dtm,
            "dtScores": np.array([d["score"] for d in dts], np.float64),
            "gtIgnore": gt_ig,
            "dtIgnore": dt_ig,
        }

    # ------------------------------------------------------------------
    def evaluate(self) -> None:
        # base ignore flag: explicit 'ignore' or zero labeled keypoints
        for coco_gts in (self.gt,):
            for a in coco_gts.anns.values():
                kp = np.asarray(a.get("keypoints", []), np.float64)
                n_lab = int(np.count_nonzero(kp[2::3] > 0)) if kp.size else 0
                a["num_keypoints"] = a.get("num_keypoints", n_lab)
                a["_base_ignore"] = 1 if (a.get("ignore", 0)
                                          or a["num_keypoints"] == 0
                                          or a.get("iscrowd", 0)) else 0
                if "area" not in a:
                    bb = a.get("bbox", [0, 0, 0, 0])
                    a["area"] = bb[2] * bb[3]

        self._eval_imgs = {}
        for cat_id in self.cat_ids:
            for img_id in self.img_ids:
                gts = self._collect(self.gt, img_id, cat_id)
                dts = self._collect(self.dt, img_id, cat_id)
                dts = sorted(dts, key=lambda d: -d["score"])[: self.max_dets]
                ious = self._oks(dts, gts)
                for a_i, rng in enumerate(self.area_rngs):
                    self._eval_imgs[(cat_id, img_id, a_i)] = \
                        self._evaluate_img(list(gts), list(dts), ious, rng)

    def accumulate(self) -> None:
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        K = len(self.cat_ids)
        A = len(self.area_rngs)
        precision = -np.ones((T, R, K, A))
        recall = -np.ones((T, K, A))
        for k_i, cat_id in enumerate(self.cat_ids):
            for a_i in range(A):
                evals = [self._eval_imgs.get((cat_id, i, a_i))
                         for i in self.img_ids]
                evals = [e for e in evals if e is not None]
                if not evals:
                    continue
                scores = np.concatenate([e["dtScores"] for e in evals])
                order = np.argsort(-scores, kind="stable")
                dtm = np.concatenate([e["dtMatches"] for e in evals],
                                     axis=1)[:, order]
                dt_ig = np.concatenate([e["dtIgnore"] for e in evals],
                                       axis=1)[:, order]
                gt_ig = np.concatenate([e["gtIgnore"] for e in evals])
                npig = int(np.count_nonzero(gt_ig == 0))
                if npig == 0:
                    continue
                tps = np.logical_and(dtm > 0, np.logical_not(dt_ig))
                fps = np.logical_and(dtm == 0, np.logical_not(dt_ig))
                tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                for t_i in range(T):
                    tp, fp = tp_sum[t_i], fp_sum[t_i]
                    nd = len(tp)
                    rc = tp / npig
                    pr = tp / (fp + tp + np.spacing(1))
                    recall[t_i, k_i, a_i] = rc[-1] if nd else 0
                    pr = pr.tolist()
                    # make precision monotone non-increasing from the right
                    for i in range(nd - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    q = np.zeros(R)
                    inds = np.searchsorted(rc, self.rec_thrs, side="left")
                    for r_i, p_i in enumerate(inds):
                        if p_i < nd:
                            q[r_i] = pr[p_i]
                    precision[t_i, :, k_i, a_i] = q
        self.precision = precision
        self.recall = recall

    # ------------------------------------------------------------------
    def _summ(self, ap: bool, iou_thr: Optional[float] = None,
              area: str = "all") -> float:
        a_i = self.area_lbls.index(area)
        if ap:
            s = self.precision[:, :, :, a_i]
            if iou_thr is not None:
                t_i = int(np.where(np.isclose(self.iou_thrs, iou_thr))[0][0])
                s = s[t_i:t_i + 1]
        else:
            s = self.recall[:, :, a_i]
            if iou_thr is not None:
                t_i = int(np.where(np.isclose(self.iou_thrs, iou_thr))[0][0])
                s = s[t_i:t_i + 1]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self, verbose: bool = True) -> np.ndarray:
        rows = [
            ("Average Precision  (AP)", True, None, "all"),
            ("Average Precision  (AP)", True, 0.5, "all"),
            ("Average Precision  (AP)", True, 0.75, "all"),
            ("Average Precision  (AP)", True, None, "medium"),
            ("Average Precision  (AP)", True, None, "large"),
            ("Average Recall     (AR)", False, None, "all"),
            ("Average Recall     (AR)", False, 0.5, "all"),
            ("Average Recall     (AR)", False, 0.75, "all"),
            ("Average Recall     (AR)", False, None, "medium"),
            ("Average Recall     (AR)", False, None, "large"),
        ]
        stats = np.zeros(len(rows))
        for i, (label, ap, thr, area) in enumerate(rows):
            stats[i] = self._summ(ap, thr, area)
            if verbose:
                thr_s = "0.50:0.95" if thr is None else f"{thr:0.2f}     "
                print(f" {label} @[ OKS={thr_s} | area={area:>6s} | "
                      f"maxDets={self.max_dets:>3d} ] = {stats[i]:0.3f}")
        self.stats = stats
        return stats

    def run(self, verbose: bool = True) -> np.ndarray:
        self.evaluate()
        self.accumulate()
        return self.summarize(verbose)


def evaluate_keypoints(gt_json: str, results, sigmas=None,
                       verbose: bool = True) -> np.ndarray:
    """Convenience wrapper: GT json path + results list/path -> stats."""
    gt = CocoAnnotations(gt_json)
    dt = gt.load_results(results)
    ev = KeypointEvaluator(gt, dt, sigmas=sigmas)
    return ev.run(verbose)
