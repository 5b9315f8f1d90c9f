"""COCO keypoint evaluation (OKS-based AP/AR) — pycocotools-compatible semantics.

The port's own copy of buctd_tpu/data/coco_eval.py (numpy only; the port
imports nothing of the JAX package).  It reimplements the keypoint branch of
COCOeval (matching IoU=OKS, 10 IoU thresholds 0.50:0.95, 101-point
interpolated precision, maxDets=20, area ranges all/medium/large) plus the
crowdposetools extension (AP over easy/medium/hard crowdIndex image bins).

This is the oracle behind DataLoader.evaluate (lib/dataset/dataloader.py:719-735) and
the crowdpose variant (lib/dataset/crowdpose.py:237-238).
"""

from __future__ import annotations

import numpy as np

from .coco_io import COCOIndex

COCO_AREA_RNGS = {
    "all": (0.0, 1e10),
    "medium": (32**2, 96**2),
    "large": (96**2, 1e10),
}

COCO_STATS_NAMES = ["AP", "Ap .5", "AP .75", "AP (M)", "AP (L)",
                    "AR", "AR .5", "AR .75", "AR (M)", "AR (L)"]
CROWDPOSE_STATS_NAMES = ["AP", "Ap .5", "AP .75", "AR", "AR .5", "AR .75",
                         "AP (E)", "AP (M)", "AP (H)"]


def compute_oks(gts: list, dts: list, sigmas: np.ndarray) -> np.ndarray:
    """OKS matrix (len(dts), len(gts)) per pycocotools computeOks."""
    if not gts or not dts:
        return np.zeros((len(dts), len(gts)))
    var = (np.asarray(sigmas) * 2) ** 2
    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = np.count_nonzero(vg > 0)
        bb = gt["bbox"]
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
                dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
            e = (dx**2 + dy**2) / var / (gt["area"] + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0.0
    return ious


class COCOKeypointEval:
    """Keypoint COCOeval with optional crowdIndex bins.

    Args:
      coco_gt / coco_dt: COCOIndex instances.
      sigmas: per-joint OKS sigmas.
      area_rngs: dict name -> (lo, hi); COCO uses all/medium/large, crowdpose all only.
      crowd_index_bins: optional dict name -> (lo, hi) over images' crowdIndex.
    """

    def __init__(self, coco_gt: COCOIndex, coco_dt: COCOIndex, sigmas,
                 area_rngs=None, max_dets: int = 20, crowd_index_bins=None,
                 iou_thrs=None):
        self.gt = coco_gt
        self.dt = coco_dt
        self.sigmas = np.asarray(sigmas, np.float64)
        self.area_rngs = dict(area_rngs if area_rngs is not None else COCO_AREA_RNGS)
        self.max_dets = max_dets
        self.crowd_index_bins = crowd_index_bins or {}
        self.iou_thrs = (np.asarray(iou_thrs) if iou_thrs is not None
                         else np.linspace(0.5, 0.95, 10))
        self.rec_thrs = np.linspace(0.0, 1.00, 101)
        self.img_ids = sorted(self.gt.getImgIds())
        cat_ids = self.gt.getCatIds(catNms=["person"]) or self.gt.getCatIds()
        self.cat_id = cat_ids[0] if cat_ids else 1
        self._eval_imgs = None

    # ------------------------------------------------------------------
    def _gather(self, img_id):
        gts = [g for g in self.gt.imgToAnns[img_id]
               if g.get("category_id", self.cat_id) == self.cat_id]
        dts = [d for d in self.dt.imgToAnns[img_id]
               if d.get("category_id", self.cat_id) == self.cat_id]
        return gts, dts

    def evaluate(self):
        T = len(self.iou_thrs)
        self._eval_imgs = {}  # (img_id, area_name) -> per-image eval dict
        for img_id in self.img_ids:
            gts, dts = self._gather(img_id)
            for g in gts:
                vis = np.asarray(g["keypoints"][2::3])
                g["_ignore"] = 1 if (g.get("ignore", 0) or g.get("iscrowd", 0)
                                     or np.count_nonzero(vis > 0) == 0) else 0
            dts = sorted(dts, key=lambda d: -d["score"])[: self.max_dets]
            ious_full = compute_oks(gts, dts, self.sigmas)

            for area_name, (lo, hi) in self.area_rngs.items():
                gt_ig = np.array([1 if (g["_ignore"] or not (lo <= g["area"] <= hi))
                                  else 0 for g in gts])
                order = np.argsort(gt_ig, kind="mergesort")
                gts_s = [gts[i] for i in order]
                gt_ig = gt_ig[order]
                ious = ious_full[:, order] if len(gts) else ious_full

                D, G = len(dts), len(gts_s)
                crowd = [g.get("iscrowd", 0) for g in gts_s]
                dtm = np.zeros((T, D))
                gtm = np.zeros((T, G))
                dt_ig = np.zeros((T, D))
                for t, thr in enumerate(self.iou_thrs):
                    for di in range(D):
                        iou = min(thr, 1 - 1e-10)
                        m = -1
                        for gi in range(G):
                            # a matched GT can't absorb another dt UNLESS it is a
                            # crowd region (pycocotools evaluateImg: 'if gtm>0 and
                            # not iscrowd: continue')
                            if gtm[t, gi] > 0 and not crowd[gi]:
                                continue
                            if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                                break
                            if ious[di, gi] < iou:
                                continue
                            iou = ious[di, gi]
                            m = gi
                        if m == -1:
                            continue
                        dt_ig[t, di] = gt_ig[m]
                        dtm[t, di] = gts_s[m]["id"]
                        gtm[t, m] = dts[di]["id"]
                # unmatched dts outside the area range are ignored
                a = np.array([not (lo <= d.get("area", 0) <= hi) for d in dts],
                             dtype=bool)
                dt_ig = np.logical_or(dt_ig, (dtm == 0) & a[None, :])
                self._eval_imgs[(img_id, area_name)] = {
                    "dt_scores": np.array([d["score"] for d in dts]),
                    "dtm": dtm,
                    "gtm": gtm,
                    "gt_ids": [g["id"] for g in gts_s],
                    "dt_ids": [d["id"] for d in dts],
                    "dt_ig": dt_ig,
                    "num_gt": int(np.count_nonzero(gt_ig == 0)),
                }
        return self

    # ------------------------------------------------------------------
    def _accumulate_subset(self, area_name: str, img_ids) -> tuple:
        """Returns (precision (T, R), recall (T,)) over an image subset."""
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        evals = [self._eval_imgs[(i, area_name)] for i in img_ids
                 if (i, area_name) in self._eval_imgs]
        if not evals:
            return -np.ones((T, R)), -np.ones(T)
        scores = np.concatenate([e["dt_scores"] for e in evals])
        order = np.argsort(-scores, kind="mergesort")
        dtm = np.concatenate([e["dtm"] for e in evals], axis=1)[:, order]
        dt_ig = np.concatenate([e["dt_ig"] for e in evals], axis=1)[:, order]
        npig = sum(e["num_gt"] for e in evals)
        if npig == 0:
            return -np.ones((T, R)), -np.ones(T)

        tps = (dtm > 0) & ~dt_ig.astype(bool)
        fps = (dtm == 0) & ~dt_ig.astype(bool)
        tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_sum = np.cumsum(fps, axis=1).astype(np.float64)

        precision = -np.ones((T, R))
        recall = -np.ones(T)
        for t in range(T):
            tp, fp = tp_sum[t], fp_sum[t]
            nd = len(tp)
            rc = tp / npig
            pr = tp / (fp + tp + np.spacing(1))
            recall[t] = rc[-1] if nd else 0.0
            pr = pr.tolist()
            # right-to-left max smoothing (pycocotools accumulate)
            for i in range(nd - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            inds = np.searchsorted(rc, self.rec_thrs, side="left")
            q = np.zeros(R)
            for ri, pi in enumerate(inds):
                if pi < nd:
                    q[ri] = pr[pi]
            precision[t] = q
        return precision, recall

    def accumulate(self):
        self.precision = {}
        self.recall = {}
        for area_name in self.area_rngs:
            self.precision[area_name], self.recall[area_name] = \
                self._accumulate_subset(area_name, self.img_ids)
        for bin_name, (lo, hi) in self.crowd_index_bins.items():
            ids = [i for i in self.img_ids
                   if lo <= self.gt.imgs[i].get("crowdIndex", 0) < hi]
            self.precision[bin_name], self.recall[bin_name] = \
                self._accumulate_subset("all", ids)
        return self

    # ------------------------------------------------------------------
    def _ap(self, area="all", iou_thr=None) -> float:
        p = self.precision[area]
        if iou_thr is not None:
            t = int(np.where(np.isclose(self.iou_thrs, iou_thr))[0][0])
            p = p[t:t + 1]
        valid = p[p > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def _ar(self, area="all", iou_thr=None) -> float:
        r = self.recall[area]
        if iou_thr is not None:
            t = int(np.where(np.isclose(self.iou_thrs, iou_thr))[0][0])
            r = r[t:t + 1]
        valid = r[r > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize_coco(self) -> list:
        """The 10 COCO keypoint stats."""
        return [
            self._ap("all"), self._ap("all", 0.5), self._ap("all", 0.75),
            self._ap("medium"), self._ap("large"),
            self._ar("all"), self._ar("all", 0.5), self._ar("all", 0.75),
            self._ar("medium"), self._ar("large"),
        ]

    def summarize_crowdpose(self) -> list:
        """AP/AR + easy/medium/hard crowdIndex bins (crowdposetools layout)."""
        return [
            self._ap("all"), self._ap("all", 0.5), self._ap("all", 0.75),
            self._ar("all"), self._ar("all", 0.5), self._ar("all", 0.75),
            self._ap("easy"), self._ap("medium"), self._ap("hard"),
        ]

    def summarize(self) -> list:
        """crowdpose layout when crowdIndex bins are configured, COCO otherwise."""
        return (self.summarize_crowdpose() if self.crowd_index_bins
                else self.summarize_coco())
