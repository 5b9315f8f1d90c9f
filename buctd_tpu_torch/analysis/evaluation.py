"""Occlusion-binned benchmark analysis (reference: lib/analysis/evaluation.py).

The port's copy of buctd_tpu/analysis/evaluation.py (numpy only, on the
port's data/coco_io.py and data/coco_eval.py).  AP over bins of (#overlapping instances x #keypoints) by trimming GT/DT to each bin
and re-running COCOeval — the analysis behind the paper's crowd-robustness claims.
The reference's version depends on a missing ``utilities`` module (evaluation.py:14)
and is partially broken offline; this one is self-contained on COCOIndex /
COCOKeypointEval.

Bins (evaluation.py:32-33):
  overlap groups: [0], [1,2], [3..8]   (IoU > 0.1 counts as overlapping)
  num-kpt groups: <=5, <=10, <=15, >15
"""

from __future__ import annotations

import copy
import json

import numpy as np

from ..data.coco_eval import COCO_STATS_NAMES, COCOKeypointEval
from ..data.coco_io import COCOIndex
from ..data.datasets.coco import COCO_OKS_SIGMAS

OVERLAP_GROUPS = [[0], [1, 2], [3, 4, 5, 6, 7, 8]]
NUM_KPT_GROUPS = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10],
                  [11, 12, 13, 14, 15], [16, 17]]
IOU_FOR_OVERLAP = 0.1


def _box_ious(annotations) -> np.ndarray:
    """Pairwise xywh IoU matrix over clean_bbox."""
    n = len(annotations)
    out = np.zeros((n, n))
    boxes = np.array([a["clean_bbox"] for a in annotations], np.float64) \
        if n else np.zeros((0, 4))
    for i in range(n):
        for j in range(n):
            x1, y1, w1, h1 = boxes[i]
            x2, y2, w2, h2 = boxes[j]
            xo = max(0, min(x1 + w1, x2 + w2) - max(x1, x2))
            yo = max(0, min(y1 + h1, y2 + h2) - max(y1, y2))
            inter = xo * yo
            union = w1 * h1 + w2 * h2 - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def check_valid_annotations(coco: COCOIndex, image_id, num_overlaps_group,
                            num_keypoints_group, iou_for_overlap=IOU_FOR_OVERLAP):
    """(valid annotation ids, valid image ids) for one image
    (evaluation.py:132-178)."""
    anns = coco.loadAnns(coco.getAnnIds(imgIds=image_id))
    info = coco.loadImgs(image_id)[0]
    width, height = info["width"], info["height"]

    valid = []
    for obj in anns:
        if max(obj["keypoints"]) == 0:
            continue
        x, y, w, h = obj["bbox"]
        x1, y1 = max(0, x), max(0, y)
        x2 = min(width - 1, x1 + max(0, w - 1))
        y2 = min(height - 1, y1 + max(0, h - 1))
        if obj.get("area", 0) > 0 and x2 >= x1 and y2 >= y1:
            obj["clean_bbox"] = [x1, y1, x2 - x1, y2 - y1]
            valid.append(obj)

    ious = _box_ious(valid)
    eye = np.eye(len(valid))
    ann_ids, img_ids = [], []
    for i, ann in enumerate(valid):
        if "num_overlaps" in ann:
            n_overlap = int(ann["num_overlaps"])
            n_kpts = int(ann["num_keypoints"])
        else:
            n_overlap = int(np.sum((ious[i] - eye[i]) > iou_for_overlap))
            n_kpts = ann["num_keypoints"]
        if n_overlap in num_overlaps_group and n_kpts in num_keypoints_group:
            ann_ids.append(ann["id"])
    if ann_ids:
        img_ids.append(image_id)
    return ann_ids, img_ids


def _evaluate(coco_gt: COCOIndex, coco_dt: COCOIndex, sigmas) -> list:
    ev = COCOKeypointEval(coco_gt, coco_dt, sigmas)
    ev.evaluate()
    ev.accumulate()
    stats = ev.summarize_coco()
    return list(zip(COCO_STATS_NAMES, stats))


def bin_evaluate(coco_gt: COCOIndex, coco_dt_file, overlap_group, num_kpt_group,
                 sigmas=COCO_OKS_SIGMAS) -> dict:
    """AP/AR over one (overlap, num-kpt) bin by trimming GT + DT
    (evaluation.py:86-129).  DT entries are matched by 'annotation_id' when present
    (the results jsons of dataset.evaluate carry it), else kept per-image."""
    valid_ann_ids, valid_img_ids = [], []
    for image_id in coco_gt.getImgIds():
        a, m = check_valid_annotations(coco_gt, image_id, overlap_group,
                                       num_kpt_group)
        valid_ann_ids.extend(a)
        valid_img_ids.extend(m)
    valid_ann_set = set(valid_ann_ids)

    bin_gt = COCOIndex({**copy.deepcopy(coco_gt.dataset),
                        "annotations": [copy.deepcopy(coco_gt.anns[i])
                                        for i in valid_ann_ids],
                        "images": [coco_gt.imgs[i] for i in valid_img_ids]})

    if isinstance(coco_dt_file, str):
        with open(coco_dt_file) as f:
            dt_anns = json.load(f)
    else:
        dt_anns = copy.deepcopy(coco_dt_file)
    dt_anns = [d for d in dt_anns
               if d.get("annotation_id", None) in valid_ann_set
               or ("annotation_id" not in d and d["image_id"] in set(valid_img_ids))]
    bin_dt = bin_gt.loadRes(dt_anns)

    info = _evaluate(bin_gt, bin_dt, sigmas)
    out = {"num_instances": len(valid_ann_ids)}
    for name, val in info:
        out[name] = round(float(val), 3)
    return out


def coco_evaluation(gt_file, dt_file, output_dir=None, sigmas=COCO_OKS_SIGMAS,
                    make_plots=False) -> dict:
    """Full-matrix binned benchmark (evaluation.py:25-78).  Returns
    {stat_name: (n_overlap_bins, n_kpt_bins) matrix}; optionally writes the
    reference's heatmap-matrix PDFs."""
    coco_gt = COCOIndex(gt_file)

    all_stats = {"num_instances": np.zeros((len(OVERLAP_GROUPS), len(NUM_KPT_GROUPS)))}
    for name in COCO_STATS_NAMES:
        all_stats[name] = np.zeros((len(OVERLAP_GROUPS), len(NUM_KPT_GROUPS)))

    for i, og in enumerate(OVERLAP_GROUPS):
        for j, ng in enumerate(NUM_KPT_GROUPS):
            bin_info = bin_evaluate(coco_gt, dt_file, og, ng, sigmas)
            for name, val in bin_info.items():
                all_stats[name][i, j] = val

    if make_plots and output_dir:
        _plot_matrices(all_stats, output_dir)
    return all_stats


def _plot_matrices(all_stats: dict, output_dir: str):
    """Heatmap-matrix PDFs (evaluation.py:54-78).  matplotlib is imported here
    only: the one optional import of the analysis."""
    from itertools import cycle

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cmaps = cycle([plt.cm.Greens, plt.cm.Blues, plt.cm.YlOrBr, plt.cm.RdPu,
                   plt.cm.YlOrRd, plt.cm.Reds, plt.cm.PuRd, plt.cm.BuPu,
                   plt.cm.PuBu])
    for stat_name, mat in all_stats.items():
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(111)
        ax.set_aspect(1)
        ax.imshow(mat, cmap=next(cmaps), interpolation="nearest")
        for x in range(mat.shape[0]):
            for y in range(mat.shape[1]):
                ax.annotate(f"{mat[x, y]}", xy=(y, x), ha="center", va="center",
                            fontsize=20)
        plt.xticks(range(mat.shape[1]), ["<=5", "<=10", "<=15", ">15"])
        plt.yticks(range(mat.shape[0]), ["0", "1/2", ">=3"])
        plt.title(stat_name, fontsize=20)
        plt.xlabel("Num. keypoints", fontsize=20)
        plt.ylabel("Num. overlapping instances", fontsize=20)
        plt.savefig(f"{output_dir}/benchmark_{stat_name}.pdf", bbox_inches="tight")
        plt.close()


def sort_instance_ap(coco_gt: COCOIndex, dt_file, sigmas=COCO_OKS_SIGMAS) -> list:
    """Per-instance OKS ranking (evaluation.py:240): for each DT matched by
    annotation_id, its best OKS against the GT instance — sorted ascending so the
    worst predictions surface first."""
    from ..data.coco_eval import compute_oks

    if isinstance(dt_file, str):
        with open(dt_file) as f:
            dts = json.load(f)
    else:
        dts = dt_file

    scored = []
    for dt in dts:
        ann_id = dt.get("annotation_id")
        if ann_id is None or ann_id not in coco_gt.anns:
            continue
        gt = coco_gt.anns[ann_id]
        oks = compute_oks([gt], [dt], np.asarray(sigmas))[0, 0]
        scored.append((float(oks), ann_id, dt))
    return sorted(scored, key=lambda t: t[0])
