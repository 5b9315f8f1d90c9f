"""Qualitative per-bin analysis (reference: lib/analysis/qualitative_evaluation.py).

The port's copy of buctd_tpu/analysis/qualitative_evaluation.py.  Match GT<->DT per occlusion bin, rank by OKS, and render side-by-side GT/pred
skeleton images for the worst (or best) instances.

GT<->DT matching follows the reference (qualitative_evaluation.py:31-180): run a
keypoint COCOeval over the full results json and pair each GT with the detection
``gtMatches`` credited to it at IoU 0.5 — so ANY standard COCO results json works.
When dataset.evaluate wrote the json, entries additionally carry an ``annotation_id``
(the GT instance each crop was conditioned on); that exact pairing is preferred
because it also pairs detections COCOeval rejected (OKS < 0.5), which is where
the worst cases live.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..data.coco_eval import COCOKeypointEval, compute_oks
from ..data.coco_io import COCOIndex
from ..data.datasets.coco import COCO_OKS_SIGMAS
from .evaluation import NUM_KPT_GROUPS, OVERLAP_GROUPS, check_valid_annotations


def match_gt_to_dt(coco_gt, dt_anns, sigmas=COCO_OKS_SIGMAS) -> dict:
    """{gt_ann_id: dt dict or None} via COCOeval gtMatches at IoU 0.5
    (the reference's matched_annotation_dict, qualitative_evaluation.py:71-88)."""
    coco_dt = coco_gt.loadRes(dt_anns)
    ev = COCOKeypointEval(coco_gt, coco_dt, np.asarray(sigmas)).evaluate()
    matches = ev.gt_matches(iou_index=0)
    return {gt_id: (coco_dt.anns[dt_id] if dt_id else None)
            for gt_id, dt_id in matches.items()}


def binwise_coco_evaluation(gt_file, dt_file, image_dir, output_dir,
                            sigmas=COCO_OKS_SIGMAS, worst_k=20):
    """Dump the ``worst_k`` lowest-OKS instances of every (overlap, #kpt) bin
    (qualitative_evaluation.py:31).  Unmatched GTs render with an empty
    prediction panel (the reference draws all-zero keypoints for
    ``matched_annotation_dt is None``, qualitative_evaluation.py:196-199)."""
    coco_gt = COCOIndex(gt_file)
    with open(dt_file) as f:
        dts = json.load(f)
    dt_by_ann = {}
    for d in dts:
        if "annotation_id" in d:
            dt_by_ann[d["annotation_id"]] = d
    if not dt_by_ann:    # third-party results json: COCOeval-based pairing
        dt_by_ann = match_gt_to_dt(coco_gt, dts, sigmas)

    for i, og in enumerate(OVERLAP_GROUPS):
        for j, ng in enumerate(NUM_KPT_GROUPS):
            ann_ids = []
            for image_id in coco_gt.getImgIds():
                a, _ = check_valid_annotations(coco_gt, image_id, og, ng)
                ann_ids.extend(a)

            scored = []
            for ann_id in ann_ids:
                dt = dt_by_ann.get(ann_id)
                gt = coco_gt.anns[ann_id]
                oks = (float(compute_oks([gt], [dt], np.asarray(sigmas))[0, 0])
                       if dt is not None else 0.0)
                scored.append((oks, gt, dt))
            scored.sort(key=lambda t: t[0])

            bin_dir = os.path.join(output_dir, f"overlap{i}_kpts{j}")
            os.makedirs(bin_dir, exist_ok=True)
            for rank, (oks, gt, dt) in enumerate(scored[:worst_k]):
                save_detections(coco_gt, gt, dt, image_dir, bin_dir, rank, oks)


def save_detections(coco_gt, gt_ann, dt_ann, image_dir, out_dir, rank, oks):
    """GT skeleton | predicted skeleton, side by side
    (qualitative_evaluation.py:183)."""
    import cv2

    from ..utils.skeletons import plot_keypoints

    info = coco_gt.imgs[gt_ann["image_id"]]
    path = os.path.join(image_dir, info["file_name"])
    img = cv2.imread(path)
    if img is None:
        return
    J = len(gt_ann["keypoints"]) // 3
    dataset = "crowdpose" if J == 14 else "coco"
    gt_img = plot_keypoints(
        img.copy(), np.array(gt_ann["keypoints"]).reshape(-1, 3)[:, :2],
        dataset=dataset, color=(0, 255, 0))
    # unmatched GT: all-zero prediction keypoints, as the reference renders
    # (qualitative_evaluation.py:196-199)
    dt_kpts = (np.array(dt_ann["keypoints"]) if dt_ann is not None
               else np.zeros(J * 3))
    dt_img = plot_keypoints(
        img.copy(), dt_kpts.reshape(-1, 3)[:, :2],
        dataset=dataset, color=(0, 0, 255))
    side = np.concatenate([gt_img, dt_img], axis=1)
    cv2.imwrite(os.path.join(
        out_dir, f"rank{rank:03d}_oks{oks:.3f}_ann{gt_ann['id']}.jpg"), side)
