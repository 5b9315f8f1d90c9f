"""NMS family: box-IoU NMS and OKS (keypoint-similarity) NMS.

Counterpart of buctd_tpu/ops/nms.py (the port's own copy; it imports nothing
of the JAX package), itself the replacement of the reference's lib/nms package
(lib/nms/nms.py:35-200):
  * numpy host implementations with the reference's semantics (the BUCTD eval
    path is host-side and tiny per image): ``nms``, ``oks_iou``, ``oks_nms``,
    ``rescore``, ``soft_oks_nms``, ``oks_merge``;
  * ``box_nms_torch``, the greedy box NMS as a sequential scan over
    score-sorted boxes on tensors (the JAX ``box_nms_jax`` :51-89), mirroring
    the CUDA kernel's suppression rule (lib/nms/nms_kernel.cu:33-77).

COCO sigmas default as in nms.py:77.  The C++ ``native/nms.cpp`` binding
(buctd_tpu/ops/native.py) is not on the eval path and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

COCO_SIGMAS = np.array([.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
                        1.07, 1.07, .87, .87, .89, .89]) / 10.0


# ---------------------------------------------------------------------------
# box NMS
# ---------------------------------------------------------------------------

def nms(dets: np.ndarray, thresh: float) -> list:
    """Greedy box NMS over dets[N,5]=(x1,y1,x2,y2,score); +1 area convention as in
    the reference (nms.py:35-72)."""
    if dets.shape[0] == 0:
        return []
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return keep


def _box_nms_mask(dets: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy NMS as a sequential scan over score-sorted boxes (the JAX
    ``fori_loop``).  Returns a keep mask aligned with the input order."""
    order = torch.argsort(-dets[:, 4])
    boxes = dets[order, :4]
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    xx1 = torch.maximum(x1[:, None], x1[None, :])
    yy1 = torch.maximum(y1[:, None], y1[None, :])
    xx2 = torch.minimum(x2[:, None], x2[None, :])
    yy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (torch.clamp(xx2 - xx1 + 1, min=0.0) * torch.clamp(yy2 - yy1 + 1, min=0.0))
    iou = inter / (areas[:, None] + areas[None, :] - inter)
    suppress = iou > thresh                      # pairwise, sorted order

    n = dets.shape[0]
    keep = torch.zeros(n, dtype=torch.bool, device=dets.device)
    for i in range(n):
        # box i survives iff no kept earlier box suppresses it
        keep[i] = ~(keep[:i] & suppress[:i, i]).any()
    mask = torch.zeros(n, dtype=torch.bool, device=dets.device)
    mask[order] = keep
    return mask


def box_nms_torch(dets, thresh: float) -> np.ndarray:
    """Greedy box NMS on a tensor (on the tensor's device); returns kept
    indices (descending score), as buctd_tpu's ``box_nms_jax``."""
    dets = torch.as_tensor(dets, dtype=torch.float32)
    if dets.shape[0] == 0:
        return np.zeros((0,), np.int64)
    idx = np.where(_box_nms_mask(dets, float(thresh)).cpu().numpy())[0]
    scores = dets[:, 4].cpu().numpy()
    return idx[np.argsort(-scores[idx], kind="stable")]


# ---------------------------------------------------------------------------
# OKS NMS
# ---------------------------------------------------------------------------

def oks_iou(g, d, a_g, a_d, sigmas=None, in_vis_thre=None) -> np.ndarray:
    """OKS between one pose g (3J,) and d (N,3J) (nms.py:75-94).

    NB the reference's in_vis_thre mask is `list(vg>t) and list(vd>t)`, which in
    python evaluates to the SECOND operand — only the detection's visibility gates.
    Reproduced for parity.
    """
    sigmas = COCO_SIGMAS if sigmas is None else np.asarray(sigmas)
    var = (sigmas * 2) ** 2
    g = np.asarray(g, np.float64)
    if len(d) == 0:
        return np.zeros((0,))
    d = np.asarray(d, np.float64).reshape(len(d), -1)
    xg, yg = g[0::3], g[1::3]
    xd, yd, vd = d[:, 0::3], d[:, 1::3], d[:, 2::3]
    a_d = np.asarray(a_d, np.float64)
    e = ((xd - xg) ** 2 + (yd - yg) ** 2) / var / \
        (((a_g + a_d[:, None]) / 2) + np.spacing(1)) / 2
    if in_vis_thre is not None:
        mask = vd > in_vis_thre
        cnt = mask.sum(axis=1)
        s = np.where(mask, np.exp(-e), 0.0).sum(axis=1)
        return np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
    return np.exp(-e).mean(axis=1)


def oks_nms(kpts_db, thresh, sigmas=None, in_vis_thre=None) -> list:
    """Greedy OKS NMS over a list of {'score','keypoints','area'} dicts
    (nms.py:97-124)."""
    if len(kpts_db) == 0:
        return []
    scores = np.array([k["score"] for k in kpts_db])
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db])
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        ovr = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]],
                      sigmas, in_vis_thre)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return keep


def rescore(overlap, scores, thresh, type="gaussian"):
    if type == "linear":
        inds = np.where(overlap >= thresh)[0]
        scores = scores.copy()
        scores[inds] = scores[inds] * (1 - overlap[inds])
        return scores
    return scores * np.exp(-(overlap**2) / thresh)


def soft_oks_nms(kpts_db, thresh, sigmas=None, in_vis_thre=None, max_dets=20) -> np.ndarray:
    """Gaussian-rescoring soft NMS, capped at 20 dets (nms.py:161-200)."""
    if len(kpts_db) == 0:
        return []
    scores = np.array([k["score"] for k in kpts_db])
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db])
    order = scores.argsort()[::-1]
    scores = scores[order]
    keep = np.zeros(max_dets, dtype=np.intp)
    keep_cnt = 0
    while order.size > 0 and keep_cnt < max_dets:
        i = order[0]
        ovr = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]],
                      sigmas, in_vis_thre)
        order = order[1:]
        scores = rescore(ovr, scores[1:], thresh)
        tmp = scores.argsort()[::-1]
        order, scores = order[tmp], scores[tmp]
        keep[keep_cnt] = i
        keep_cnt += 1
    return keep[:keep_cnt]


def oks_merge(kpts_db_mode0, kpts_db_mode1, min_oks_thres=0.5, sigmas=None,
              in_vis_thre=None) -> list:
    """Merge mode-0 detections into mode-1 when OKS-disjoint (nms.py:127-148)."""
    if len(kpts_db_mode1) == 0:
        return kpts_db_mode0
    merged = list(kpts_db_mode1)
    kpts1 = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db_mode1])
    areas1 = np.array([k["area"] for k in kpts_db_mode1])
    for rec in kpts_db_mode0:
        ovr = oks_iou(np.asarray(rec["keypoints"]).flatten(), kpts1,
                      rec["area"], areas1, sigmas, in_vis_thre)
        if ovr.max() <= min_oks_thres:
            merged.append(rec)
    return merged
