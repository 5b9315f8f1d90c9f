"""COCO skeleton rendering (reference: lib/utils/vis_coco.py).

The port's copy of buctd_tpu/utils/vis_coco.py, the same surface:
COCO_KP_ORDER / kp_connections / coco_vis_keypoints / vis_keypoints.  The
line colours are matplotlib's 'rainbow' colormap at evenly spaced points,
read from the 256-entry table of data/joints_dataset.py::_rainbow (matplotlib
is not needed).  The reference's vis_keypoints stops in a leftover
pdb.set_trace() (vis_coco.py:131); neither package keeps it.
"""

from __future__ import annotations

import numpy as np

from ..data.joints_dataset import _rainbow

COCO_KP_ORDER = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle"]


def kp_connections(keypoints):
    idx = keypoints.index
    return [
        [idx("left_eye"), idx("right_eye")], [idx("left_eye"), idx("nose")],
        [idx("right_eye"), idx("nose")], [idx("right_eye"), idx("right_ear")],
        [idx("left_eye"), idx("left_ear")],
        [idx("right_shoulder"), idx("right_elbow")],
        [idx("right_elbow"), idx("right_wrist")],
        [idx("left_shoulder"), idx("left_elbow")],
        [idx("left_elbow"), idx("left_wrist")],
        [idx("right_hip"), idx("right_knee")],
        [idx("right_knee"), idx("right_ankle")],
        [idx("left_hip"), idx("left_knee")],
        [idx("left_knee"), idx("left_ankle")],
        [idx("right_shoulder"), idx("left_shoulder")],
        [idx("right_hip"), idx("left_hip")],
    ]


COCO_KP_CONNECTIONS = kp_connections(COCO_KP_ORDER)


def rainbow_lookup(x) -> np.ndarray:
    """matplotlib's ``colormaps["rainbow"](x)[..., :3]`` for x in [0, 1]: the
    entry int(x * 256) (the last one at x = 1) of the 256-entry table."""
    lut = _rainbow(np.linspace(0.0, 1.0, 256))
    return lut[np.clip((np.asarray(x, np.float64) * 256).astype(int), 0, 255)]


def vis_keypoints(img, kps, kp_thresh=-1, alpha=0.7, line_thickness=6):
    """Draw a COCO skeleton on a BGR image.  kps: (3, 17) rows (x, y, conf)."""
    import cv2

    kps = np.asarray(kps, np.float64)
    kp_lines = COCO_KP_CONNECTIONS
    colors = [(c[2] * 255, c[1] * 255, c[0] * 255)
              for c in rainbow_lookup(np.linspace(0, 1, len(kp_lines) + 2))]

    kp_mask = np.copy(img)
    names = COCO_KP_ORDER

    def pt(v):
        return int(round(float(v[0]))), int(round(float(v[1])))

    mid_shoulder = (kps[:2, names.index("right_shoulder")]
                    + kps[:2, names.index("left_shoulder")]) / 2.0
    sc_mid_shoulder = min(kps[2, names.index("right_shoulder")],
                          kps[2, names.index("left_shoulder")])
    mid_hip = (kps[:2, names.index("right_hip")]
               + kps[:2, names.index("left_hip")]) / 2.0
    sc_mid_hip = min(kps[2, names.index("right_hip")],
                     kps[2, names.index("left_hip")])
    nose = names.index("nose")

    if sc_mid_shoulder > kp_thresh and kps[2, nose] > kp_thresh:
        cv2.line(kp_mask, pt(mid_shoulder), pt(kps[:2, nose]),
                 color=colors[len(kp_lines)], thickness=line_thickness,
                 lineType=cv2.LINE_AA)
    if sc_mid_shoulder > kp_thresh and sc_mid_hip > kp_thresh:
        cv2.line(kp_mask, pt(mid_shoulder), pt(mid_hip),
                 color=colors[len(kp_lines) + 1], thickness=line_thickness,
                 lineType=cv2.LINE_AA)
    for li, (i1, i2) in enumerate(kp_lines):
        if kps[2, i1] > kp_thresh and kps[2, i2] > kp_thresh:
            cv2.line(kp_mask, pt(kps[:2, i1]), pt(kps[:2, i2]),
                     color=colors[li], thickness=line_thickness,
                     lineType=cv2.LINE_AA)
        if kps[2, i1] > kp_thresh:
            cv2.circle(kp_mask, pt(kps[:2, i1]), radius=3, color=colors[li],
                       thickness=-1, lineType=cv2.LINE_AA)
        if kps[2, i2] > kp_thresh:
            cv2.circle(kp_mask, pt(kps[:2, i2]), radius=3, color=colors[li],
                       thickness=-1, lineType=cv2.LINE_AA)

    return cv2.addWeighted(img, 1.0 - alpha, kp_mask, alpha, 0)


def coco_vis_keypoints(image, kps, alpha=0.7):
    """RGB image + (17, 3) kps -> RGB image with skeleton (vis_coco.py:112-120)."""
    bgr = np.ascontiguousarray(image[:, :, ::-1])
    out = vis_keypoints(bgr, np.asarray(kps).T, kp_thresh=-1, alpha=alpha)
    return out[:, :, ::-1]
