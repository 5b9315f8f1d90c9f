"""COCO keypoints (17 joints): constants of lib/dataset/coco.py:45-69
(buctd_tpu/data/datasets/coco.py)."""

from __future__ import annotations

import numpy as np

from ..dataloader import CocoStyleDataset

COCO_OKS_SIGMAS = np.array([.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
                            1.07, 1.07, .87, .87, .89, .89]) / 10.0


class COCODataset(CocoStyleDataset):
    oks_sigmas = COCO_OKS_SIGMAS
    flip_pairs = [[1, 2], [3, 4], [5, 6], [7, 8],
                  [9, 10], [11, 12], [13, 14], [15, 16]]
    upper_body_ids = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)
    lower_body_ids = (11, 12, 13, 14, 15, 16)
    joints_weight = np.array(
        [1., 1., 1., 1., 1., 1., 1., 1.2, 1.2,
         1.5, 1.5, 1., 1., 1.2, 1.2, 1.5, 1.5], np.float32).reshape((17, 1))
