"""CrowdPose (14 joints): constants of lib/dataset/crowdpose.py:25-70
(buctd_tpu/data/datasets/crowdpose.py).

Eval differences vs COCO (crowdpose.py:121-243): crowdposetools stats layout with
AP over easy/medium/hard crowdIndex bins, area range 'all' only, box area always,
and no OKS-NMS.
"""

from __future__ import annotations

import numpy as np

from ..coco_eval import CROWDPOSE_STATS_NAMES
from ..dataloader import CocoStyleDataset

CROWDPOSE_OKS_SIGMAS = np.array([.79, .79, .72, .72, .62, .62, 1.07, 1.07,
                                 .87, .87, .89, .89, .79, .79]) / 10.0


class CrowdPoseDataset(CocoStyleDataset):
    oks_sigmas = CROWDPOSE_OKS_SIGMAS
    flip_pairs = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10, 11]]
    upper_body_ids = (0, 1, 2, 3, 4, 5, 12, 13)
    lower_body_ids = (6, 7, 8, 9, 10, 11)
    joints_weight = np.array(
        [1., 1., 1.2, 1.2, 1.5, 1.5, 1., 1.,
         1.2, 1.2, 1.5, 1.5, 1., 1.], np.float32).reshape((14, 1))

    stats_names = CROWDPOSE_STATS_NAMES
    area_rngs = {"all": (0.0, 1e10)}
    crowd_index_bins = {"easy": (0.0, 0.1), "medium": (0.1, 0.8), "hard": (0.8, 1.01)}
    area_from_boxes_always = True
    use_nms = False
