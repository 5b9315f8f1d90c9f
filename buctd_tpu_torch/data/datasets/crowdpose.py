"""CrowdPose (14 joints): constants of lib/dataset/crowdpose.py:25-70
(buctd_tpu/data/datasets/crowdpose.py)."""

from __future__ import annotations

import numpy as np

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
