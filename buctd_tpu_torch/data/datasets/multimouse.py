"""Multi-mouse (DeepLabCut benchmark, 12 joints): lib/dataset/multimouse.py:36-108
(buctd_tpu/data/datasets/multimouse.py).  Evaluation takes a flat 0.1 as every
joint's OKS sigma (multimouse.py:97)."""

from __future__ import annotations

import numpy as np

from ..dataloader import CocoStyleDataset


class MultiMouseDataset(CocoStyleDataset):
    oks_sigmas = np.full(12, 0.1)
    flip_pairs = [[1, 2]]
    upper_body_ids = (0, 1, 2, 3, 4, 6)
    lower_body_ids = (7, 8, 9, 10, 11)
    joints_weight = np.ones((12, 1), np.float32)
