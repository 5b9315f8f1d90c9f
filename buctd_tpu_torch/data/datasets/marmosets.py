"""Marmosets (DeepLabCut benchmark, 15 joints): lib/dataset/marmosets.py:35-108
(buctd_tpu/data/datasets/marmosets.py).  Evaluation takes a flat 0.1 as every
joint's OKS sigma (marmosets.py:97)."""

from __future__ import annotations

import numpy as np

from ..dataloader import CocoStyleDataset


class MarmosetsDataset(CocoStyleDataset):
    oks_sigmas = np.full(15, 0.1)
    flip_pairs = [[1, 3], [4, 6], [5, 7], [8, 9], [10, 11]]
    upper_body_ids = (0, 1, 2, 3, 4, 6, 10, 11, 12)
    lower_body_ids = (5, 7, 8, 9, 13, 14)
    joints_weight = np.ones((15, 1), np.float32)
