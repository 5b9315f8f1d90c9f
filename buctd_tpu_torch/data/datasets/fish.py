"""Fish (DeepLabCut benchmark, 7 joints): lib/dataset/fish.py:25-100
(buctd_tpu/data/datasets/fish.py).  Evaluation takes a flat 0.1 as every
joint's OKS sigma (fish.py:89)."""

from __future__ import annotations

import numpy as np

from ..dataloader import CocoStyleDataset


class FishDataset(CocoStyleDataset):
    oks_sigmas = np.full(7, 0.1)
    flip_pairs = []
    upper_body_ids = (0, 1)
    lower_body_ids = (2, 3, 4, 5, 6)
    joints_weight = np.ones((7, 1), np.float32)
