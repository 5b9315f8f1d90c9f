"""OCHuman (COCO-17 skeleton; evaluated through COCO's path):
lib/dataset/ochuman.py:17-97 (buctd_tpu/data/datasets/ochuman.py)."""

from __future__ import annotations

from .coco import COCODataset


class OCHumanDataset(COCODataset):
    pass
