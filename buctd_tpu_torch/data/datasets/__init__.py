"""Dataset registry keyed by cfg.DATASET.DATASET (buctd_tpu/data/datasets/,
the reference's lib/dataset/__init__.py:5-10)."""

from .coco import COCODataset
from .crowdpose import CrowdPoseDataset
from .fish import FishDataset
from .marmosets import MarmosetsDataset
from .multimouse import MultiMouseDataset
from .ochuman import OCHumanDataset

_REGISTRY = {
    "coco": COCODataset,
    "crowdpose": CrowdPoseDataset,
    "ochuman": OCHumanDataset,
    "multimouse": MultiMouseDataset,
    "fish": FishDataset,
    "marmosets": MarmosetsDataset,
}


def get_dataset(cfg, image_dir=None, annotation_file=None, is_train=False):
    name = cfg.DATASET.DATASET
    if name not in _REGISTRY:
        raise KeyError(f"unknown DATASET.DATASET {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg, image_dir, annotation_file, is_train)


__all__ = ["get_dataset", "COCODataset", "CrowdPoseDataset", "OCHumanDataset",
           "MultiMouseDataset", "FishDataset", "MarmosetsDataset"]
