"""Dataset registry keyed by cfg.DATASET.DATASET (buctd_tpu/data/datasets/).

The port has the human-pose datasets BUCTD's CoAM configs train on; the
others (ochuman, multimouse, fish, marmosets) raise and name their ROADMAP
item.
"""

from .coco import COCODataset
from .crowdpose import CrowdPoseDataset

_REGISTRY = {"coco": COCODataset, "crowdpose": CrowdPoseDataset}
_NOT_PORTED = ("ochuman", "multimouse", "fish", "marmosets")


def get_dataset(cfg, image_dir=None, annotation_file=None, is_train=False):
    name = cfg.DATASET.DATASET
    if name in _NOT_PORTED:
        raise NotImplementedError(f"DATASET.DATASET {name!r} is not ported to "
                                  "buctd_tpu_torch yet: ROADMAP Queue 1 item 7")
    if name not in _REGISTRY:
        raise KeyError(f"unknown DATASET.DATASET {name!r}; known: "
                       f"{sorted(_REGISTRY) + list(_NOT_PORTED)}")
    return _REGISTRY[name](cfg, image_dir, annotation_file, is_train)


__all__ = ["get_dataset", "COCODataset", "CrowdPoseDataset"]
