"""Keypoint and skeleton plotting (counterpart of the repository's tools/vis.py):
keeps the reference's import surface (``from vis import plot_keypoints``); the
implementation is buctd_tpu_torch/utils/skeletons.py."""

from ..utils.skeletons import (COCO_KEYPOINT_ORDER, COCO_SKELETON, CROWDPOSE_KEYPOINT_ORDER,
                               CROWDPOSE_SKELETON, plot_keypoints)

__all__ = ["plot_keypoints", "COCO_SKELETON", "CROWDPOSE_SKELETON",
           "COCO_KEYPOINT_ORDER", "CROWDPOSE_KEYPOINT_ORDER"]
