"""Offline analysis of results jsons (buctd_tpu/analysis/)."""

from .evaluation import bin_evaluate, coco_evaluation, sort_instance_ap

__all__ = ["coco_evaluation", "bin_evaluate", "sort_instance_ap"]
