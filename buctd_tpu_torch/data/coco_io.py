"""Minimal COCO annotation index — a dependency-free replacement for the pycocotools
`COCO` class surface the reference uses (lib/dataset/dataloader.py:68-125, :719-735).

The port's own copy of buctd_tpu/data/coco_io.py (pure Python): the port
imports nothing of the JAX package.

Supports: annotation files (instances/person_keypoints style), result lists
(`loadRes`, keypoint results), and the crowdpose json layout (identical schema plus a
per-image `crowdIndex`).
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict


class COCOIndex:
    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns = {}
        self.imgs = {}
        self.cats = {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, str):
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
            else:
                self.dataset = annotation_file
            self.createIndex()

    def createIndex(self):
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.imgToAnns, self.catToImgs = defaultdict(list), defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.imgToAnns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann
            if "category_id" in ann:
                self.catToImgs[ann["category_id"]].append(ann["image_id"])
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    # ---- query surface ----------------------------------------------------
    def getImgIds(self, imgIds=(), catIds=()) -> list:
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if not imgIds and not catIds:
            ids = set(self.imgs)
        else:
            ids = set(imgIds) if imgIds else set(self.imgs)
            for i, catId in enumerate(catIds):
                if i == 0 and not imgIds:
                    ids = set(self.catToImgs[catId])
                else:
                    ids &= set(self.catToImgs[catId])
        return sorted(ids)

    def getAnnIds(self, imgIds=(), catIds=(), iscrowd=None) -> list:
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if imgIds:
            anns = [a for i in imgIds for a in self.imgToAnns[i]]
        else:
            anns = list(self.anns.values())
        if catIds:
            anns = [a for a in anns if a.get("category_id") in catIds]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=(), supNms=(), catIds=()) -> list:
        cats = list(self.cats.values())
        for key, vals in (("name", _as_list(catNms)), ("supercategory", _as_list(supNms)),
                          ("id", _as_list(catIds))):
            if vals:
                cats = [c for c in cats if c.get(key) in vals]
        return [c["id"] for c in cats]

    def loadAnns(self, ids=()) -> list:
        return [self.anns[i] for i in _as_list(ids)]

    def loadImgs(self, ids=()) -> list:
        return [self.imgs[i] for i in _as_list(ids)]

    def loadCats(self, ids=()) -> list:
        return [self.cats[i] for i in _as_list(ids)]

    # ---- results ----------------------------------------------------------
    def loadRes(self, resFile) -> "COCOIndex":
        """Build an index for keypoint results (list of dicts or a json path),
        matching pycocotools COCO.loadRes keypoint semantics."""
        res = COCOIndex()
        res.dataset["images"] = [img for img in self.dataset.get("images", [])]
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = copy.deepcopy(resFile)
        assert isinstance(anns, list), "results must be a list"
        if anns and "keypoints" in anns[0]:
            res.dataset["categories"] = copy.deepcopy(self.dataset.get("categories", []))
            for i, ann in enumerate(anns):
                s = ann["keypoints"]
                x, y = s[0::3], s[1::3]
                x0, x1, y0, y1 = min(x), max(x), min(y), max(y)
                if "area" not in ann:
                    ann["area"] = (x1 - x0) * (y1 - y0)
                ann["id"] = i + 1
                if "bbox" not in ann:
                    ann["bbox"] = [x0, y0, x1 - x0, y1 - y0]
                ann.setdefault("iscrowd", 0)
        res.dataset["annotations"] = anns
        res.createIndex()
        return res


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple, set)):
        return list(x)
    return [x]
