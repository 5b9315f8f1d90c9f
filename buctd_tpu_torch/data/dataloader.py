"""COCO-style sample db (reference: lib/dataset/dataloader.py).

Counterpart of buctd_tpu/data/dataloader.py::CocoStyleDataset, the db build
only: GT annotations with their per-model 'cond_kpts' dicts, near joints and
crowding stats (``_load_annotations`` / ``_load_annotation_kernel``), which is
what training reads.  The test-time dbs (from BU predictions, pose results,
detector boxes) and ``evaluate`` / ``_rescore_and_nms`` wait for ROADMAP
Queue 1 item 7 and raise until then.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from .coco_io import COCOIndex
from .joints_dataset import JointsDataset

logger = logging.getLogger(__name__)

_EVAL_ITEM = "ROADMAP Queue 1 item 7, 'Evaluation and NMS'"


class CocoStyleDataset(JointsDataset):
    """Shared base of the COCO-format datasets (coco, crowdpose)."""

    oks_sigmas: np.ndarray = None

    def __init__(self, cfg, image_dir=None, annotation_file=None, is_train=False):
        if image_dir is None:
            image_dir = (cfg.DATASET.TRAIN_IMAGE_DIR if is_train
                         else cfg.DATASET.TEST_IMAGE_DIR)
        if annotation_file is None:
            annotation_file = (cfg.DATASET.TRAIN_ANNOTATION_FILE if is_train
                               else cfg.DATASET.TEST_ANNOTATION_FILE)
        super().__init__(cfg, image_dir, annotation_file, is_train)
        self.image_thre = cfg.TEST.IMAGE_THRE
        self.bbox_file = cfg.TEST.COCO_BBOX_FILE
        self.use_gt_bbox = cfg.TEST.USE_GT_BBOX
        self.use_bu_bbox_train = cfg.TRAIN.USE_BU_BBOX
        self.use_bu_bbox_test = cfg.TEST.USE_BU_BBOX
        self.test_gt_file = cfg.DATASET.TEST_ANNOTATION_FILE
        self.img_dir = image_dir
        self.mode = "train" if is_train else "test"

        self.coco = COCOIndex(annotation_file)
        cats = [c["name"] for c in self.coco.loadCats(self.coco.getCatIds())]
        self.classes = ["__background__"] + cats
        self._class_to_coco_ind = dict(zip(cats, self.coco.getCatIds()))
        self._coco_ind_to_class_ind = {
            self._class_to_coco_ind[c]: i + 1 for i, c in enumerate(cats)}
        self.image_set_index = self.coco.getImgIds()
        self.num_images = len(self.image_set_index)
        self.db = self._get_db()
        logger.info("=> loaded %d samples", len(self.db))

    def _get_db(self):
        if self.is_train:
            return self._load_annotations(bu_bbox=self.use_bu_bbox_train)
        if self.use_bu_bbox_test and self.condition_topdown and self.bbox_file == "":
            return self._load_annotations(bu_bbox=True)
        raise NotImplementedError(
            "test-time db from TEST.COCO_BBOX_FILE (BU predictions, pose results "
            f"or detector boxes) is not ported to buctd_tpu_torch yet: {_EVAL_ITEM}")

    def _load_annotations(self, bu_bbox=False):
        db = []
        for index in self.image_set_index:
            db.extend(self._load_annotation_kernel(index, bu_bbox))
        return db

    def _load_annotation_kernel(self, index, bu_bbox=False):
        """GT annotations of one image, with cond_kpts dicts, near joints and
        bbox-overlap crowding stats (dataloader.py:136-298)."""
        im_ann = self.coco.loadImgs(index)[0]
        width, height = im_ann["width"], im_ann["height"]
        objs = self.coco.loadAnns(self.coco.getAnnIds(imgIds=index, iscrowd=False))

        valid = []
        for obj in objs:
            x, y, w, h = obj["bbox"]
            x1, y1 = max(0, x), max(0, y)
            x2 = min(width - 1, x1 + max(0, w - 1))
            y2 = min(height - 1, y1 + max(0, h - 1))
            if x2 >= x1 and y2 >= y1:
                obj["clean_bbox"] = [x1, y1, x2 - x1, y2 - y1]
                valid.append(obj)
        objs = valid

        rec = []
        J = self.num_joints
        for obj in objs:
            if self._coco_ind_to_class_ind.get(obj["category_id"]) != 1:
                continue
            if max(obj["keypoints"]) == 0:
                continue
            kp = np.array(obj["keypoints"], np.float64).reshape(J, 3)
            joints_3d = np.zeros((J, 3))
            joints_3d[:, :2] = kp[:, :2]
            vis = np.minimum(kp[:, 2], 1)
            joints_3d_vis = np.zeros((J, 3))
            joints_3d_vis[:, 0] = vis
            joints_3d_vis[:, 1] = vis
            entry = {
                "image": os.path.join(self.image_dir, im_ann["file_name"]),
                "center": None, "scale": None,
                "joints_3d": joints_3d,
                "joints_3d_vis": joints_3d_vis,
                "use_bu_bbox": bu_bbox,
                "filename": "", "imgnum": 0,
                "annotation_id": obj["id"],
                "bbox": obj["clean_bbox"][:4],
                "best_model_key": self.best_bu_model_key,
                "image_id": obj["image_id"],
            }
            entry["center"], entry["scale"] = self._box2cs(obj["clean_bbox"][:4])

            if "cond_kpts" in obj:
                cond_joints, cond_vis = {}, {}
                for k, cond in obj["cond_kpts"].items():
                    ck = np.array(cond, np.float64).reshape(J, 3)
                    cj = np.zeros((J, 3))
                    cj[:, :2] = ck[:, :2]
                    cv = np.zeros((J, 3))
                    live = (cj.sum(axis=1) > 0).astype(np.float64)
                    cv[:, 0] = live
                    cv[:, 1] = live
                    cond_joints[k], cond_vis[k] = cj, cv
                entry["cond_joints"] = cond_joints
                entry["cond_joints_vis"] = cond_vis

            # crowding stats + near joints for swap noise (dataloader.py:213-241)
            if "bbox_overlaps" in obj and isinstance(obj["bbox_overlaps"], dict):
                ov = list(obj["bbox_overlaps"].values())
                entry["cond_max_iou"] = max(ov) if ov else 0
                near = [np.array(o["keypoints"], np.float64).reshape(-1, 3) for o in objs]
                entry["near_joints"] = near or [np.zeros((J, 3))]
            else:
                overlaps = np.array([self.calc_bbox_overlap(obj["clean_bbox"],
                                                            o["clean_bbox"])
                                     for o in objs])
                near = [np.array(o["keypoints"], np.float64).reshape(-1, 3)
                        for i, o in enumerate(objs) if overlaps[i] > 0.0]
                entry["near_joints"] = near or [np.zeros((J, 3))]
                others = overlaps[overlaps != 1]
                entry["cond_max_iou"] = float(others.max()) if len(overlaps) > 1 else 0
            rec.append(entry)
        return rec

    def _box2cs(self, box):
        return self._xywh2cs(*box[:4])

    @staticmethod
    def calc_bbox_overlap(bbox1, bbox2):
        x1, y1, w1, h1 = bbox1
        x2, y2, w2, h2 = bbox2
        xo = max(0, min(x1 + w1, x2 + w2) - max(x1, x2))
        yo = max(0, min(y1 + h1, y2 + h2) - max(y1, y2))
        inter = xo * yo
        union = w1 * h1 + w2 * h2 - inter
        return inter / union if union else 0.0

    def evaluate(self, cfg, preds, output_dir, *args, **kwargs):
        raise NotImplementedError(f"evaluation is not ported yet: {_EVAL_ITEM}")
