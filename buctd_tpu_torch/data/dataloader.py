"""COCO-style sample db and the evaluation protocol (reference:
lib/dataset/dataloader.py).

Counterpart of buctd_tpu/data/dataloader.py::CocoStyleDataset.  The db comes
from four input formats:

  * GT annotations (train, or test with embedded per-model 'cond_kpts' dicts)
  * BU prediction json ({'preds', 'scores', 'image_paths'} per image)
  * pose-results json (standard COCO results: the iterative-refinement hook,
    dispatched when 'preds' is absent, dataloader.py:337-339)
  * detector-box pickle (no conditions)

``evaluate`` is the protocol: rescoring, OKS-NMS with its bypass rules, the
results json, and COCOeval through the port's ``COCOKeypointEval``.  The
lambda-sweep evaluation (``evaluate_lambda``, an (N, 8) ``all_boxes``) is not
ported: ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from collections import OrderedDict, defaultdict

import numpy as np

from ..ops.nms import oks_nms, soft_oks_nms
from .coco_eval import COCO_STATS_NAMES, COCOKeypointEval
from .coco_io import COCOIndex
from .joints_dataset import JointsDataset

logger = logging.getLogger(__name__)

_LAMBDA_ITEM = "ROADMAP Queue 1 item 7, 'Evaluation: the rest'"


class CocoStyleDataset(JointsDataset):
    """Shared base of the COCO-format datasets (coco, crowdpose)."""

    # subclasses override
    oks_sigmas: np.ndarray = None
    crowd_index_bins = None
    stats_names = COCO_STATS_NAMES
    area_rngs = None
    # crowdpose variant knobs (lib/dataset/crowdpose.py:160-216): always use the box
    # area from all_boxes (its kpt-extent area is computed but unused), and no OKS-NMS
    area_from_boxes_always = False
    use_nms = True

    def __init__(self, cfg, image_dir=None, annotation_file=None, is_train=False):
        if image_dir is None:
            image_dir = (cfg.DATASET.TRAIN_IMAGE_DIR if is_train
                         else cfg.DATASET.TEST_IMAGE_DIR)
        if annotation_file is None:
            annotation_file = (cfg.DATASET.TRAIN_ANNOTATION_FILE if is_train
                               else cfg.DATASET.TEST_ANNOTATION_FILE)
        super().__init__(cfg, image_dir, annotation_file, is_train)
        self.nms_thre = cfg.TEST.NMS_THRE
        self.image_thre = cfg.TEST.IMAGE_THRE
        self.soft_nms = cfg.TEST.SOFT_NMS
        self.oks_thre = cfg.TEST.OKS_THRE
        self.in_vis_thre = cfg.TEST.IN_VIS_THRE
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
        if self.use_bu_bbox_test and self.condition_topdown:
            if self.bbox_file == "":
                return self._load_annotations(bu_bbox=True)
            return self._load_bu_detection_results()
        return self._load_detection_results()

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

    # ------------------------------------------------------------------
    def _load_bu_detection_results(self):
        """BU prediction json -> conditions + kpt-derived boxes (dataloader.py:325-393)."""
        with open(self.bbox_file) as f:
            all_preds = json.load(f)
        if not all_preds:
            logger.error("=> Load %s fail!", self.bbox_file)
            return None

        kpt_db = []
        J = self.num_joints
        for img_pred in all_preds:
            if "preds" not in img_pred:
                return self._load_pose_results()

            img_name = img_pred["image_paths"][0]
            boxes, conds, cond_vis, kept_scores = [], [], [], []
            for p, sc in zip(img_pred["preds"], img_pred["scores"]):
                p = np.array(p, np.float64)
                cj = np.zeros((J, 3))
                cj[:, :2] = p[:, :2]
                cv = np.zeros((J, 3))
                cv[:, 0] = p[:, 2]
                cv[:, 1] = p[:, 2]
                nzx, nzy = np.nonzero(cj[:, 0]), np.nonzero(cj[:, 1])
                if len(nzx[0]) == 0 or len(nzy[0]) == 0:
                    # fully-undetected pose: no box can be derived (the reference
                    # crashes here, :356-359; skipped like _load_pose_results)
                    continue
                conds.append(cj)
                cond_vis.append(cv)
                kept_scores.append(sc)
                xmin = np.min(cj[:, 0][nzx]) - self.bu_bbox_margin
                xmax = np.max(cj[:, 0][nzx]) + self.bu_bbox_margin
                ymin = np.min(cj[:, 1][nzy]) - self.bu_bbox_margin
                ymax = np.max(cj[:, 1][nzy]) + self.bu_bbox_margin
                boxes.append([xmin, ymin, xmax - xmin, ymax - ymin])

            for i, score in enumerate(kept_scores):
                ious = [self.calc_bbox_overlap(boxes[i], boxes[j])
                        for j in range(len(boxes)) if j != i]
                if score < self.image_thre:
                    continue
                center, scale = self._box2cs(boxes[i])
                kpt_db.append({
                    "image": img_name,
                    "center": center, "scale": scale, "score": score,
                    "joints_3d": np.zeros((J, 3)),
                    "joints_3d_vis": np.ones((J, 3)),
                    "cond_joints": conds[i],
                    "cond_joints_vis": cond_vis[i],
                    "cond_max_iou": max(ious) if ious else 0,
                    "use_bu_bbox": True,
                })
        return kpt_db

    def _load_pose_results(self):
        """Standard COCO results json as conditions: the iterative-refinement
        input (dataloader.py:454-508)."""
        with open(self.bbox_file) as f:
            all_preds = json.load(f)
        with open(self.test_gt_file) as f:
            test_gt = json.load(f)
        id_to_file = {img["id"]: img["file_name"] for img in test_gt["images"]}
        id_to_wh = {img["id"]: (img.get("width"), img.get("height"))
                    for img in test_gt["images"]}

        kpt_db = []
        J = self.num_joints
        for img_pred in all_preds:
            score = img_pred["score"]
            img_name = os.path.join(self.img_dir, id_to_file[img_pred["image_id"]])
            W, H = id_to_wh[img_pred["image_id"]]
            if W is None:  # the reference reads the image for its size (:473-475)
                from .joints_dataset import imread_rgb
                H, W = imread_rgb(img_name, False).shape[:2]

            cond = np.array(img_pred["keypoints"], np.float64).reshape(J, 3)
            nzx, nzy = np.nonzero(cond[:, 0]), np.nonzero(cond[:, 1])
            if len(nzx[0]) == 0 or len(nzy[0]) == 0:
                continue
            xmin = np.clip(np.min(cond[:, 0][nzx]) - self.bu_bbox_margin, 0, W)
            ymin = np.clip(np.min(cond[:, 1][nzy]) - self.bu_bbox_margin, 0, H)
            xmax = np.clip(np.max(cond[:, 0][nzx]) + self.bu_bbox_margin, 0, W)
            ymax = np.clip(np.max(cond[:, 1][nzy]) + self.bu_bbox_margin, 0, H)
            c, s = self._xywh2cs(xmin, ymin, xmax - xmin, ymax - ymin)
            kpt_db.append({
                "image": img_name,
                "center": c, "scale": s, "score": score,
                "joints_3d": np.zeros((J, 3)),
                "joints_3d_vis": np.ones((J, 3)),
                "cond_joints": cond,
                "cond_joints_vis": np.ones((J, 3)),
                "bbox": [xmin, ymin, xmax - xmin, ymax - ymin],
                "cond_max_iou": 1,
                "image_id": img_pred["image_id"],
            })
        return kpt_db

    def _load_detection_results(self):
        """Detector-box pickle, no conditions (dataloader.py:396-450)."""
        with open(self.test_gt_file) as f:
            test_gt = json.load(f)
        with open(self.bbox_file, "rb") as f:
            results = pickle.load(f)
        if not results:
            logger.error("=> Load %s fail!", self.bbox_file)
            return None

        kpt_db = []
        J = self.num_joints
        for n_img, img_res in enumerate(results):
            for det in img_res[0]:
                x1, y1, x2, y2, score = det[:5]
                if score < self.image_thre:
                    continue
                box = (x1, y1, x2 - x1, y2 - y1)
                center, scale = self._box2cs(box)
                kpt_db.append({
                    "image": os.path.join(self.img_dir,
                                          test_gt["images"][n_img]["file_name"]),
                    "center": center, "scale": scale, "score": score,
                    "joints_3d": np.zeros((J, 3)),
                    "joints_3d_vis": np.ones((J, 3)),
                    "bbox": box,
                    "image_id": test_gt["images"][n_img]["id"],
                })
        return kpt_db

    # ------------------------------------------------------------------
    @staticmethod
    def calc_bbox_overlap(bbox1, bbox2):
        x1, y1, w1, h1 = bbox1
        x2, y2, w2, h2 = bbox2
        xo = max(0, min(x1 + w1, x2 + w2) - max(x1, x2))
        yo = max(0, min(y1 + h1, y2 + h2) - max(y1, y2))
        inter = xo * yo
        union = w1 * h1 + w2 * h2 - inter
        return inter / union if union else 0.0

    # ------------------------------------------------------------------
    # evaluation protocol
    # ------------------------------------------------------------------
    def evaluate(self, cfg, preds, output_dir, all_boxes, img_path, epoch=-1,
                 *args, **kwargs):
        """Rescoring + OKS-NMS (with bypass rules) + results json + COCOeval.

        preds: (N, J, 3); all_boxes: (N, 7) [cx, cy, sx, sy, area, score, ann_id].
        Returns (name_values, AP).  Matches lib/dataset/dataloader.py:538-648.
        An (N, 8) all_boxes (the lambda sweep's) raises: not ported.
        """
        if np.asarray(all_boxes).shape[1] == 8:
            raise NotImplementedError("the lambda-sweep evaluation (evaluate_lambda) "
                                      f"is not ported yet: {_LAMBDA_ITEM}")
        res_folder = os.path.join(output_dir, "results")
        os.makedirs(res_folder, exist_ok=True)
        res_file = os.path.join(
            res_folder, f"keypoints_{self.mode}_results_epoch{epoch}.json")
        if cfg.OUTPUT_JSON:
            res_file = cfg.OUTPUT_JSON

        oks_nmsed = self._rescore_and_nms(cfg, preds, all_boxes, img_path)
        self._write_keypoint_results(oks_nmsed, res_file)

        if self.is_train:
            return {"Null": 0}, 0
        name_value = OrderedDict(self._do_keypoint_eval(res_file))
        return name_value, name_value["AP"]

    def _rescore_and_nms(self, cfg, preds, all_boxes, img_path):
        """Per-image rescoring (box score x mean kpt conf) + OKS-NMS with the
        bypass rules (lib/dataset/dataloader.py:560-634).  Returns a list of
        per-image kept-keypoint dicts."""
        path_to_id = {}
        for index in self.image_set_index:
            im_ann = self.coco.loadImgs(index)[0]
            path_to_id[os.path.join(self.image_dir, im_ann["file_name"])] = im_ann["id"]
        areas = {ann["id"]: ann.get("area", 0) for ann in self.coco.anns.values()}

        kpts = defaultdict(list)
        for idx, kpt in enumerate(preds):
            if self.area_from_boxes_always:
                area = all_boxes[idx][4]
            elif not self.is_train and (not self.use_gt_bbox or self.use_bu_bbox_test):
                area = all_boxes[idx][4]
            else:
                area = areas.get(int(all_boxes[idx][6]), all_boxes[idx][4])
            image = path_to_id[img_path[idx]]
            kpts[image].append({
                "keypoints": np.asarray(kpt),
                "center": all_boxes[idx][0:2],
                "scale": all_boxes[idx][2:4],
                "area": area,
                "score": all_boxes[idx][5],
                "image": image,
                "image_path": img_path[idx],
                "annotation_id": int(all_boxes[idx][6]),
            })

        sigmas = (np.full(self.num_joints, self.joints_weight / 10.0)
                  if np.isscalar(self.joints_weight)
                  else np.asarray(self.joints_weight).ravel() / 10.0)
        oks_nmsed = []
        for img_kpts in kpts.values():
            for n_p in img_kpts:  # rescoring: box score x mean kpt conf (:596-612)
                box_score = n_p["score"]
                kpt_conf = n_p["keypoints"][:, 2]
                sel = kpt_conf > self.in_vis_thre
                kpt_score = kpt_conf[sel].mean() if sel.any() else 0.0
                n_p["score"] = kpt_score * box_score
                n_p["box_score"] = box_score
                n_p["keypoint_score"] = kpt_score

            keep = []
            if self.use_nms:
                nms_fn = soft_oks_nms if self.soft_nms else oks_nms
                keep = nms_fn(img_kpts, self.oks_thre, sigmas=sigmas)
            # bypass rules (:627-634)
            if self.use_bu_bbox_test or self.use_bu_bbox_train or self.use_gt_bbox:
                keep = []
            if not self.is_train and ".json" in cfg.TEST.COCO_BBOX_FILE:
                keep = []
            oks_nmsed.append(img_kpts if len(keep) == 0
                             else [img_kpts[k] for k in keep])
        return oks_nmsed

    def _write_keypoint_results(self, keypoints, res_file):
        cat_id = self._class_to_coco_ind[self.classes[1]]
        results = []
        for img_kpts in keypoints:
            for k in img_kpts:
                kp = np.asarray(k["keypoints"], np.float64)
                flat = np.zeros(self.num_joints * 3)
                flat[0::3] = kp[:, 0]
                flat[1::3] = kp[:, 1]
                flat[2::3] = kp[:, 2]
                results.append({
                    "image_id": int(k["image"]),
                    "image_path": os.path.join(*str(k["image_path"]).split("/")[-3:]),
                    "category_id": cat_id,
                    "keypoints": [float(v) for v in flat],
                    "score": float(k["score"]),
                    "center": [float(v) for v in np.asarray(k["center"]).ravel()],
                    "scale": [float(v) for v in np.asarray(k["scale"]).ravel()],
                    "annotation_id": int(k["annotation_id"]),
                    "box_score": float(k["box_score"]),
                    "keypoint_score": float(k["keypoint_score"]),
                })
        logger.info("=> writing results json to %s", res_file)
        with open(res_file, "w") as f:
            json.dump(results, f, sort_keys=True, indent=4)

    def _do_keypoint_eval(self, res_file):
        coco_dt = self.coco.loadRes(res_file)
        ev = COCOKeypointEval(self.coco, coco_dt, self.oks_sigmas,
                              area_rngs=self.area_rngs,
                              crowd_index_bins=self.crowd_index_bins)
        ev.evaluate()
        ev.accumulate()
        stats = ev.summarize()
        return [(name, stats[i]) for i, name in enumerate(self.stats_names)]
