"""Per-sample host work: condition choice, augmentation draws, crop affine,
and the host crop.

Counterpart of buctd_tpu/data/joints_dataset.py (:32-385).  ``plan_sample``
is what both loaders run on the host: image decode (image files, or zip
archives with ``DATASET.DATA_FORMAT zip``), condition selection or
generative synthesis, BU-box derivation, augmentation draws, half-body
transform, the crop affine and the joint transforms, all in numpy.  The
device loader (data/device_pipeline.py) warps on the card (K4); the host
``Loader`` (data/pipeline.py, ``TPU.DEVICE_PIPELINE False``) takes
``get_sample``: the plan, the crop-aug rectangle zeroed, then
``cv2.warpAffine`` (INTER_LINEAR), the JAX package's host crop.  The random
draws come from the global ``np.random`` and ``random`` states in the JAX
package's order, so seeded runs plan the same samples in both packages.
"""

from __future__ import annotations

import copy
import random

import numpy as np

from ..geometry import (PIXEL_STD, affine_transform_points, fliplr_joints,
                        host_affine, xywh2cs)
from .pose_synthesis import synthesize_pose

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _rainbow(x: np.ndarray) -> np.ndarray:
    """matplotlib's 'rainbow' colormap (gnuplot formulas 33, 13, 10 clipped to
    [0, 1]) at x in [0, 1]; written out so the port needs no matplotlib."""
    r = np.abs(2.0 * x - 0.5)
    g = np.sin(x * np.pi)
    b = np.cos(x * np.pi / 2.0)
    return np.clip(np.stack([r, g, b], -1), 0.0, 1.0)


def rainbow_colors(num: int) -> np.ndarray:
    """(J, 3) keypoint colors from the 'rainbow' cmap's 256-entry table, matching
    JointsDataset.get_colors_from_cmap (JointsDataset.py:463-467)."""
    lut = _rainbow(np.linspace(0.0, 1.0, 256))
    out = [tuple(int(c * 255) for c in lut[i]) for i in range(0, 256, 256 // num)]
    return np.array(out[:num], np.float64)


DEFAULT_BEST_BU_MODEL_KEY = "baseline_resnet_50_s4_60000"


def imread_rgb(path: str, color_rgb: bool = True, data_format: str = "jpg") -> np.ndarray:
    """cv2 decode (EXIF orientation ignored, as the reference), BGR -> RGB;
    ``data_format`` 'zip' reads ``archive.zip@/inner/path`` (utils/zipreader.py)."""
    import cv2

    flags = cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
    if data_format == "zip":
        from ..utils import zipreader
        img = zipreader.imread(path, flags)
    else:
        img = cv2.imread(path, flags)
    if img is None:
        raise ValueError(f"Fail to read {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if color_rgb else img


class JointsDataset:
    """Base dataset: db of records -> planned samples (JointsDataset.py:134-361).

    Subclasses (datasets/) set flip_pairs, upper_body_ids, lower_body_ids and
    joints_weight, and build ``db`` in _get_db().
    """

    flip_pairs: list = []
    parent_ids: list = []
    upper_body_ids: tuple = ()
    lower_body_ids: tuple = ()
    joints_weight = 1

    def __init__(self, cfg, image_dir, annotation_file, is_train):
        self.cfg = cfg
        self.is_train = is_train
        self.image_dir = image_dir
        self.annotation_file = annotation_file

        self.pixel_std = PIXEL_STD
        self.num_joints = cfg.MODEL.NUM_JOINTS
        self.colored_kpt = cfg.DATASET.COLORED
        self.stacked_condition = cfg.DATASET.STACKED_CONDITION
        self.kpt_colors = rainbow_colors(self.num_joints)
        self.bu_bbox_margin = cfg.DATASET.BU_BBOX_MARGIN
        self.best_bu_model_key = DEFAULT_BEST_BU_MODEL_KEY
        self.synthesis_pose = cfg.DATASET.SYNTHESIS_POSE
        self.data_format = cfg.DATASET.DATA_FORMAT

        self.scale_factor = cfg.DATASET.SCALE_FACTOR
        self.rotation_factor = cfg.DATASET.ROT_FACTOR
        self.flip = cfg.DATASET.FLIP
        self.num_joints_half_body = cfg.DATASET.NUM_JOINTS_HALF_BODY
        self.prob_half_body = cfg.DATASET.PROB_HALF_BODY
        self.color_rgb = cfg.DATASET.COLOR_RGB
        self.new_crop_aug = cfg.DATASET.NEW_AUGMENTATION
        self.bbox_aug = cfg.DATASET.BBOX_AUGMENTATION

        self.condition_topdown = cfg.MODEL.CONDITIONAL_TOPDOWN
        self.image_size = np.array(cfg.MODEL.IMAGE_SIZE)
        self.heatmap_size = np.array(cfg.MODEL.HEATMAP_SIZE)
        self.sigma = cfg.MODEL.SIGMA
        self.use_different_joints_weight = cfg.LOSS.USE_DIFFERENT_JOINTS_WEIGHT
        self.scale_thre = cfg.TEST.SCALE_THRE
        self.aspect_ratio = self.image_size[0] / self.image_size[1]
        self.db = []

    def _get_db(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.db)

    def _xywh2cs(self, x, y, w, h):
        return xywh2cs(x, y, w, h, self.aspect_ratio, self.scale_thre, self.pixel_std)

    def half_body_transform(self, joints, joints_vis):
        """JointsDataset.py:86-129 (with its np.random.randn() < 0.5 coin)."""
        upper, lower = [], []
        for j in range(self.num_joints):
            if joints_vis[j][0] > 0:
                (upper if j in self.upper_body_ids else lower).append(joints[j])
        if np.random.randn() < 0.5 and len(upper) > 2:
            selected = upper
        else:
            selected = lower if len(lower) > 2 else upper
        if len(selected) < 2:
            return None, None
        selected = np.array(selected, np.float32)
        center = selected.mean(axis=0)[:2]
        lt, rb = np.amin(selected, axis=0), np.amax(selected, axis=0)
        w, h = rb[0] - lt[0], rb[1] - lt[1]
        if w > self.aspect_ratio * h:
            h = w / self.aspect_ratio
        elif w < self.aspect_ratio * h:
            w = h * self.aspect_ratio
        scale = np.array([w / self.pixel_std, h / self.pixel_std], np.float32) * 1.5
        return center, scale

    def synthesis_seed(self, db_rec):
        """(joints, seed_cond, near, area) of one record: the inputs of batched
        device synthesis (TPU.DEVICE_SYNTHESIS, data/pose_synthesis_device.py),
        mirroring the host path's seed selection."""
        joints = np.asarray(db_rec["joints_3d"], np.float64).reshape(-1, 3)
        cond = db_rec.get("cond_joints")
        if cond is None or isinstance(cond, dict):
            cond = joints.copy()
        else:
            cond = np.asarray(cond, np.float64).reshape(-1, 3)
        nz_x = cond[:, 0][np.nonzero(cond[:, 0])]
        nz_y = cond[:, 1][np.nonzero(cond[:, 1])]
        area = ((nz_x.max() - nz_x.min()) * (nz_y.max() - nz_y.min())
                if len(nz_x) and len(nz_y) else 1.0)
        near = np.asarray(db_rec.get("near_joints", np.zeros((0, self.num_joints, 3))))
        return joints, cond, near.reshape(-1, self.num_joints, 3), float(area)

    def _choose_condition(self, db_rec, joints, joints_vis, cond_override=None):
        """Condition selection rules (JointsDataset.py:165-215), with the JAX
        package's repairs of the reference's unbound-name cases."""
        if self.condition_topdown and self.is_train and "cond_joints" not in db_rec:
            if not self.synthesis_pose:
                raise ValueError("training without 'cond_kpts' requires "
                                 "DATASET.SYNTHESIS_POSE=True")
            db_rec["cond_joints"] = joints.copy()
            db_rec["cond_joints_vis"] = joints_vis.copy()
        if "cond_joints" not in db_rec:
            return None, None

        conditions = db_rec["cond_joints"]
        conditions_vis = db_rec["cond_joints_vis"]
        cond_joints = cond_joints_vis = None
        if not isinstance(conditions, dict):
            cond_joints, cond_joints_vis = conditions, conditions_vis
        elif len(conditions) == 0:
            cond_joints = np.zeros_like(joints)
            cond_joints_vis = np.zeros_like(joints_vis)
        elif not (self.synthesis_pose and self.is_train):
            if not self.is_train:
                key = db_rec.get("best_model_key") or self.best_bu_model_key
                if key not in conditions:
                    key = random.choice(list(conditions))
            else:
                key = random.choice(list(conditions))
            cond_joints, cond_joints_vis = conditions[key], conditions_vis[key]

        if self.synthesis_pose and self.is_train:
            if cond_joints is None:
                cond_joints = joints.copy()
                cond_joints_vis = joints_vis.copy()
            if cond_override is not None:
                cond_joints = np.asarray(cond_override, np.float64)
            else:
                nz_x = cond_joints[:, 0][np.nonzero(cond_joints[:, 0])]
                nz_y = cond_joints[:, 1][np.nonzero(cond_joints[:, 1])]
                area = ((nz_x.max() - nz_x.min()) * (nz_y.max() - nz_y.min())
                        if len(nz_x) and len(nz_y) else 1.0)
                near = np.asarray(db_rec.get("near_joints",
                                             np.zeros((0, self.num_joints, 3))))
                cond_joints = synthesize_pose(
                    self.cfg, np.array(joints).reshape(-1, 3),
                    np.array(cond_joints).reshape(-1, 3),
                    near_joints=near.reshape((-1, self.num_joints, 3)), area=area,
                    num_overlap=0)
            # cond_joints_vis keeps the PRE-synthesis visibility, as the
            # reference does (:202-215)
        return np.asarray(cond_joints, np.float64), np.asarray(cond_joints_vis, np.float64)

    def plan_sample(self, idx, data_numpy=None, cond_override=None):
        """Every host-side decision of one sample without the warp: 'image'
        (the possibly flipped source view), 'trans' / 'trans_inv' (crop affine
        in that frame), 'mask_box' (crop-aug zeroing rectangle, or None) and
        the crop-frame joints and conditions (JointsDataset.py:134-300)."""
        db_rec = copy.deepcopy(self.db[idx])
        image_file = db_rec["image"]
        if data_numpy is None:
            data_numpy = imread_rgb(image_file, self.color_rgb, self.data_format)

        joints = np.asarray(db_rec["joints_3d"], np.float64).copy()
        joints_vis = np.asarray(db_rec["joints_3d_vis"], np.float64).copy()
        use_bu_bbox = db_rec.get("use_bu_bbox", False)
        cond_joints, cond_joints_vis = self._choose_condition(
            db_rec, joints, joints_vis, cond_override=cond_override)
        has_cond = cond_joints is not None

        # BU box from the (possibly synthesized) condition (:218-232); the
        # reference's guard reads only joint 0's y, kept on purpose
        if (use_bu_bbox and has_cond and cond_joints[:, 0].sum() != 0
                and cond_joints[0, 1].sum() != 0):
            nz = np.nonzero(cond_joints[:, 0])
            xmin = np.min(cond_joints[:, 0][nz]) - self.bu_bbox_margin
            xmax = np.max(cond_joints[:, 0][nz]) + self.bu_bbox_margin
            nz = np.nonzero(cond_joints[:, 1])
            ymin = np.min(cond_joints[:, 1][nz]) - self.bu_bbox_margin
            ymax = np.max(cond_joints[:, 1][nz]) + self.bu_bbox_margin
            xmin = np.clip(xmin, 0, data_numpy.shape[1])
            ymin = np.clip(ymin, 0, data_numpy.shape[0])
            xmax = np.clip(xmax, 0, data_numpy.shape[1])
            ymax = np.clip(ymax, 0, data_numpy.shape[0])
            bbox = [xmin, ymin, xmax - xmin, ymax - ymin]
            c, s = self._xywh2cs(*bbox)
        else:
            c = np.array(db_rec["center"], np.float64).copy()
            s = np.array(db_rec["scale"], np.float64).copy()
            bbox = db_rec.get("bbox", [0, 0, data_numpy.shape[1], data_numpy.shape[0]])
        score = db_rec.get("score", 1)
        r = 0

        if self.is_train:
            if (np.sum(joints_vis[:, 0]) > self.num_joints_half_body
                    and np.random.rand() < self.prob_half_body):
                c_hb, s_hb = self.half_body_transform(joints, joints_vis)
                if c_hb is not None and s_hb is not None:
                    c, s = c_hb, s_hb
            sf, rf = self.scale_factor, self.rotation_factor
            s = s * np.clip(np.random.randn() * sf + 1, 1 - sf, 1 + sf)
            r = (np.clip(np.random.randn() * rf, -rf * 2, rf * 2)
                 if random.random() <= 0.6 else 0)
            if self.flip and random.random() <= 0.5:
                data_numpy = data_numpy[:, ::-1, :]
                joints, joints_vis = fliplr_joints(
                    joints, joints_vis, data_numpy.shape[1], self.flip_pairs)
                c[0] = data_numpy.shape[1] - c[0] - 1
                if has_cond:
                    cond_joints, cond_joints_vis = fliplr_joints(
                        cond_joints, cond_joints_vis, data_numpy.shape[1],
                        self.flip_pairs)

        trans = host_affine(c, s, r, self.image_size)
        trans_inv = host_affine(c, s, r, self.image_size, inv=True)

        # crop-style augmentation box (:266-279), in original coords, applied
        # to the (possibly flipped) image as the reference does
        mask_box = None
        if self.new_crop_aug and self.is_train:
            x, y, w, h = np.array(bbox).astype(int)
            if self.bbox_aug:
                x_d = w * random.randint(0, 20) // 10
                y_d = h * random.randint(0, 20) // 10
                x = int(x - x_d) if x - x_d > 0 else 0
                y = int(y - y_d) if y - y_d > 0 else 0
                w = int(w + 2 * x_d)
                h = int(h + 2 * y_d)
            mask_box = (x, y, w, h)

        vis_mask = joints_vis[:, 0] > 0
        joints[vis_mask, 0:2] = affine_transform_points(joints[vis_mask, 0:2], trans)
        if has_cond:
            cvis = cond_joints_vis[:, 0] > 0
            cond_joints[cvis, 0:2] = affine_transform_points(cond_joints[cvis, 0:2], trans)
        else:
            cond_joints = np.zeros((self.num_joints, 3))
            cond_joints_vis = np.zeros((self.num_joints, 3))

        return {
            "image": data_numpy,
            "trans": trans,
            "trans_inv": trans_inv,
            "mask_box": mask_box,
            "joints": joints.astype(np.float32),
            "joints_vis": joints_vis.astype(np.float32),
            "cond_joints": cond_joints.astype(np.float32),
            "cond_joints_vis": cond_joints_vis.astype(np.float32),
            "has_cond": np.float32(has_cond and self.condition_topdown),
            "center": np.asarray(c, np.float32),
            "scale": np.asarray(s, np.float32),
            "rotation": np.float32(r),
            "score": np.float32(score),
            "annotation_id": np.int64(db_rec.get("annotation_id", -1)),
            "cond_max_iou": np.float32(db_rec.get("cond_max_iou", 0.0)),
            "image_path": image_file,
        }

    def get_sample(self, idx, data_numpy=None, cond_override=None):
        """One sample with the crop warped on the host by cv2 (JAX
        joints_dataset.py:358-385): ``plan_sample``, the pixels outside the
        crop-aug rectangle zeroed, then ``cv2.warpAffine`` (INTER_LINEAR,
        border 0) into a uint8 (H, W, 3) 'image'.  ``data_numpy`` injects a
        decoded image."""
        import cv2

        plan = self.plan_sample(idx, data_numpy, cond_override=cond_override)
        src = plan.pop("image")
        if plan["mask_box"] is not None:
            src = src.copy()
            x, y, w, h = plan["mask_box"]
            H, W = src.shape[:2]
            src[0:H, 0:x] = 0
            src[0:y, x:W] = 0
            src[y + h:H, x:W] = 0
            src[y:y + h, x + w:W] = 0
        crop = cv2.warpAffine(src, plan["trans"],
                              (int(self.image_size[0]), int(self.image_size[1])),
                              flags=cv2.INTER_LINEAR)
        plan["image"] = np.ascontiguousarray(crop)
        for k in ("trans", "trans_inv", "mask_box"):
            plan.pop(k)
        return plan

    __getitem__ = get_sample
