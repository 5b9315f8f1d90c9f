"""The serving bucket contract: the shape tables that bound the programs a
server holds, and the padding of a call into a bucket and back.

Shared by the live estimator (serving.py) and the exported one
(serving_export.py), as buctd_tpu/serving.py's tables and helpers are.  A
single-image bucket is (h, w, p): the image's height and width snapped up
to IMG_BUCKETS and its pose count to POSE_BUCKETS.  A batched bucket is
(n, h, w, p) with n images.  Imports no model or config code.
"""

from __future__ import annotations

import numpy as np
import torch

IMG_BUCKETS = (256, 384, 512, 640, 768, 1024, 1536, 2048)
POSE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
COUNT_BUCKETS = (2, 4, 8)   # images per batched call (1 = the unbatched path)


def bucket(v: int, buckets) -> int:
    """The smallest bucket that holds ``v``; ``v`` itself past the table."""
    for b in buckets:
        if v <= b:
            return b
    return v


def image_key(h: int, w: int, p: int) -> tuple:
    """The (h, w, p) bucket of an h x w image with p poses."""
    return bucket(h, IMG_BUCKETS), bucket(w, IMG_BUCKETS), bucket(p, POSE_BUCKETS)


def canonical(image, condition_poses):
    """image -> uint8 (H, W, 3); poses -> f32 (P, J, 3) with conf 1 if absent."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    conds = np.asarray(condition_poses, np.float32)
    if conds.ndim == 2:
        conds = conds[None]
    if conds.shape[-1] == 2:
        conds = np.concatenate([conds, np.ones((*conds.shape[:-1], 1), np.float32)], -1)
    return image, conds


def pad_image(image, conds, hb: int, wb: int, pb: int):
    """One canonical (image, poses) pair padded to the bucket (hb, wb, pb):
    the image into a zero canvas, the poses with copies of the first.
    Returns the image, the poses and the real [width, height]."""
    img_pad = np.zeros((hb, wb, 3), np.uint8)
    img_pad[:image.shape[0], :image.shape[1]] = image
    if pb != conds.shape[0]:
        conds = np.concatenate([conds, np.repeat(conds[:1], pb - conds.shape[0], 0)])
    return img_pad, conds, np.asarray([image.shape[1], image.shape[0]], np.float32)


def pad_rows(pairs, nb: int, hb: int, wb: int, pb: int):
    """Canonical pairs padded to the batched bucket (nb, hb, wb, pb): each
    row as ``pad_image``, the rows past the pairs copies of the last.
    Returns (nb, hb, wb, 3) images, (nb, pb, J, 3) poses, (nb, 2) sizes."""
    rows = [pad_image(im, cs, hb, wb, pb) for im, cs in pairs]
    rows += rows[-1:] * (nb - len(rows))
    return tuple(np.stack(col) for col in zip(*rows))


def to_host(preds, maxvals) -> np.ndarray:
    """(..., J, 2) and (..., J, 1) tensors -> (..., J, 3) f32 numpy, one
    copy (bf16 maxvals widened exactly)."""
    return torch.cat([preds, maxvals.float()], dim=-1).cpu().numpy()


def finish(res: np.ndarray, P: int, vis_thres: float) -> np.ndarray:
    """The first ``P`` poses of a padded result, joints under ``vis_thres``
    set to NaN."""
    out = res[:P]
    out[out[:, :, 2] < vis_thres] = np.nan
    return out
