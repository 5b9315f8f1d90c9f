"""Debug image dumps (reference: lib/utils/vis.py:380-473).

Counterpart of buctd_tpu/utils/vis.py.  The functions take the port's NCHW
batches, torch tensors (on any device) or numpy arrays: images (B, C, H, W)
normalized as the loaders give them, heatmaps (B, J, h, w), joints (B, J, 2+).
They draw with cv2 on the host, the pixels JAX's functions draw from the same
NHWC data.  ``save_debug_images`` is gated by the DEBUG.* config flags as in
the reference and writes:
  * {prefix}_gt.jpg / {prefix}_pred.jpg: batch grid with joints drawn
  * {prefix}_hm_gt.jpg / {prefix}_hm_pred.jpg: per-joint heatmap grids
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..data.joints_dataset import IMAGENET_MEAN, IMAGENET_STD


def _host(a) -> np.ndarray:
    """A torch tensor (any device, any float dtype) or an array -> numpy; f32
    for floating tensors."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
        a = a.float() if a.is_floating_point() else a
        return a.numpy()
    return np.asarray(a)


def _nhwc(a) -> np.ndarray:
    """(B, C, H, W) tensor or array -> (B, H, W, C) numpy."""
    return _host(a).transpose(0, 2, 3, 1)


def _denormalize(images):
    """Invert ToTensor+Normalize back to uint8 RGB for the first 3 channels."""
    rgb = _nhwc(images)[..., :3]
    rgb = (rgb * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    return np.clip(rgb, 0, 255).astype(np.uint8)


def save_batch_image_with_joints(batch_image, batch_joints, batch_joints_vis,
                                 file_name, nrow=8, padding=2):
    """Grid of crops with joint markers (vis.py:380-409 semantics)."""
    import cv2

    imgs = _denormalize(batch_image)
    joints, joints_vis = _host(batch_joints), _host(batch_joints_vis)
    B, H, W, _ = imgs.shape
    xmaps = min(nrow, B)
    ymaps = int(math.ceil(B / xmaps))
    grid = np.zeros((ymaps * (H + padding), xmaps * (W + padding), 3), np.uint8)
    k = 0
    for y in range(ymaps):
        for x in range(xmaps):
            if k >= B:
                break
            im = imgs[k].copy()
            for joint, vis in zip(joints[k], joints_vis[k]):
                if np.asarray(vis).ravel()[0] > 0:
                    cv2.circle(im, (int(joint[0]), int(joint[1])), 2,
                               (255, 0, 0), 2)
            grid[y * (H + padding):y * (H + padding) + H,
                 x * (W + padding):x * (W + padding) + W] = im
            k += 1
    cv2.imwrite(file_name, cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))


def save_batch_heatmaps(batch_image, batch_heatmaps, file_name, normalize=True):
    """One row per sample: resized crop + each joint heatmap colorized
    (vis.py:409-417 semantics; heatmaps (B, J, h, w))."""
    import cv2

    imgs = _denormalize(batch_image)
    hms = _nhwc(batch_heatmaps)
    B, h, w, J = hms.shape
    if normalize:
        mn = hms.min(axis=(1, 2), keepdims=True)
        mx = hms.max(axis=(1, 2), keepdims=True)
        hms = (hms - mn) / (mx - mn + 1e-10)

    grid = np.zeros((B * h, (J + 1) * w, 3), np.uint8)
    for i in range(B):
        img = cv2.resize(imgs[i], (w, h))
        grid[i * h:(i + 1) * h, 0:w] = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        for j in range(J):
            cm = cv2.applyColorMap((hms[i, :, :, j] * 255).astype(np.uint8),
                                   cv2.COLORMAP_JET)
            blend = (cm * 0.7 + cv2.cvtColor(img, cv2.COLOR_RGB2BGR) * 0.3)
            grid[i * h:(i + 1) * h, (j + 1) * w:(j + 2) * w] = blend
    cv2.imwrite(file_name, grid)


def _iou_bin_name(cond_max_iou: float) -> str:
    """The reference's crowding bins (vis.py:229-239): per-instance max IoU of
    the condition-derived box with any other instance in the image."""
    if cond_max_iou == 0:
        return "0"
    if cond_max_iou <= 0.1:
        return "0-0.1"
    if cond_max_iou <= 0.3:
        return "0.1-0.3"
    if cond_max_iou <= 0.5:
        return "0.3-0.5"
    return "0.5-1"


def save_batch_pred_gt_with_joints(batch_image, batch_joints, batch_joints_vis,
                                   meta, output_dir):
    """Per-sample pred/GT/condition dumps sorted into per-IoU-bin directories
    (reference: lib/utils/vis.py:206-266 ``save_batch_pred_gt_with_joints``).

    Each sample is written to ``{output_dir}/{iou_bin}/{image_name}`` with the
    prediction as blue circles, GT as red '+', and the condition pose as green
    '*'.  Binning follows the reference's ``cond_max_iou`` ranges so crowded
    failure cases can be browsed per crowding level.  Unlike the reference
    (which re-reads the source image, resizes it to 256x256, and then draws
    CROP-frame joints on it — dormant code with a coordinate mismatch), we
    draw on the network input crop, where the joint coordinates actually live.
    """
    import cv2

    imgs = _denormalize(batch_image)
    joints = _host(batch_joints)
    joints_vis = _host(batch_joints_vis)
    gt_joints = _host(meta["joints"])
    cond_joints = _host(meta["cond_joints"]) if "cond_joints" in meta else None
    cond_iou = _host(meta["cond_max_iou"]) if "cond_max_iou" in meta else None

    for k in range(imgs.shape[0]):
        im = cv2.cvtColor(imgs[k].copy(), cv2.COLOR_RGB2BGR)
        for i in range(joints.shape[1]):
            if np.asarray(joints_vis[k, i]).ravel()[0] > 0:
                cv2.circle(im, (int(joints[k, i, 0]), int(joints[k, i, 1])),
                           2, (255, 0, 0), 2)
            cv2.putText(im, "+", (int(gt_joints[k, i, 0]), int(gt_joints[k, i, 1])),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.3, (0, 0, 255), 1)
            if cond_joints is not None and cond_joints[k, i, 0] > 0 \
                    and cond_joints[k, i, 1] > 0:
                cv2.putText(im, "*", (int(cond_joints[k, i, 0]),
                                      int(cond_joints[k, i, 1])),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.3, (0, 255, 0), 1)
        bin_dir = output_dir
        if cond_iou is not None:
            bin_dir = os.path.join(output_dir, _iou_bin_name(float(cond_iou[k])))
        os.makedirs(bin_dir, exist_ok=True)
        name = meta["image"][k] if "image" in meta else f"sample{k}.jpg"
        name = "_".join(str(name).split("/")[-2:])
        cv2.imwrite(os.path.join(bin_dir, name), im)


def save_debug_images(config, input, meta, target, joints_pred, output,
                      prefix):
    """Gated by DEBUG.* flags (vis.py:417-473).  Images and heatmaps NCHW."""
    if not config.DEBUG.DEBUG:
        return
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    if config.DEBUG.SAVE_BATCH_IMAGES_GT:
        save_batch_image_with_joints(input, meta["joints"], meta["joints_vis"],
                                     f"{prefix}_gt.jpg")
    if config.DEBUG.SAVE_BATCH_IMAGES_PRED:
        vis = np.ones_like(_host(meta["joints_vis"]))
        save_batch_image_with_joints(input, joints_pred, vis,
                                     f"{prefix}_pred.jpg")
        # per-IoU-bin dumps: the reference ships this commented out
        # (vis.py:436-438); we gate it behind its own flag instead
        if getattr(config.DEBUG, "SAVE_IOU_BIN_PRED", False):
            save_batch_pred_gt_with_joints(input, joints_pred, vis, meta,
                                           f"{prefix}_pred_bins")
    if config.DEBUG.SAVE_HEATMAPS_GT:
        save_batch_heatmaps(input, target, f"{prefix}_hm_gt.jpg")
    if config.DEBUG.SAVE_HEATMAPS_PRED:
        save_batch_heatmaps(input, output, f"{prefix}_hm_pred.jpg")
