"""Iterative refinement on the device: box -> crop -> render -> forward -> decode.

Counterpart of buctd_tpu/core/refine.py.  Each round re-derives the condition
boxes from the previous round's predictions, re-crops the source image with the
aligned matmul warp, re-renders the colored condition and re-runs the model.
The JAX ``lax.scan`` over rounds is a Python loop here; every tensor stays on
the device between rounds (no host copy).

``TPU.EVAL_DTYPE bfloat16`` runs the model under bf16 autocast
(models/__init__.py::autocast): its heatmaps come out bf16, the decode runs
on them (ops/decode.py), and the next round's confidences are the bf16
maxvals widened to f32, as JAX's concatenate promotes them.  The warp and
the render then take TF32 operands on the card (JAX's
``precision="default"`` for a bf16 model, core/refine.py:78 there, which
XLA takes as TF32 on a GPU and exact f32 on the CPU): the operands are
rounded (ops/tf32.py::tf32_operand), so no process-wide TF32 flag is read or
set, and an f32 and a bf16 model in one process keep their own numerics.
"""

from __future__ import annotations

import torch

from ..data.joints_dataset import IMAGENET_MEAN, IMAGENET_STD
from ..data.pipeline import condition_mode, render_condition
from ..geometry import PIXEL_STD, affine_points, make_affine
from ..models import autocast, compute_dtype
from ..ops.decode import dark_blur, get_final_preds
from ..ops.warp import warp_affine_aligned


def joints2cs(joints, img_w, img_h, margin: float, aspect_ratio: float,
              scale_thre: float = 1.25, pixel_std: float = PIXEL_STD):
    """Batched condition keypoints (B, J, 2+) -> (center, scale) (B, 2) each:
    nonzero-extent box + margin, clipped to the image (``img_w``/``img_h``
    scalars or (B,) tensors), aspect-corrected, x1.25 inflated
    (JointsDataset.py:218-232, geometry.xywh2cs)."""
    x, y = joints[..., 0], joints[..., 1]
    img_w = torch.as_tensor(img_w, dtype=torch.float32, device=joints.device)
    img_h = torch.as_tensor(img_h, dtype=torch.float32, device=joints.device)
    valid_x, valid_y = x != 0, y != 0
    # +-1e9 as scalars: a tensor made from a host value would be a host copy,
    # which a CUDA-graph capture refuses
    xmin = torch.where(valid_x, x, 1e9).amin(dim=-1) - margin
    xmax = torch.where(valid_x, x, -1e9).amax(dim=-1) + margin
    ymin = torch.where(valid_y, y, 1e9).amin(dim=-1) - margin
    ymax = torch.where(valid_y, y, -1e9).amax(dim=-1) + margin
    zero = torch.zeros((), device=joints.device)
    xmin = torch.minimum(torch.maximum(xmin, zero), img_w)
    xmax = torch.minimum(torch.maximum(xmax, zero), img_w)
    ymin = torch.minimum(torch.maximum(ymin, zero), img_h)
    ymax = torch.minimum(torch.maximum(ymax, zero), img_h)
    # degenerate (no valid keypoints) -> the full image
    any_valid = valid_x.any(dim=-1) & valid_y.any(dim=-1)
    xmin = torch.where(any_valid, xmin, zero)
    ymin = torch.where(any_valid, ymin, zero)
    xmax = torch.where(any_valid, xmax, img_w.expand_as(xmax))
    ymax = torch.where(any_valid, ymax, img_h.expand_as(ymax))

    w, h = xmax - xmin, ymax - ymin
    center = torch.stack([xmin + w * 0.5, ymin + h * 0.5], dim=-1)
    h_adj = torch.where(w > aspect_ratio * h, w / aspect_ratio, h)
    w_adj = torch.where(w < aspect_ratio * h, h * aspect_ratio, w)
    scale = torch.stack([w_adj / pixel_std, h_adj / pixel_std], dim=-1) * scale_thre
    return center, scale


def make_refine_fn(cfg, model, kpt_colors, n_iters: int = 3):
    """``refine(image, cond_joints, img_wh=None) -> (preds, maxvals)`` after
    ``n_iters`` rounds, on the device of ``model``, in ``TPU.EVAL_DTYPE``.

    One image: image (H, W, 3) RGB uint8/float, cond_joints (P, J, 3) ->
    preds (P, J, 2) image coords, maxvals (P, J, 1).  A batch: image
    (N, H, W, 3), cond_joints (N, P, J, 3), img_wh (N, 2) -> (N, P, J, 2),
    (N, P, J, 1); the N*P crops go through the model as one batch.  ``img_wh``
    is the [width, height] of the real image when ``image`` is padded to a
    bucket: condition boxes clip to it, not to the pad.  maxvals come out in
    the model's dtype.
    """
    img_w, img_h = int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.MODEL.IMAGE_SIZE[1])
    hm_w, hm_h = int(cfg.MODEL.HEATMAP_SIZE[0]), int(cfg.MODEL.HEATMAP_SIZE[1])
    margin = float(cfg.DATASET.BU_BBOX_MARGIN)
    aspect = img_w / img_h
    scale_thre = float(cfg.TEST.SCALE_THRE)
    mode = condition_mode(cfg)
    post = bool(cfg.TEST.POST_PROCESS)
    use_dark = bool(cfg.TEST.USE_DARK)
    device = next(model.parameters()).device
    dtype = compute_dtype(cfg, "EVAL_DTYPE")
    tf32 = dtype == torch.bfloat16 and device.type == "cuda"
    colors = torch.as_tensor(kpt_colors, dtype=torch.float32, device=device)
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)
    # the render's blur matrices and DARK's reflect indices and taps, made now
    # (ops/heatmap.py caches them per device): a CUDA-graph capture of refine
    # may make no host copy, and torch.export's trace must find them made
    with torch.inference_mode():
        render_condition(torch.zeros((1, colors.shape[0], 3), device=device), mode,
                         (img_h, img_w), colors, tf32=tf32)
        if use_dark:
            dark_blur(torch.zeros((1, 1, hm_h, hm_w), dtype=dtype, device=device))

    @torch.inference_mode()
    def refine(image, cond_joints, img_wh=None):
        image = torch.as_tensor(image, device=device)
        cond = torch.as_tensor(cond_joints, dtype=torch.float32, device=device)
        single = image.dim() == 3
        if single:
            image, cond = image[None], cond[None]
            img_wh = None if img_wh is None else torch.as_tensor(img_wh)[None]
        images = image.float()
        N, H, W = images.shape[:3]
        P, J = cond.shape[1], cond.shape[2]
        if img_wh is None:   # the whole image, filled on the device: no host copy
            wh = torch.empty((N, 2), dtype=torch.float32, device=device)
            wh[:, 0], wh[:, 1] = W, H
        else:
            wh = torch.as_tensor(img_wh, dtype=torch.float32, device=device)
        bw = wh[:, 0].repeat_interleave(P)
        bh = wh[:, 1].repeat_interleave(P)
        cond = cond.reshape(N * P, J, cond.shape[-1])
        zeros = torch.zeros(N * P, device=device)

        for _ in range(n_iters):
            center, scale = joints2cs(cond, bw, bh, margin, aspect, scale_thre)
            t_inv = make_affine(center, scale, zeros, (img_w, img_h), inv=True)
            crops = warp_affine_aligned(images, t_inv, (img_h, img_w), tf32=tf32)
            t_fwd = make_affine(center, scale, zeros, (img_w, img_h))
            cond_crop = torch.cat([affine_points(cond[..., :2], t_fwd),
                                   cond[..., 2:]], dim=-1)
            rgb = (crops / 255.0 - mean) / std
            cond_img = render_condition(cond_crop, mode, (img_h, img_w), colors, tf32=tf32)
            x = torch.cat([rgb, cond_img], dim=-1)             # NHWC
            with autocast(device, dtype):
                hm = model(x.permute(0, 3, 1, 2).contiguous())  # (N*P, J, h, w)
            preds, maxvals = get_final_preds(hm, center, scale, (hm_w, hm_h),
                                             post_process=post, use_dark=use_dark)
            cond = torch.cat([preds, maxvals.float()], dim=-1)

        preds = preds.reshape(N, P, J, 2)
        maxvals = maxvals.reshape(N, P, J, 1)
        return (preds[0], maxvals[0]) if single else (preds, maxvals)

    return refine
