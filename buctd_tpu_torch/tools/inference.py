"""Standalone inference from condition poses on the user's own images.

Counterpart of the repository's tools/inference.py (the reference's
tools/inference.py):

    python -m buctd_tpu_torch.tools.inference --cfg <yaml> --image <path>
        [--model <.pth>] [--vis-thres T] [--device cuda] [KEY VAL ...]

``run_ctd_inference(images, conditions, model_path, vis_thres, ...)``: for each
image, each condition pose becomes a crop (the nonzero keypoints' box plus a
25 px margin, scaled x1.25 to the model's aspect), cut on the host with
``cv2.warpAffine``; its condition is rendered in colour on the device, and
the image's crops run through the model as one batch and are decoded there.
Predictions whose confidence is below ``vis_thres`` become NaN.
``refine_iters`` > 1 runs core/refine.py's refinement loop instead, each round
taking the previous round's keypoints as its conditions.

The model runs in ``TPU.COMPUTE_DTYPE``, as JAX's tool builds it
(``compute_dtype(config)``): the yamls and the default config say bfloat16,
so the forward runs under bf16 autocast with f32 parameters unless the
caller passes ``TPU.COMPUTE_DTYPE float32``.  The condition colours are the
reference's fixed palettes (14 joints: CrowdPose's, otherwise COCO's), not
the training set's rainbow.  The CLI runs on the card unless ``--device cpu``
is passed; it prints the (1, 1, J, 3) predictions of one demo pose around
the image's centre.
"""

from __future__ import annotations

import argparse
import types

import numpy as np
import torch

# fixed per-dataset palettes, as in the reference (tools/inference.py:75-78);
# they differ from the training-time rainbow colours
COLORS_CROWDPOSE = [[245, 53, 53], [245, 125, 45], [253, 206, 20], [206, 244, 54],
                    [118, 253, 27], [47, 254, 47], [25, 245, 113], [15, 243, 197],
                    [14, 199, 245], [44, 126, 249], [13, 13, 249], [128, 47, 249],
                    [205, 38, 247], [245, 48, 206]]
COLORS_COCO = [[245, 59, 59], [249, 104, 25], [253, 183, 15], [233, 245, 41],
               [162, 252, 32], [84, 247, 34], [31, 252, 57], [20, 246, 126],
               [5, 249, 206], [52, 215, 249], [33, 136, 252], [11, 39, 248],
               [93, 46, 249], [156, 29, 244], [235, 49, 247], [245, 47, 187],
               [253, 44, 117]]


def palette(num_joints: int) -> np.ndarray:
    """The reference's fixed condition colours for ``num_joints``."""
    return np.array(COLORS_CROWDPOSE if num_joints == 14 else COLORS_COCO, np.float64)


def model_config(config):
    """``config`` with ``TPU.EVAL_DTYPE`` set to its ``TPU.COMPUTE_DTYPE``: the
    dtype JAX's tool builds its model in, which is the one the port's forward,
    decode and refinement read."""
    cfg = config.clone()
    cfg.defrost()
    cfg.TPU.EVAL_DTYPE = cfg.TPU.COMPUTE_DTYPE
    cfg.freeze()
    return cfg


def get_model(config, model_path=None, device="cuda"):
    """The cfg's model with ``model_path``'s weights (a BUCTD ``.pth``/``.pt``,
    loaded with ``strict=True``; none: the reference's random init), its
    preNet fused as ``TPU.FUSED_PRENET`` says (tools/inference.py:32)."""
    from ..convert import load_torch_checkpoint
    from ..models import get_model as build
    from ..models.fuse import maybe_fuse_prenet

    model = build(config, device=device)
    if model_path and model_path.endswith((".pth", ".pt")):
        model.load_state_dict(load_torch_checkpoint(model_path), strict=True)
    elif model_path:
        raise NotImplementedError(f"{model_path!r}: buctd_tpu_torch loads .pth/.pt "
                                  "checkpoints only (orbax directories are ROADMAP "
                                  "Queue 1 items 7 and 8, 'the orbax reader')")
    return maybe_fuse_prenet(config, model)


def get_pose_feature(config, model, image_input, cond_joints_list, vis_thres=0.0):
    """All condition crops of one image -> (P, J, 3) predictions in image
    coordinates (tools/inference.py:85).  ``config`` is the model's
    (``model_config``)."""
    import cv2

    from ..data.joints_dataset import IMAGENET_MEAN, IMAGENET_STD
    from ..geometry import affine_transform_points, host_affine, joints2box, xywh2cs
    from ..models import autocast, compute_dtype
    from ..ops.decode import get_final_preds
    from ..ops.heatmap import render_condition_colored

    device = next(model.parameters()).device
    colors = palette(int(config.MODEL.NUM_JOINTS))
    image_input = np.asarray(image_input)
    img_w, img_h = int(config.MODEL.IMAGE_SIZE[0]), int(config.MODEL.IMAGE_SIZE[1])
    hm_w, hm_h = int(config.MODEL.HEATMAP_SIZE[0]), int(config.MODEL.HEATMAP_SIZE[1])
    aspect = img_w / img_h

    crops, conds, centers, scales = [], [], [], []
    for cond_joints in cond_joints_list:
        cond_joints = np.asarray(cond_joints, np.float64)
        bbox = joints2box(cond_joints, margin=25,
                          img_w=image_input.shape[1], img_h=image_input.shape[0])
        center, scale = xywh2cs(*bbox, aspect_ratio=aspect, scale_thre=1.25)
        trans = host_affine(center, scale, 0, (img_w, img_h))
        crops.append(cv2.warpAffine(image_input.astype(np.float32), trans, (img_w, img_h),
                                    flags=cv2.INTER_LINEAR))
        tj = cond_joints.copy()
        tj[:, :2] = affine_transform_points(tj[:, :2], trans)
        conds.append(tj)
        centers.append(center)
        scales.append(scale)

    def on_device(a):
        return torch.as_tensor(np.stack(a).astype(np.float32), device=device)

    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)
    with torch.inference_mode():
        x = (on_device(crops) / 255.0 - mean) / std
        cond_img = render_condition_colored(on_device(conds), colors, (img_h, img_w))
        inp = torch.cat([x, cond_img], dim=-1).permute(0, 3, 1, 2).contiguous()
        with autocast(device, compute_dtype(config, "EVAL_DTYPE")):
            hm = model(inp)
        preds, maxvals = get_final_preds(hm, on_device(centers), on_device(scales),
                                         (hm_w, hm_h),
                                         post_process=bool(config.TEST.POST_PROCESS))
        preds = torch.cat([preds, maxvals.float()], dim=2).cpu().numpy()
    preds[preds[:, :, 2] < vis_thres] = np.nan
    return preds


def load_config(args):
    """A config from ``args.cfg`` and ``args.opts`` (the tools' surface)."""
    from ..config import default_config, update_config

    cfg = default_config()
    update_config(cfg, args)
    return cfg


def run_ctd_inference(images, conditions, model_path=None, vis_thres=0.0, args=None,
                      refine_iters=1, config=None, device="cuda"):
    """images: list of (H, W, 3) RGB arrays; conditions: per image a list of
    (J, 2+) poses.  Returns (N, P, J, 3) predictions in image coordinates
    (tools/inference.py:132).  The config is ``config``, else the one of
    ``args`` (``cfg``, ``opts``)."""
    from ..core.refine import make_refine_fn

    if config is None:
        if args is None:
            raise ValueError("run_ctd_inference needs config= or args= (cfg, opts)")
        config = load_config(args)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ctd_inference: CUDA is not available; pass device='cpu' "
                           "to run on the CPU")
    cfg = model_config(config)
    model = get_model(cfg, model_path, device)
    if refine_iters <= 1:
        return np.array([get_pose_feature(cfg, model, img, conds, vis_thres)
                         for img, conds in zip(images, conditions)])
    refine = make_refine_fn(cfg, model, palette(int(cfg.MODEL.NUM_JOINTS)),
                            n_iters=refine_iters)
    all_preds = []
    for img, conds in zip(images, conditions):
        conds = np.asarray(conds, np.float32)
        if conds.shape[-1] == 2:
            conds = np.concatenate([conds, np.ones((*conds.shape[:-1], 1), np.float32)], -1)
        preds, maxvals = refine(np.asarray(img), conds)
        out = torch.cat([preds, maxvals.float()], dim=2).cpu().numpy()
        out[out[:, :, 2] < vis_thres] = np.nan
        all_preds.append(out)
    return np.array(all_preds)


def main(argv=None) -> np.ndarray:
    parser = argparse.ArgumentParser(description="BUCTD inference from condition poses")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--image", required=True)
    parser.add_argument("--model", default="")
    parser.add_argument("--vis-thres", type=float, default=0.0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    a = parser.parse_args(argv)
    cfg = load_config(types.SimpleNamespace(cfg=a.cfg, opts=a.opts))

    from ..data.joints_dataset import imread_rgb

    img = imread_rgb(a.image)
    J = int(cfg.MODEL.NUM_JOINTS)
    center = np.array([img.shape[1] / 2, img.shape[0] / 2])
    demo_cond = center + np.random.RandomState(0).uniform(-60, 60, (J, 2))
    preds = run_ctd_inference([img], [[demo_cond]], a.model or None, a.vis_thres,
                              config=cfg, device=a.device)
    print(preds)
    return preds


if __name__ == "__main__":
    main()
