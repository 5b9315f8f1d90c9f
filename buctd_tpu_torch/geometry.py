"""Affine geometry for crop and decode: batched torch forms and host numpy forms.

Counterpart of buctd_tpu/geometry.py: the batched JAX forms
(``make_affine_jax``, ``affine_points_jax``, ``transform_preds_jax``) as torch
functions, and the float64 numpy forms the training loader's host planning
uses (``host_affine`` = the JAX ``make_affine``, ``affine_transform_points``,
``fliplr_joints``, ``xywh2cs``, ``flip_pairs_to_perm``).  The
reference's 3-point ``cv2.getAffineTransform`` solve is a similarity transform,
written here in closed form: ``scale`` is in units of ``PIXEL_STD`` px, only
``scale[..., 0]`` sets the isotropic zoom, the box center maps to the output
center, rotation is CCW degrees about the center.  Everything is elementwise
f32, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PIXEL_STD = 200.0


def make_affine(center, scale, rot, output_size, inv: bool = False):
    """(..., 2) center, (..., 2) scale, (...,) rot deg -> (..., 2, 3) affines
    mapping source -> crop coords (or crop -> source with ``inv``)."""
    center = torch.as_tensor(center, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=center.device)
    rot = torch.as_tensor(rot, dtype=torch.float32, device=center.device)

    src_w = scale[..., 0] * PIXEL_STD
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    rot_rad = math.pi * rot / 180.0
    cs, sn = torch.cos(rot_rad), torch.sin(rot_rad)
    d0x, d0y = dst_w * 0.5, dst_h * 0.5

    if not inv:
        s = dst_w / src_w
        a00, a01, a10, a11 = s * cs, s * sn, s * -sn, s * cs
        tx = d0x - (a00 * center[..., 0] + a01 * center[..., 1])
        ty = d0y - (a10 * center[..., 0] + a11 * center[..., 1])
    else:
        s = src_w / dst_w
        a00, a01, a10, a11 = s * cs, s * -sn, s * sn, s * cs
        tx = center[..., 0] - (a00 * d0x + a01 * d0y)
        ty = center[..., 1] - (a10 * d0x + a11 * d0y)
    row0 = torch.stack([a00, a01, tx], dim=-1)
    row1 = torch.stack([a10, a11, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def affine_points(pts, trans):
    """Apply (..., 2, 3) affines to (..., N, 2) points."""
    t = trans[..., None, :, :]
    x = t[..., 0, 0] * pts[..., 0] + t[..., 0, 1] * pts[..., 1] + t[..., 0, 2]
    y = t[..., 1, 0] * pts[..., 0] + t[..., 1, 1] * pts[..., 1] + t[..., 1, 2]
    return torch.stack([x, y], dim=-1)


def transform_preds(coords, center, scale, output_size):
    """Inverse-affine unprojection of (B, J, 2) crop coords to source coords."""
    trans = make_affine(center, scale, torch.zeros(center.shape[:-1],
                                                   device=center.device),
                        output_size, inv=True)
    return affine_points(coords, trans)


# ----------------------------------------------------------- host (numpy) ----
def host_affine(center, scale, rot: float, output_size, inv: bool = False) -> np.ndarray:
    """float64 (2, 3) affine of one crop (buctd_tpu/geometry.py::make_affine,
    transforms.py:86-118 in closed form)."""
    center = np.asarray(center, dtype=np.float64)
    scale = np.asarray(scale, dtype=np.float64)
    if scale.ndim == 0:
        scale = np.array([float(scale), float(scale)])
    src_w = scale[0] * PIXEL_STD
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    rot_rad = np.pi * rot / 180.0
    cs, sn = np.cos(rot_rad), np.sin(rot_rad)
    dst0 = np.array([dst_w * 0.5, dst_h * 0.5])
    if not inv:
        A = (dst_w / src_w) * np.array([[cs, sn], [-sn, cs]])
        t = dst0 - A @ center
    else:
        A = (src_w / dst_w) * np.array([[cs, -sn], [sn, cs]])
        t = center - A @ dst0
    return np.concatenate([A, t[:, None]], axis=1).astype(np.float64)


def affine_transform_points(pts, trans) -> np.ndarray:
    """Apply a 2x3 affine to an (N, 2) array of points (float64)."""
    pts = np.asarray(pts, dtype=np.float64)
    return pts @ trans[:, :2].T + trans[:, 2]


def fliplr_joints(joints, joints_vis, width, matched_parts):
    """Horizontal flip of joint coords + left/right pair swap
    (transforms.py:61-75); like the reference, returns ``joints * joints_vis``."""
    joints = np.array(joints, dtype=np.float64)
    joints_vis = np.array(joints_vis)
    joints[:, 0] = width - joints[:, 0] - 1
    for a, b in matched_parts:
        joints[[a, b]] = joints[[b, a]]
        joints_vis[[a, b]] = joints_vis[[b, a]]
    return joints * joints_vis, joints_vis


def xywh2cs(x, y, w, h, aspect_ratio, scale_thre=1.25, pixel_std=PIXEL_STD):
    """Box -> (center, scale) with aspect-ratio fix and inflation
    (JointsDataset.py:546-562)."""
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    if w > aspect_ratio * h:
        h = w * 1.0 / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / pixel_std, h / pixel_std], dtype=np.float32)
    if center[0] != -1:
        scale = scale * scale_thre
    return center, scale


def flip_pairs_to_perm(num_joints: int, flip_pairs) -> np.ndarray:
    """Left/right pair list -> permutation vector, for gather-based flipping."""
    perm = np.arange(num_joints)
    for a, b in flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return perm
