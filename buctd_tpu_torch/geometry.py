"""Batched affine geometry for crop and decode (torch).

Counterpart of the batched JAX forms in buctd_tpu/geometry.py
(``make_affine_jax``, ``affine_points_jax``, ``transform_preds_jax``).  The
reference's 3-point ``cv2.getAffineTransform`` solve is a similarity transform,
written here in closed form: ``scale`` is in units of ``PIXEL_STD`` px, only
``scale[..., 0]`` sets the isotropic zoom, the box center maps to the output
center, rotation is CCW degrees about the center.  Everything is elementwise
f32, as in the JAX package.
"""

from __future__ import annotations

import math

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
