"""Axis-aligned affine crop and bilinear resize (torch).

Counterpart of buctd_tpu/ops/warp.py: ``warp_affine_aligned`` (:271) is the
main-path crop, two batched matmuls against banded 2-tap weight matrices
(cv2 INTER_LINEAR + BORDER_CONSTANT(0) semantics); ``resize_bilinear`` (:63)
is the CoAM condition resize.  Images stay NHWC at these signatures, as in the
JAX functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _axis_taps(coord, in_size: int):
    """Bilinear tap-weight matrix (..., out, in): relu(1 - |src - idx|).  Rows
    whose source lies outside [-1, in_size] are all zero (BORDER_CONSTANT 0)."""
    idx = torch.arange(in_size, dtype=torch.float32, device=coord.device)
    return torch.relu(1.0 - torch.abs(coord[..., None] - idx))


def warp_affine_aligned(images, trans_dst2src, out_hw):
    """Axis-aligned (rot == 0) warp: ``out = Wy @ img @ Wx^T`` per crop.

    images: (N, H, W, C); trans_dst2src: (B, 2, 3) output -> source affines with
    zero off-diagonal terms, B a multiple of N: crops ``[n*P, (n+1)*P)`` come
    from image n (P = B / N; the JAX function takes N == B).  Returns
    (B, out_h, out_w, C) f32.
    """
    n_img, H, W, C = images.shape
    B = trans_dst2src.shape[0]
    if B % n_img:
        raise ValueError(f"{B} crops do not split over {n_img} images")
    P = B // n_img
    oh, ow = int(out_hw[0]), int(out_hw[1])
    t = trans_dst2src.float()
    ox = torch.arange(ow, dtype=torch.float32, device=t.device)
    oy = torch.arange(oh, dtype=torch.float32, device=t.device)
    sx = t[:, 0, 0, None] * ox + t[:, 0, 2, None]          # (B, ow)
    sy = t[:, 1, 1, None] * oy + t[:, 1, 2, None]          # (B, oh)
    wy = _axis_taps(sy, H)                                  # (B, oh, H)
    wx = _axis_taps(sx, W)                                  # (B, ow, W)

    img = images.float().reshape(n_img, H, W * C)
    rows = torch.matmul(wy.reshape(n_img, P * oh, H), img)  # (N, P*oh, W*C)
    rows = rows.reshape(B, oh, W, C).transpose(2, 3).reshape(B, oh * C, W)
    out = torch.matmul(rows, wx.transpose(1, 2))            # (B, oh*C, ow)
    return out.reshape(B, oh, C, ow).transpose(2, 3)


def resize_bilinear_nchw(x, out_hw):
    """(..., C, H, W) -> (..., C, oh, ow): half-pixel centers, no antialias."""
    return F.interpolate(x, size=(int(out_hw[0]), int(out_hw[1])), mode="bilinear",
                         align_corners=False, antialias=False)


def resize_bilinear(x, out_hw):
    """(B, H, W, C) -> (B, oh, ow, C) bilinear resize with half-pixel centers and
    NO antialias, as torch's interpolate(align_corners=False) is — the JAX
    function's stated semantics."""
    return resize_bilinear_nchw(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)
