"""Heatmap decoding on the device (torch).

Counterpart of buctd_tpu/ops/decode.py, itself the vectorized form of the
reference's lib/core/inference.py:19-152: argmax with first-max tie-breaking,
the POST_PROCESS +-0.25 px gradient-sign nudge, the DARK Taylor refinement, and
the inverse affine back to source-image coordinates.  Heatmaps are
(B, J, h, w), as in the JAX functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry import transform_preds
from .heatmap import _sep_blur, opencv_gaussian_kernel


def get_max_preds(heatmaps):
    """(B, J, h, w) -> preds (B, J, 2) f32 crop-frame coords, maxvals (B, J, 1);
    preds are zeroed where the max is <= 0."""
    B, J, h, w = heatmaps.shape
    flat = heatmaps.reshape(B, J, h * w)
    maxvals = flat.amax(dim=2)
    idx = flat.argmax(dim=2)   # documented first-max tie-breaking
    x = (idx % w).float()
    y = torch.floor(idx.float() / w)
    preds = torch.stack([x, y], dim=-1)
    mask = (maxvals > 0.0).float()[..., None]
    return preds * mask, maxvals[..., None]


def _gather_hm(heatmaps, py, px):
    """heatmaps (B, J, h, w); py/px (B, J) int -> values (B, J), indices clipped."""
    B, J, h, w = heatmaps.shape
    py = torch.clamp(py, 0, h - 1)
    px = torch.clamp(px, 0, w - 1)
    flat = heatmaps.reshape(B, J, h * w)
    return torch.gather(flat, 2, (py * w + px)[..., None])[..., 0]


def post_process_nudge(heatmaps, coords):
    """+-0.25 px shift along the local gradient sign (inference.py:64-77)."""
    B, J, h, w = heatmaps.shape
    px = torch.floor(coords[..., 0] + 0.5).long()
    py = torch.floor(coords[..., 1] + 0.5).long()
    inb = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    dx = _gather_hm(heatmaps, py, px + 1) - _gather_hm(heatmaps, py, px - 1)
    dy = _gather_hm(heatmaps, py + 1, px) - _gather_hm(heatmaps, py - 1, px)
    delta = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25
    return coords + delta * inb[..., None].float()


def dark_blur(heatmaps, kernel: int = 11):
    """The DARK modulation blur (inference.py:113-127): zero-pad a
    (kernel-1)/2 border, Gaussian-blur, crop back, rescale each map to its
    original max."""
    B, J, h, w = heatmaps.shape
    border = (kernel - 1) // 2
    x = heatmaps.reshape(B * J, h, w, 1)
    orig_max = x.amax(dim=(1, 2, 3), keepdim=True)
    xp = F.pad(x, (0, 0, border, border, border, border))
    blurred = _sep_blur(xp, opencv_gaussian_kernel(kernel))
    blurred = blurred[:, border:-border, border:-border, :]
    new_max = blurred.amax(dim=(1, 2, 3), keepdim=True)
    ratio = orig_max / torch.where(new_max == 0, torch.ones_like(new_max), new_max)
    scaled = blurred * torch.where(new_max == 0, torch.zeros_like(new_max), ratio)
    return scaled.reshape(B, J, h, w)


def dark_refine(heatmaps, coords, kernel: int = 11):
    """DARK Taylor refinement (inference.py:90-109, 131-142) on RAW maps."""
    B, J, h, w = heatmaps.shape
    hm = torch.log(torch.clamp(dark_blur(heatmaps, kernel), min=1e-10))
    px = coords[..., 0].to(torch.int64)
    py = coords[..., 1].to(torch.int64)
    inb = (px > 1) & (px < w - 2) & (py > 1) & (py < h - 2)

    def g(dy, dx):
        return _gather_hm(hm, py + dy, px + dx)

    dx = 0.5 * (g(0, 1) - g(0, -1))
    dy = 0.5 * (g(1, 0) - g(-1, 0))
    dxx = 0.25 * (g(0, 2) - 2.0 * g(0, 0) + g(0, -2))
    dxy = 0.25 * (g(1, 1) - g(-1, 1) - g(1, -1) + g(-1, -1))
    dyy = 0.25 * (g(2, 0) - 2.0 * g(0, 0) + g(-2, 0))

    det = dxx * dyy - dxy * dxy
    ok = inb & (det != 0.0)
    safe_det = torch.where(ok, det, torch.ones_like(det))
    # offset = -H^-1 @ grad, H = [[dxx, dxy], [dxy, dyy]]
    off_x = -(dyy * dx - dxy * dy) / safe_det
    off_y = -(-dxy * dx + dxx * dy) / safe_det
    offset = torch.stack([off_x, off_y], dim=-1) * ok[..., None].float()
    return coords + offset


def get_final_preds(heatmaps, center, scale, heatmap_size, post_process: bool = True,
                    use_dark: bool = False):
    """argmax [-> nudge | DARK] -> inverse affine (inference.py:51-87, 131-152).
    Returns preds (B, J, 2) in source-image coords and maxvals (B, J, 1)."""
    coords, maxvals = get_max_preds(heatmaps)
    if use_dark:
        coords = dark_refine(heatmaps, coords)
    elif post_process:
        coords = post_process_nudge(heatmaps, coords)
    return transform_preds(coords, center, scale, heatmap_size), maxvals
