"""Condition renderings and the separable Gaussian blur (torch).

Counterpart of buctd_tpu/ops/heatmap.py.  The reference splats each condition
joint at ``(y-1, x-1)`` and blurs with cv2.GaussianBlur(ksize=(15, 15)), i.e.
sigma = 0.3*((15-1)*0.5 - 1) + 0.8 = 2.6 by OpenCV's rule.  Blur(splat) is
linear, so the blurred image is computed in closed form: per joint, the outer
product of two rows of the reflect-101 blur matrix, summed with one batched
matmul.  Renders return NHWC (B, H, W, c) f32, as the JAX functions do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def opencv_gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """1-D Gaussian kernel matching cv2.getGaussianKernel (ksize > 7 or sigma > 0)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _reflect101_index(size: int, r: int) -> np.ndarray:
    idx = np.abs(np.arange(-r, size + r))
    return np.where(idx >= size, 2 * size - 2 - idx, idx)


def _sep_blur(x, kernel: np.ndarray):
    """Separable blur over the H and W axes of (..., H, W, C), reflect-101
    border (cv2's default BORDER_REFLECT_101)."""
    k = len(kernel)
    r = k // 2
    h, w = x.shape[-3], x.shape[-2]
    iy = torch.as_tensor(_reflect101_index(h, r), device=x.device)
    xp = x.index_select(-3, iy)
    x = sum(float(kernel[i]) * xp.narrow(-3, i, h) for i in range(k))
    ix = torch.as_tensor(_reflect101_index(w, r), device=x.device)
    xp = x.index_select(-2, ix)
    return sum(float(kernel[i]) * xp.narrow(-2, i, w) for i in range(k))


@functools.lru_cache(maxsize=8)
def _blur_matrix(size: int, ksize: int) -> np.ndarray:
    """(size, size) matrix M with M @ v == separable blur of v (reflect-101 pad)."""
    kernel = opencv_gaussian_kernel(ksize)
    idx = _reflect101_index(size, ksize // 2)
    m = np.zeros((size, size), np.float32)
    for t in range(ksize):
        m[np.arange(size), idx[t:t + size]] += kernel[t]
    return m


def _delta_profiles(points, out_hw, ksize: int, overwrite: bool):
    """Blurred per-joint axis profiles for a splat at (y-1, x-1).

    points (B, J, 2) -> ky (B, J, H), kx (B, J, W), keep (B, J).  ``keep`` is the
    strict bounds test 0 < x < W, 0 < y < H and, with ``overwrite`` (single
    canvas), drops a joint that a LATER joint lands on (the reference's write
    order: the later joint overwrites the pixel).
    """
    H, W = out_hw
    pts = torch.trunc(points.float()).to(torch.int64)
    x, y = pts[..., 0], pts[..., 1]
    valid = (x > 0) & (x < W) & (y > 0) & (y < H)
    xc = torch.clamp(x - 1, 0, W - 1)
    yc = torch.clamp(y - 1, 0, H - 1)

    keep = valid
    if overwrite:
        same = ((xc[:, :, None] == xc[:, None, :])
                & (yc[:, :, None] == yc[:, None, :]))
        J = points.shape[1]
        later = torch.ones((J, J), dtype=torch.bool,
                           device=points.device).triu(1)   # j' > j
        clobbered = torch.any(same & later & valid[:, None, :], dim=2)
        keep = valid & ~clobbered

    by = torch.as_tensor(_blur_matrix(H, ksize), device=points.device)
    bx = torch.as_tensor(_blur_matrix(W, ksize), device=points.device)
    kf = keep[..., None].float()
    ky = by.T[yc] * kf                                      # (B, J, H)
    kx = bx.T[xc] * kf                                      # (B, J, W)
    return ky, kx, keep


def render_condition_colored(cond_joints, colors, out_hw):
    """3-channel rainbow condition image (get_condition_image_colored).

    cond_joints (B, J, 2+); colors (J, 3).  Returns (B, H, W, 3) f32
    peak-normalized to 255 across all channels.
    """
    H, W = int(out_hw[0]), int(out_hw[1])
    colors = torch.as_tensor(colors, dtype=torch.float32, device=cond_joints.device)
    ky, kx, _ = _delta_profiles(cond_joints[..., :2], (H, W), 15, overwrite=True)
    B, J = ky.shape[:2]
    kyc = ky[..., None] * colors[None, :, None, :]          # (B, J, H, 3)
    canvas = torch.matmul(kyc.reshape(B, J, H * 3).transpose(1, 2), kx)
    canvas = canvas.reshape(B, H, 3, W).transpose(2, 3)     # (B, H, W, 3)
    am = canvas.amax(dim=(1, 2, 3), keepdim=True)
    return torch.where(am == 0, canvas, canvas / am * 255.0)


def render_condition_stacked(cond_joints, out_hw):
    """J-channel condition, one blurred point per channel, each channel
    peak-normalized on its own (get_stacked_condition).  (B, H, W, J) f32."""
    ky, kx, _ = _delta_profiles(cond_joints[..., :2], out_hw, 15, overwrite=False)
    canvas = torch.einsum("bjh,bjw->bhwj", ky, kx) * 255.0
    am = canvas.amax(dim=(1, 2), keepdim=True)
    return torch.where(am == 0, canvas, canvas / am * 255.0)


def render_condition_plain(cond_joints, out_hw):
    """1-channel condition replicated x3 (get_condition_image).  The reference
    casts the final map to int (JointsDataset.py:514): kept as a trunc.  The
    peak normalization divides first, so every peak pixel is exactly 255: the
    f32 product canvas * (255 / am) lands on 254.99998 for some peaks, which
    the trunc turns into 254 (XLA evaluates the JAX expression as the
    division-first form)."""
    ky, kx, _ = _delta_profiles(cond_joints[..., :2], out_hw, 15, overwrite=True)
    canvas = torch.matmul(ky.transpose(1, 2), kx) * 255.0  # (B, H, W)
    am = canvas.amax(dim=(1, 2), keepdim=True)
    hm = torch.trunc(torch.where(am == 0, canvas, canvas / am * 255.0))
    return hm[..., None].expand(*hm.shape, 3).contiguous()
