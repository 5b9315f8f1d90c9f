"""Depthwise Gaussian smoothing (reference: lib/utils/gaussian.py:7-70).

Counterpart of buctd_tpu/utils/gaussian.py: the reference's depthwise conv2d
module as a callable on the separable blur of ops/heatmap.py (per-channel
separable filtering, reflect-101 border, the kernel normalised to sum 1).
"""

from __future__ import annotations

import numpy as np

from ..ops.heatmap import _sep_blur


def gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    """exp(-((x - mean) / sigma)^2 / 2), normalised to sum 1 (gaussian.py:27-45)."""
    mean = (kernel_size - 1) / 2.0
    x = np.arange(kernel_size, dtype=np.float64)
    k = np.exp(-(((x - mean) / sigma) ** 2) / 2.0)
    return (k / k.sum()).astype(np.float32)


class GaussianSmoothing:
    """smooth(x) on (..., H, W, C) NHWC tensors, each channel filtered on its
    own (the reference module's surface; ``channels`` is implied)."""

    def __init__(self, channels: int = 17, kernel_size: int = 11, sigma: float = 6.0,
                 dim: int = 2):
        if dim != 2:
            raise ValueError("only 2-D smoothing is used by the reference")
        del channels
        self.kernel = gaussian_kernel1d(kernel_size, sigma)

    def __call__(self, x):
        return _sep_blur(x, self.kernel)
