"""Constants of the per-sample pipeline used by serving.

Counterpart of the constants at buctd_tpu/data/joints_dataset.py:32-48.  The
rest of that module (decode, augmentation, crop for training) is not ported yet.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _rainbow(x: np.ndarray) -> np.ndarray:
    """matplotlib's 'rainbow' colormap (gnuplot formulas 33, 13, 10 clipped to
    [0, 1]) at x in [0, 1]; written out so the port needs no matplotlib."""
    r = np.abs(2.0 * x - 0.5)
    g = np.sin(x * np.pi)
    b = np.cos(x * np.pi / 2.0)
    return np.clip(np.stack([r, g, b], -1), 0.0, 1.0)


def rainbow_colors(num: int) -> np.ndarray:
    """(J, 3) keypoint colors from the 'rainbow' cmap's 256-entry table, matching
    JointsDataset.get_colors_from_cmap (JointsDataset.py:463-467)."""
    lut = _rainbow(np.linspace(0.0, 1.0, 256))
    out = [tuple(int(c * 255) for c in lut[i]) for i in range(0, 256, 256 // num)]
    return np.array(out[:num], np.float64)
