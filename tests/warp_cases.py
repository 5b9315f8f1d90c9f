"""Affines for the fused warp's tests (K4, csrc/warp_resample.cu), shared by
the CPU tests (tests/test_torch_port_warp_fused.py) and the card tests
(tests/test_torch_port_cuda.py); numpy only, no JAX.

A source of SRC_HW pixels and an output of OUT_HW, neither a multiple of the
fused tile (32 x 32); rotations 0, +-30, +-60 and +-90 degrees (+-60 and +-90
take the transposed decomposition) at |d|, the source rows per output row,
from 0.2 to 8; the guarded d = 1e-6; and random affines from a seed.
"""

import numpy as np

SRC_HW = (53, 61)
OUT_HW = (37, 45)
ROTATIONS = (0.0, 30.0, -30.0, 60.0, -60.0, 90.0, -90.0)
SCALES = (0.2, 1.0, 3.0, 8.0)       # source pixels per output pixel


def affine(center, s, rot_deg, out_hw=OUT_HW):
    """(2, 3) f32 output->source affine: output pixel (x, y) -> source, s source
    pixels per output pixel, rotated by rot_deg about the output's centre,
    which maps to ``center``."""
    th = np.deg2rad(rot_deg)
    a00, a01, a10, a11 = s * np.cos(th), -s * np.sin(th), s * np.sin(th), s * np.cos(th)
    ox, oy = out_hw[1] / 2.0, out_hw[0] / 2.0
    return np.array([[a00, a01, center[0] - (a00 * ox + a01 * oy)],
                     [a10, a11, center[1] - (a10 * ox + a11 * oy)]], np.float32)


def cases():
    """[(name, (2, 3) f32 affine)] over SRC_HW -> OUT_HW."""
    rng = np.random.RandomState(5)
    h, w = SRC_HW
    out = []
    for rot in ROTATIONS:
        for s in SCALES:
            c = (w / 2 + rng.uniform(-6, 6), h / 2 + rng.uniform(-6, 6))
            out.append((f"rot{rot:+.0f}-s{s}", affine(c, s, rot)))
    # t11 = t01 = 0: untransposed, d guarded to 1e-6
    out.append(("guarded-d", np.array([[1.0, 0.0, 3.0], [0.5, 0.0, 2.0]], np.float32)))
    for k in range(4):
        c = (rng.uniform(0, w), rng.uniform(0, h))
        out.append((f"random{k}", affine(c, float(np.exp(rng.uniform(np.log(0.2), np.log(8.0)))),
                                         rng.uniform(-180, 180))))
    return out


def images(n, C, seed=0, dtype=np.float32):
    """(n, *SRC_HW, C) images from a seed: 0..255 noise, f32 or uint8."""
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (n, *SRC_HW, C)).astype(np.uint8)
    return (rng.rand(n, *SRC_HW, C) * 255.0).astype(np.float32)


def mask_boxes(n, seed=0):
    """(n, 4) f32 [x, y, w, h] rectangles that cut into the source, some
    starting off it, with fractional edges."""
    rng = np.random.RandomState(seed)
    h, w = SRC_HW
    return np.stack([rng.uniform(-5, w / 2, n), rng.uniform(-5, h / 2, n),
                     rng.uniform(5, w, n), rng.uniform(5, h, n)], 1).astype(np.float32)
