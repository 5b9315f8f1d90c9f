"""buctd_tpu_torch ops vs buctd_tpu on the same numpy inputs (CPU).

Tolerances: geometry and warps are f32 arithmetic in both packages with a
different summation order, so 1e-4 px / 1e-3 intensity levels on 0..255
pixels; renders peak at 255, so 1e-3 absolute; decode coordinates 1e-4 px.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

T = torch.from_numpy
J = jnp.asarray


def _poses(rng, B, Jn, lo, hi):
    return rng.uniform(lo, hi, (B, Jn, 2)).astype(np.float32)


def test_geometry_matches_jax():
    from buctd_tpu.geometry import (affine_points_jax, make_affine_jax,
                                    transform_preds_jax)
    from buctd_tpu_torch.geometry import affine_points, make_affine, transform_preds

    rng = np.random.RandomState(0)
    center = rng.uniform(50, 400, (5, 2)).astype(np.float32)
    scale = rng.uniform(0.3, 2.0, (5, 2)).astype(np.float32)
    rot = rng.uniform(-45, 45, (5,)).astype(np.float32)
    pts = _poses(rng, 5, 14, 0, 96)
    for inv in (False, True):
        got = make_affine(T(center), T(scale), T(rot), (288, 384), inv=inv)
        want = make_affine_jax(J(center), J(scale), J(rot), (288, 384), inv=inv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(affine_points(T(pts), got).numpy(),
                                   np.asarray(affine_points_jax(J(pts), want)),
                                   rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(
        transform_preds(T(pts), T(center), T(scale), (72, 96)).numpy(),
        np.asarray(transform_preds_jax(J(pts), J(center), J(scale), (72, 96))),
        rtol=1e-6, atol=1e-4)


def test_warp_affine_aligned_matches_jax():
    from buctd_tpu.geometry import make_affine_jax
    from buctd_tpu.ops.warp import warp_affine_aligned as jax_warp
    from buctd_tpu_torch.ops.warp import warp_affine_aligned

    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (2, 90, 120, 3)).astype(np.float32)
    center = rng.uniform(10, 110, (6, 2)).astype(np.float32)
    scale = rng.uniform(0.1, 0.8, (6, 2)).astype(np.float32)
    t = np.array(make_affine_jax(J(center), J(scale), jnp.zeros(6), (48, 64), inv=True))
    # the port's N*P form: crops [3n, 3n+3) come from image n
    got = warp_affine_aligned(T(img), T(t), (64, 48)).numpy()
    want = np.asarray(jax_warp(J(np.repeat(img, 3, 0)), J(t), (64, 48)))
    assert got.shape == (6, 64, 48, 3)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-5)


def test_resize_bilinear_matches_jax():
    from buctd_tpu.ops.warp import resize_bilinear as jax_resize
    from buctd_tpu_torch.ops.warp import resize_bilinear

    x = np.random.RandomState(2).rand(2, 128, 96, 3).astype(np.float32) * 255
    for hw in ((32, 24), (16, 12), (40, 30), (128, 96)):
        np.testing.assert_allclose(resize_bilinear(T(x), hw).numpy(),
                                   np.asarray(jax_resize(J(x), hw)),
                                   atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("mode", ["colored", "stacked", "plain"])
def test_render_condition_matches_jax(mode):
    from buctd_tpu.data.pipeline import render_condition as jax_render
    from buctd_tpu_torch.data.pipeline import render_condition

    rng = np.random.RandomState(3)
    pts = _poses(rng, 3, 14, -10, 110)
    pts[0, 5] = pts[0, 2]             # a later joint on the same pixel overwrites
    pts[1] = -5.0                     # all joints off-canvas: an all-zero render
    colors = rng.randint(0, 256, (14, 3)).astype(np.float64)
    got = render_condition(T(pts), mode, (128, 96), colors).numpy()
    want = np.asarray(jax_render(J(pts), mode, (128, 96), colors))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("post,dark", [(True, False), (False, True), (False, False)])
def test_get_final_preds_matches_jax(post, dark):
    from buctd_tpu.ops.decode import get_final_preds as jax_decode
    from buctd_tpu_torch.ops.decode import get_final_preds

    rng = np.random.RandomState(4)
    B, Jn, h, w = 3, 14, 32, 24
    ys, xs = np.mgrid[0:h, 0:w]
    mu = rng.uniform(1, 23, (B, Jn, 2))
    hm = np.exp(-((xs - mu[..., 0, None, None]) ** 2 + (ys - mu[..., 1, None, None]) ** 2)
                / 8.0) + 0.01 * rng.rand(B, Jn, h, w)
    hm = hm.astype(np.float32)
    hm[0, 0] = -1.0                   # max <= 0: prediction zeroed
    center = rng.uniform(100, 200, (B, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (B, 2)).astype(np.float32)
    p, m = get_final_preds(T(hm), T(center), T(scale), (w, h), post_process=post,
                           use_dark=dark)
    pw, mw = jax_decode(J(hm), J(center), J(scale), (w, h), post_process=post,
                        use_dark=dark)
    np.testing.assert_allclose(p.numpy(), np.asarray(pw), atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(mw), atol=1e-6)


def test_joints2cs_matches_jax():
    from buctd_tpu.core.refine import joints2cs_jax
    from buctd_tpu_torch.core.refine import joints2cs

    rng = np.random.RandomState(5)
    joints = rng.uniform(-20, 340, (4, 14, 3)).astype(np.float32)
    joints[0, :5, :2] = 0             # missing keypoints
    joints[1, :, :2] = 0              # no valid keypoint: the full image
    wh = np.array([[320, 240], [320, 240], [300, 200], [330, 250]], np.float32)
    c, s = joints2cs(T(joints), T(wh[:, 0]), T(wh[:, 1]), 25.0, 96 / 128, 1.25)
    for i in range(4):
        cw, sw = joints2cs_jax(J(joints[i:i + 1]), float(wh[i, 0]), float(wh[i, 1]),
                               25.0, 96 / 128, 1.25)
        np.testing.assert_allclose(c.numpy()[i], np.asarray(cw)[0], atol=1e-4)
        np.testing.assert_allclose(s.numpy()[i], np.asarray(sw)[0], atol=1e-6)
