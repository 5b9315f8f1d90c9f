"""buctd_tpu_torch rotated warp (K4) on the CPU: the plain two-pass warp
against the JAX Pallas kernel (interpret mode, as tests/test_ops.py runs it)
and against the banded-matmul engine, in one batch mixing rotations 0, 30,
-60 and 90 degrees (90 takes the transposed decomposition).  Max error
< 1e-4 on [0, 1) images: the same f32 tent weights, summed in another order.
The CUDA kernel is held against this plain version by chip_smoke.py and
tests/test_torch_port_cuda.py on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import warp as tw

ROTATIONS = (0.0, 30.0, -60.0, 90.0)


def _batch(out_wh=(96, 128)):
    from buctd_tpu.geometry import make_affine

    rng = np.random.RandomState(0)
    imgs = rng.rand(len(ROTATIONS), 160, 140, 3).astype(np.float32)
    centers = [(70.0, 80.0), (60.0, 90.0), (75.0, 70.0), (70.0, 85.0)]
    scales = [(0.6, 0.7), (0.5, 0.6), (0.7, 0.8), (0.55, 0.7)]
    t = np.stack([make_affine(np.array(c), np.array(s), rot, out_wh, inv=True)
                  for c, s, rot in zip(centers, scales, ROTATIONS)]).astype(np.float32)
    return imgs, t


def test_plain_warp_matches_pallas_and_matmul_engines(monkeypatch):
    import jax.experimental.pallas as pl

    import buctd_tpu.ops.pallas_warp as pw
    from buctd_tpu.ops import warp_affine_rotated

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    imgs, t = _batch()
    got = tw.warp_affine_general(torch.from_numpy(imgs), torch.from_numpy(t), (128, 96))
    assert got.shape == (4, 128, 96, 3) and got.dtype == torch.float32
    got = got.numpy()
    want_pallas = np.asarray(pw.warp_affine_pallas(jnp.asarray(imgs), jnp.asarray(t),
                                                   (128, 96)))
    want_mm = np.asarray(warp_affine_rotated(jnp.asarray(imgs), jnp.asarray(t), (128, 96)))
    for i, rot in enumerate(ROTATIONS):
        assert np.abs(got[i] - want_pallas[i]).max() < 1e-4, rot
        assert np.abs(got[i] - want_mm[i]).max() < 1e-4, rot
        assert np.abs(got[i]).max() > 0.5, rot          # the crop hit the image


def test_transposed_choice_and_guard():
    """|t11| < |t01| picks the transposed decomposition; a zero t11 is
    guarded to 1e-6 as in pallas_warp.py:122."""
    t = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])       # 90 deg: swap
    transposed, tt = tw._sample_affine(t)
    assert transposed and torch.equal(tt[0], t[1]) and torch.equal(tt[1], t[0])
    t = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    transposed, tt = tw._sample_affine(t)
    assert not transposed and float(tt[1, 1]) == pytest.approx(1e-6)


def test_engine_dispatch():
    imgs, t = _batch()
    x, tt = torch.from_numpy(imgs[:1]), torch.from_numpy(t[:1])
    before = tw.warp_resample.launches
    tw.warp_affine_general(x, tt, (128, 96), engine="pallas")
    assert tw.warp_resample.launches == before          # CPU calls do not count
    # 'matmul' is the banded-matmul engine, JAX's warp_affine_rotated, never K4
    from buctd_tpu.ops import warp_affine_rotated

    got = tw.warp_affine_general(x, tt, (128, 96), engine="matmul")
    assert tw.warp_resample.launches == before
    want = np.asarray(warp_affine_rotated(jnp.asarray(imgs[:1]), jnp.asarray(t[:1]),
                                          (128, 96)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        tw.warp_affine_general(x, tt, (128, 96), engine="nope")
    with pytest.raises(ValueError):                     # the kernel wants a card
        tw.warp_resample(x, tt, (128, 96))
