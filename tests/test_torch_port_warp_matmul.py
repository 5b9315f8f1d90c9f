"""buctd_tpu_torch's warps of buctd_tpu/ops/warp.py beside K4, on the CPU:
the banded-matmul engine (``warp_affine_rotated``, ``TPU.WARP_ENGINE
matmul``), the gather forms (``warp_affine``, ``warp_affine_shear``) and
``crop_images``, against the JAX functions on the same inputs.

Rotations 0, +-30, +-60 (the transposed decomposition) and +-90 degrees, on
[0, 1) images.  Tolerances: the gather forms compute the same f32 taps and
blends in the same order, 1e-6; the banded-matmul engine sums its tent
weights in another order than XLA's einsum and derives its coordinates in
another order of f32 operations, 1e-4 (the limit tests/test_torch_port_warp.py
holds K4's plain version to); ``crop_images`` the same.  The engine through
``warp_affine_general`` (a uint8 bucket with mask rectangles) and the device
loader with ``TPU.WARP_ENGINE matmul`` against JAX's, launching no K4.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import warp as tw

ROTATIONS = (0.0, 30.0, -30.0, 60.0, -60.0, 90.0, -90.0)
GATHER_ATOL = 1e-6
MATMUL_ATOL = 1e-4


def _batch(out_wh=(96, 128)):
    from buctd_tpu.geometry import make_affine

    rng = np.random.RandomState(0)
    imgs = rng.rand(len(ROTATIONS), 160, 140, 3).astype(np.float32)
    centers = rng.uniform([60, 70], [80, 90], (len(ROTATIONS), 2))
    scales = rng.uniform(0.5, 0.8, (len(ROTATIONS), 2))
    t = np.stack([make_affine(c, s, rot, out_wh, inv=True)
                  for c, s, rot in zip(centers, scales, ROTATIONS)]).astype(np.float32)
    return imgs, t, centers, scales


@pytest.mark.parametrize("name,atol", [("warp_affine_rotated", MATMUL_ATOL),
                                       ("warp_affine_shear", GATHER_ATOL),
                                       ("warp_affine", GATHER_ATOL)])
def test_warps_match_jax(name, atol):
    from buctd_tpu.ops import warp as jw

    imgs, t, _, _ = _batch()
    got = getattr(tw, name)(torch.from_numpy(imgs), torch.from_numpy(t), (128, 96))
    assert got.shape == (len(ROTATIONS), 128, 96, 3) and got.dtype == torch.float32
    want = np.asarray(getattr(jw, name)(jnp.asarray(imgs), jnp.asarray(t), (128, 96)))
    for i, rot in enumerate(ROTATIONS):
        err = np.abs(got[i].numpy() - want[i]).max()
        assert err <= atol, (rot, err)
        assert np.abs(want[i]).max() > 0.5, rot          # the crop hit the image


def test_guarded_d_and_transposed_choice_match_jax():
    """t11 = t01 = 0 (the guarded d = 1e-6, untransposed) and a 90-degree
    affine (transposed) through the engine, as JAX's ``lax.cond``."""
    from buctd_tpu.ops import warp as jw

    imgs = np.random.RandomState(2).rand(2, 40, 50, 3).astype(np.float32)
    t = np.array([[[1.0, 0.0, 3.0], [0.5, 0.0, 2.0]],
                  [[0.0, 1.0, 2.0], [1.0, 0.0, 1.0]]], np.float32)
    got = tw.warp_affine_rotated(torch.from_numpy(imgs), torch.from_numpy(t), (20, 30))
    want = np.asarray(jw.warp_affine_rotated(jnp.asarray(imgs), jnp.asarray(t), (20, 30)))
    np.testing.assert_allclose(got.numpy(), want, atol=MATMUL_ATOL, rtol=0)


@pytest.mark.parametrize("rotated", [True, False], ids=["rotated", "aligned"])
def test_crop_images_matches_jax(rotated):
    from buctd_tpu.ops import warp as jw

    imgs, _, centers, scales = _batch()
    rots = np.asarray(ROTATIONS, np.float32) if rotated else None
    got = tw.crop_images(torch.from_numpy(imgs), centers, scales,
                         None if rots is None else torch.from_numpy(rots), (96, 128))
    want = np.asarray(jw.crop_images(jnp.asarray(imgs), jnp.asarray(centers, jnp.float32),
                                     jnp.asarray(scales, jnp.float32),
                                     None if rots is None else jnp.asarray(rots), (96, 128)))
    assert got.shape == want.shape == (len(ROTATIONS), 128, 96, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=MATMUL_ATOL, rtol=0)


def test_engine_matmul_reads_the_masked_bucket():
    """'matmul' through warp_affine_general: a uint8 bucket with mask
    rectangles against JAX's engine on the masked f32 images (JAX
    device_pipeline.py:108-118); K4 is never launched."""
    from buctd_tpu.ops import warp as jw

    imgs, t, _, _ = _batch()
    u8 = (imgs * 255).astype(np.uint8)
    box = np.tile(np.array([[20.5, 10.0, 90.0, 120.25]], np.float32), (len(ROTATIONS), 1))
    before = tw.warp_resample.launches
    got = tw.warp_affine_general(torch.from_numpy(u8), torch.from_numpy(t), (128, 96),
                                 "matmul", mask_box=torch.from_numpy(box))
    assert tw.warp_resample.launches == before
    ys, xs = np.mgrid[:160, :140].astype(np.float32)
    inside = ((xs >= box[0, 0]) & (xs < box[0, 0] + box[0, 2])
              & (ys >= box[0, 1]) & (ys < box[0, 1] + box[0, 3]))
    want = np.asarray(jw.warp_affine_rotated(jnp.asarray(u8.astype(np.float32)
                                                         * inside[None, ..., None]),
                                             jnp.asarray(t), (128, 96)))
    np.testing.assert_allclose(got.numpy(), want, atol=MATMUL_ATOL * 255, rtol=0)
    with pytest.raises(TypeError):                 # uint8 without its mask box
        tw.warp_affine_general(torch.from_numpy(u8), torch.from_numpy(t), (128, 96), "matmul")


def test_device_loader_matmul_engine_matches_jax(tmp_path):
    """The device loader passes TPU.WARP_ENGINE through (JAX
    device_pipeline.py:118): with 'matmul' its train batch's crops are
    JAX's matmul-engine crops, within the engine's limit on 0..255 pixels
    before the round (so at most one level after it) and exactly where the
    two sums round alike; the render and targets as the loader test."""
    from test_data_pipeline import _seed_all, _tiny_coco
    from test_torch_port_config import COAM_YAML, load_cfg

    from buctd_tpu.data import get_dataset as jax_dataset
    from buctd_tpu.data.device_pipeline import DeviceLoader as JaxLoader
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader

    ann_file, _ = _tiny_coco(tmp_path, J=14)
    opts = ["MODEL.IMAGE_SIZE", "[96, 128]", "MODEL.HEATMAP_SIZE", "[24, 32]",
            "TPU.DEVICE_PIPELINE", "True", "TPU.WARP_ENGINE", "matmul",
            "DATASET.ROT_FACTOR", "45", "DATASET.TRAIN_IMAGE_DIR", str(tmp_path),
            "DATASET.TRAIN_ANNOTATION_FILE", ann_file]
    jcfg, cfg = load_cfg("jax", COAM_YAML, opts), load_cfg("torch", COAM_YAML, opts)
    ours = DeviceLoader(get_dataset(cfg, is_train=True), cfg, batch_size=4, num_workers=1,
                        device="cpu")
    theirs = JaxLoader(jax_dataset(jcfg, is_train=True), jcfg, batch_size=4, num_workers=1)
    _seed_all(7)
    jb = next(iter(theirs))
    _seed_all(7)
    before = tw.warp_resample.launches
    tb = next(iter(ours))
    ours.close()
    assert tw.warp_resample.launches == before
    assert np.abs(tb["rotation"]).max() > 0
    got = tb["input"].permute(0, 2, 3, 1).numpy()
    want = np.asarray(jb["input"])
    std = np.array([0.229, 0.224, 0.225], np.float32)
    level = np.abs(got[..., :3] - want[..., :3]) * std * 255.0   # in 0..255 levels
    assert level.max() <= 1.0 + 1e-3 and np.mean(level < 1e-3) > 0.99, level.max()
    np.testing.assert_allclose(got[..., 3:], want[..., 3:], atol=1e-3)
    np.testing.assert_allclose(tb["target"].numpy(),
                               np.asarray(jb["target"]).transpose(0, 3, 1, 2), atol=1e-4)
