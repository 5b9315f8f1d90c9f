"""The fused warp (K4, csrc/warp_resample.cu::warp_fused_kernel) on the CPU.

(a) ``ops/warp.py::fused_tile_plan``, the Python mirror of the kernel's tile
plan: every tap with a non-zero weight in the dense pass-2 sum of the plain
version (``_resample_rows_reference``) lies in the band of intermediate rows
that the plan computes into shared memory for the tile and chunk of rows
whose output uses it, in both decompositions, at |d| from 0.2 to 8, at the
guarded d = 1e-6, for sizes that are no multiple of the tile; and the plan's
shared memory fits a block.  The plan's constants are read from the kernel
source, so the two change together.
(b) uint8 images with a mask rectangle: ``warp_affine_general`` on the CPU
equals the plain warp of ``images.float() * inside`` bit for bit, and JAX's
Pallas warp (interpret mode) on those masked f32 images within 1e-4 of the
0..255 range (tests/test_torch_port_warp.py's 1e-4 on [0, 1) images: the same
f32 tent weights, summed in another order).
(c) ``DeviceLoader._crops`` on the CPU, which now hands the uint8 bucket and
the mask boxes to the warp, gives the loader's former chain (the cast, the
mask multiply, the warp of f32 images) bit for bit, and its 'input' is the
host Loader's normalisation and render of those crops.
(d) The warp takes uint8 images with mask boxes and f32 ones without, and
refuses another pairing; chip_smoke.py's count of the source pixels the warp
reads (its K4 bytes bounds), with a mask and without, equals the count of
pixels on which the plain warp's output depends.
The kernel itself is held against its two-pass form and the plain version on
the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warp_cases
from buctd_tpu_torch.ops import warp as tw

CASES = warp_cases.cases()
KERNEL_SOURCE = (Path(__file__).resolve().parents[1] / "buctd_tpu_torch" / "csrc"
                 / "warp_resample.cu")


def _nonzero_taps(t, C):
    """The dense pass-2 weights of the plain version for one sample:
    (oh, ow, R) bool, output (y, x) reads intermediate row r with a non-zero
    tent weight (pallas_warp.py's relu(1 - |d y + c x + f - r|))."""
    oh, ow = warp_cases.OUT_HW
    H, W = warp_cases.SRC_HW
    transposed, tt = tw._sample_affine(torch.from_numpy(t))
    R = W if transposed else H
    c, d, f = tt[1]
    o = torch.arange(oh, dtype=torch.float32)
    r = torch.arange(ow, dtype=torch.float32)
    u = d * o[None, :] + c * r[:, None] + f                       # (ow, oh), as the reference
    w = torch.arange(R, dtype=torch.float32)
    wts = torch.relu(1.0 - torch.abs(u[:, :, None] - w))          # (ow, oh, R)
    return (wts > 0).permute(1, 0, 2), R


def test_plan_constants_match_kernel_source():
    src = KERNEL_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert tw.FUSED_TILE == (const("kTileY"), const("kTileX"))
    assert tw.FUSED_COL_FLOATS == const("kColFloats")
    assert "(kColFloats - 32 - C) / C" in src and "/ 32 * 32 + C" in src
    for C in (1, 3):
        bmax, stride = tw.fused_band_max(C), tw.fused_col_stride(C)
        assert stride % 32 == C and bmax * C <= stride <= tw.FUSED_COL_FLOATS


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("name,t", CASES, ids=[n for n, _ in CASES])
def test_plan_bands_hold_every_tap(name, t, C):
    oh, ow = warp_cases.OUT_HW
    H, W = warp_cases.SRC_HW
    plan = tw.fused_tile_plan(torch.from_numpy(t), H, W, C, (oh, ow))
    taps, R = _nonzero_taps(t, C)
    assert taps.any(dim=-1).any(), "the crop reads the source somewhere"
    covered = torch.zeros(oh, ow, dtype=torch.int64)
    rows = torch.arange(R)
    for ya, yb, x0, lo, n in plan["chunks"]:
        assert 1 <= yb - ya <= plan["chunk_rows"] and (n <= plan["band_max"]).all()
        cols = slice(x0, x0 + len(lo))
        covered[ya:yb, cols] += 1
        in_band = (rows >= lo[:, None]) & (rows < (lo + n)[:, None])          # (cols, R)
        outside = taps[ya:yb, cols] & ~in_band[None]
        assert not outside.any(), (name, ya, yb, x0, outside.nonzero()[:4].tolist())
    assert (covered == 1).all()               # each output in one chunk of one tile
    assert plan["smem_bytes"] <= tw.SMEM_PER_BLOCK
    d = abs(float(t[0, 1] if plan["transposed"] else t[1, 1]))
    if d * (tw.FUSED_TILE[0] - 1) + 4 > plan["band_max"]:
        assert plan["chunk_rows"] < tw.FUSED_TILE[0]    # large |d|: the band is walked in chunks


def test_plan_at_large_scale_and_guarded_d():
    """|d| = 8 walks a tile in chunks of 7 rows (C = 3: 52-row bands); the
    guarded d = 1e-6 takes the whole tile, two rows a column."""
    H, W = warp_cases.SRC_HW
    big = dict(CASES)["rot+0-s8.0"]
    plan = tw.fused_tile_plan(torch.from_numpy(big), H, W, 3, warp_cases.OUT_HW)
    assert plan["band_max"] == 52 and plan["chunk_rows"] == 7
    flat = tw.fused_tile_plan(torch.from_numpy(dict(CASES)["guarded-d"]), H, W, 3,
                              warp_cases.OUT_HW)
    assert flat["chunk_rows"] == tw.FUSED_TILE[0]
    assert max(int(c[4].max()) for c in flat["chunks"]) == 2


def test_uint8_mask_matches_masked_f32_and_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    import buctd_tpu.ops.pallas_warp as pw

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, interpret=True, **k))
    picked = [dict(CASES)[n] for n in ("rot+0-s1.0", "rot-30-s0.2", "rot+60-s3.0",
                                       "rot-90-s1.0")]
    trans = torch.from_numpy(np.stack(picked))
    u8 = torch.from_numpy(warp_cases.images(len(picked), 3, seed=2, dtype=np.uint8))
    box = torch.from_numpy(warp_cases.mask_boxes(len(picked), seed=2))
    got = tw.warp_affine_general(u8, trans, warp_cases.OUT_HW, mask_box=box)
    masked = u8.float() * tw.mask_inside(box, *warp_cases.SRC_HW)[..., None]
    assert (masked == 0).any() and (masked > 0).any()
    want = tw.warp_affine_reference(masked, trans, warp_cases.OUT_HW)
    assert torch.equal(got, want)
    pallas = np.asarray(pw.warp_affine_pallas(jnp.asarray(masked.numpy()),
                                              jnp.asarray(trans.numpy()), warp_cases.OUT_HW))
    assert np.abs(got.numpy() - pallas).max() < 1e-4 * 255.0
    assert got.abs().max() > 100.0                      # the crops hit the image


def test_mask_pairing_refused():
    """uint8 images take their mask boxes and f32 images none, on the CPU as
    on the card (the kernel is built for those two pairings only)."""
    t = torch.from_numpy(dict(CASES)["rot+0-s1.0"])[None]
    box = torch.tensor([[0.0, 0.0, 10.0, 10.0]])
    f32 = torch.from_numpy(warp_cases.images(1, 3))
    with pytest.raises(TypeError):
        tw.warp_affine_general(f32, t, warp_cases.OUT_HW, mask_box=box)
    with pytest.raises(TypeError):
        tw.warp_affine_general(f32.to(torch.uint8), t, warp_cases.OUT_HW)


@pytest.mark.parametrize("masked", [False, True], ids=["whole", "masked"])
@pytest.mark.parametrize("name", ["rot+30-s1.0", "rot-60-s3.0", "rot+90-s0.2", "random1"])
def test_chip_smoke_read_pixels_match_the_gradient(name, masked):
    """chip_smoke.py's K4 bytes bounds count the source pixels the warp reads
    with a non-zero weight (inside the mask rectangle where there is one):
    exactly the pixels on which the plain warp's output depends, those whose
    gradient is non-zero (a sum of products of positive tent weights)."""
    import chip_smoke

    t = torch.from_numpy(dict(CASES)[name])[None]
    images = torch.from_numpy(warp_cases.images(1, 1)).requires_grad_()
    tw.warp_affine_reference(images, t, warp_cases.OUT_HW).sum().backward()
    used = images.grad[0, ..., 0] != 0
    box = None
    if masked:
        box = torch.tensor([[14.5, 11.25, 30.75, 24.5]])   # the middle, fractional edges
        used &= tw.mask_inside(box, *warp_cases.SRC_HW)[0]
    got = chip_smoke.warp_read_pixels(torch, tw, t, warp_cases.SRC_HW, warp_cases.OUT_HW, box)
    assert got == int(used.sum()) > 0


def _crops_before(loader, images, trans_inv, mask_box):
    """The loader's crops before the warp read the bucket itself: cast, mask
    multiply, then the warp of the f32 images and the rounding
    (data/device_pipeline.py as of the two-pass kernel)."""
    B, H, W, _ = images.shape
    x = images.float()
    bx, by, bw, bh = (mask_box[:, i, None, None] for i in range(4))
    xs = torch.arange(W, dtype=torch.float32, device=x.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=x.device)[None, :, None]
    inside = (xs >= bx) & (xs < bx + bw) & (ys >= by) & (ys < by + bh)
    x = x * inside[..., None]
    crops = tw.warp_affine_general(x, trans_inv, (loader.img_h, loader.img_w), loader.engine)
    return torch.round(crops)


def test_device_batch_matches_former_chain(tmp_path):
    from test_data_pipeline import _tiny_coco
    from test_torch_port_config import COAM_YAML, load_cfg

    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.geometry import make_affine

    ann_file, _ = _tiny_coco(tmp_path, J=14)
    cfg = load_cfg("torch", COAM_YAML, [
        "MODEL.IMAGE_SIZE", "[96, 128]", "MODEL.HEATMAP_SIZE", "[24, 32]",
        "TPU.DEVICE_PIPELINE", "True", "DATASET.TRAIN_IMAGE_DIR", str(tmp_path),
        "DATASET.TRAIN_ANNOTATION_FILE", ann_file])
    loader = DeviceLoader(get_dataset(cfg, is_train=True), cfg, batch_size=4, num_workers=1,
                          device="cpu")
    loader.close()
    rng = np.random.RandomState(9)
    B, H, W = 4, 96, 128
    images = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8))
    trans = make_affine(torch.from_numpy(rng.uniform([30, 30], [100, 70], (B, 2))),
                        torch.from_numpy(rng.uniform(0.3, 0.7, (B, 2))),
                        torch.tensor([0.0, 25.0, -70.0, 90.0]), (96, 128), inv=True)
    mask_box = torch.from_numpy(np.stack([rng.uniform(0, 40, B), rng.uniform(0, 30, B),
                                          rng.uniform(40, 120, B), rng.uniform(30, 90, B)],
                                         1).astype(np.float32))
    mask_box[0] = torch.tensor([0.0, 0.0, W, H])        # no crop-aug: the whole image
    joints = rng.uniform(0, 96, (B, 14, 3)).astype(np.float32)
    joints_vis = (rng.rand(B, 14, 3) > 0.2).astype(np.float32)
    cond = np.concatenate([rng.uniform(0, 96, (B, 14, 2)),
                           np.ones((B, 14, 1))], -1).astype(np.float32)
    args = (images, trans.float(), mask_box)
    crops = loader._crops(*args)
    assert torch.equal(crops, _crops_before(loader, *args))
    meta = {"joints": joints, "joints_vis": joints_vis, "cond_joints": cond}
    got = loader._dense(dict(meta), crops)
    assert got["input"].shape == (B, 6, 128, 96)
    assert torch.equal(got["input"], loader.input_fn(crops, torch.from_numpy(cond)))
