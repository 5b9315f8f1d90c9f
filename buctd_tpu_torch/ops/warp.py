"""Affine crops and bilinear resize (torch), and the rotated-warp kernel K4.

Counterpart of buctd_tpu/ops/warp.py: ``warp_affine_aligned`` (:271) is the
serving crop, two batched matmuls against banded 2-tap weight matrices
(cv2 INTER_LINEAR + BORDER_CONSTANT(0) semantics); ``resize_bilinear`` (:63)
is the CoAM condition resize; ``warp_affine_general`` (:234) is the training
loader's rotated crop.  Its 'pallas' engine (the JAX default on a TPU) is the
hand-written CUDA kernel ``csrc/warp_resample.cu``, the port of
buctd_tpu/ops/pallas_warp.py::_resample_kernel (:30): a two-pass warp, each
pass a per-row 1-D tent resample, fused into one launch for the whole batch
(``warp_resample``) that keeps the intermediate in shared memory and reads
the loader's uint8 bucket and mask rectangle itself.  CPU tensors take
``warp_affine_reference``, the plain version that writes the dense tent sum
as the TPU kernel does.  ``warp_resample.launches`` counts the kernel's
launches (one per call); ``warp_resample_two_pass`` is the two-launch form it
replaced, kept for the A/B.  Images stay NHWC at these signatures, as in the
JAX functions.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .tf32 import tf32_operand


def _axis_taps(coord, in_size: int):
    """Bilinear tap-weight matrix (..., out, in): relu(1 - |src - idx|).  Rows
    whose source lies outside [-1, in_size] are all zero (BORDER_CONSTANT 0)."""
    idx = torch.arange(in_size, dtype=torch.float32, device=coord.device)
    return torch.relu(1.0 - torch.abs(coord[..., None] - idx))


def warp_affine_aligned(images, trans_dst2src, out_hw, tf32: bool = False):
    """Axis-aligned (rot == 0) warp: ``out = Wy @ img @ Wx^T`` per crop.

    images: (N, H, W, C); trans_dst2src: (B, 2, 3) output -> source affines with
    zero off-diagonal terms, B a multiple of N: crops ``[n*P, (n+1)*P)`` come
    from image n (P = B / N; the JAX function takes N == B).  Returns
    (B, out_h, out_w, C) f32.  ``tf32``: both matmuls take TF32 operands
    (``ops/tf32.py::tf32_operand``), as XLA's default precision does on a GPU.
    """
    operand = tf32_operand(tf32)
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

    img = operand(images.float().reshape(n_img, H, W * C))
    rows = torch.matmul(operand(wy.reshape(n_img, P * oh, H)), img)  # (N, P*oh, W*C)
    rows = rows.reshape(B, oh, W, C).transpose(2, 3).reshape(B, oh * C, W)
    out = torch.matmul(operand(rows), operand(wx.transpose(1, 2)))   # (B, oh*C, ow)
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


# ------------------------------------------------------- rotated warp (K4) ----
WARP_ENGINES = ("auto", "pallas", "matmul")


def _sample_affine(t):
    """One (2, 3) output->source affine -> (transposed, [[a, b, e], [c, d, f]]):
    the transposed decomposition when |t11| < |t01| (pallas_warp.py:120), rows
    swapped, t11 guarded to 1e-6 (:122)."""
    transposed = bool(t[1, 1].abs() < t[0, 1].abs())
    tt = t.flip(0) if transposed else t.clone()
    if tt[1, 1].abs() < 1e-6:
        tt[1, 1] = 1e-6
    return transposed, tt


def _resample_rows_reference(img_rcw, alpha, beta_c, beta_o, out_w: int):
    """img (R, C, W) -> (R, C, out_w): out[r, :, o] = sum_w img[r, :, w] *
    relu(1 - |alpha o + beta_c r + beta_o - w|), the dense tent sum of
    pallas_warp.py::_resample_kernel."""
    R, _, W = img_rcw.shape
    dev = img_rcw.device
    o = torch.arange(out_w, dtype=torch.float32, device=dev)
    r = torch.arange(R, dtype=torch.float32, device=dev)
    w = torch.arange(W, dtype=torch.float32, device=dev)
    u = alpha * o[None, :] + beta_c * r[:, None] + beta_o           # (R, out_w)
    wts = torch.relu(1.0 - torch.abs(u[:, None, :] - w[None, :, None]))
    return torch.bmm(img_rcw, wts)                                  # (R, C, out_w)


def warp_affine_reference(images, trans_dst2src, out_hw):
    """Plain version of the two-pass warp, one sample at a time (as the JAX
    ``lax.map``).  images (B, H, W, C), trans_dst2src (B, 2, 3) -> (B, oh, ow, C)
    f32."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    outs = []
    for img, t in zip(images.float(), trans_dst2src.float()):
        transposed, t = _sample_affine(t)
        if transposed:
            img = img.transpose(0, 1)
        a, b, e = t[0]
        c, d, f = t[1]
        i1 = _resample_rows_reference(img.permute(0, 2, 1), a - b * c / d, b / d,
                                      e - (b / d) * f, ow)           # (R, C, ow)
        out = _resample_rows_reference(i1.permute(2, 1, 0), d, c, f, oh)
        outs.append(out.permute(2, 0, 1))                           # (oh, ow, C)
    return torch.stack(outs)


# csrc/warp_resample.cu's fused tile (kTileY output rows, kTileX output
# columns) and the shared floats a tile column may take (kColFloats);
# ``fused_tile_plan`` mirrors the kernel's plan from them
FUSED_TILE = (32, 32)
FUSED_COL_FLOATS = 192
SMEM_PER_BLOCK = 232448          # what a block may take on an H100


def fused_band_max(C: int) -> int:
    """Intermediate rows a tile column holds in shared memory (band_max)."""
    return (FUSED_COL_FLOATS - 32 - C) // C


def fused_col_stride(C: int) -> int:
    """A tile column's stride in floats (col_stride): a multiple of 32 plus C."""
    return -(-fused_band_max(C) * C // 32) * 32 + C


def fused_smem_bytes(C: int) -> int:
    """Shared memory of a fused block: the band ([kTileX][col_stride] f32), a
    staging row of kTileX * C f32 for each of the 8 warps, and the static
    band bounds and sample scalars (2 * kTileX + 1 ints, 11 words)."""
    tx = FUSED_TILE[1]
    return 4 * (tx * fused_col_stride(C) + 8 * tx * C) + 4 * (2 * tx + 1) + 44


def _first_tap(v):
    """The kernel's w0 = (int)floorf(v): NaN to 0, out-of-range values
    saturated to int32."""
    w = torch.floor(v).double().nan_to_num(0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
    return w.to(torch.int64)


def fused_tile_plan(t, H: int, W: int, C: int, out_hw) -> dict:
    """Python mirror of the fused kernel's plan for one sample's (2, 3)
    output->source affine ``t`` over an (H, W, C) source: per tile and chunk
    of output rows, each column's band of intermediate rows [lo, lo + n) that
    pass 1 computes into shared memory.  Returns {"transposed", "band_max",
    "col_stride", "chunk_rows", "smem_bytes", "chunks": [(y0, y1, x0, lo, n)]}
    with lo and n int64 tensors over the tile's columns.  Used by the tests;
    the kernel computes the same on the card."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    ty, tx = FUSED_TILE
    transposed, t = _sample_affine(t.float())
    R = W if transposed else H
    c, d, f = t[1]
    bmax = fused_band_max(C)
    q = torch.tensor(float(bmax - 4)) / d.abs()
    rows = ty if q >= ty - 1 else (1 + int(q) if q >= 1 else 1)
    chunks = []
    for x0 in range(0, ow, tx):
        x = torch.arange(x0, min(x0 + tx, ow), dtype=torch.float32)
        for y0 in range(0, oh, ty):
            for ya in range(y0, min(y0 + ty, oh), rows):
                yb = min(ya + rows, y0 + ty, oh)
                wa, wb = (_first_tap(d * float(y) + c * x + f) for y in (ya, yb - 1))
                first = torch.minimum(wa, wb).clamp(min=0)
                last = torch.minimum(torch.maximum(wa, wb) + 1, torch.tensor(R - 1))
                n = (last - first + 1).clamp(0, bmax)
                chunks.append((ya, yb, x0, torch.where(n > 0, first, 0), n))
    return {"transposed": transposed, "band_max": bmax, "col_stride": fused_col_stride(C),
            "chunk_rows": rows, "smem_bytes": fused_smem_bytes(C), "chunks": chunks}


def mask_inside(mask_box, H: int, W: int):
    """(B, H, W) bool: pixel (row, col) lies in its sample's [x, y, w, h]
    rectangle, compared in f32 image coordinates (the device loader's
    crop-aug mask, buctd_tpu/data/device_pipeline.py:108-116)."""
    bx, by, bw, bh = (mask_box[:, i, None, None] for i in range(4))
    xs = torch.arange(W, dtype=torch.float32, device=mask_box.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=mask_box.device)[None, :, None]
    return (xs >= bx) & (xs < bx + bw) & (ys >= by) & (ys < by + bh)


def apply_mask_box(images, mask_box):
    """``images.float() * inside``: (B, H, W, C) f32 with the pixels outside
    each sample's mask rectangle zeroed, as the kernel reads a uint8 source."""
    _, H, W, _ = images.shape
    return images.float() * mask_inside(mask_box, H, W)[..., None]


def _check_mask_pairing(images, mask_box):
    """The kernel reads a uint8 source with its mask rectangles and an f32
    one without: the loaders' bucket, and the A/B's images."""
    if (mask_box is not None) != (images.dtype == torch.uint8):
        raise TypeError(f"the warp takes uint8 images with a mask box or f32 ones without, "
                        f"got {images.dtype} images and "
                        f"{'a' if mask_box is not None else 'no'} mask box")


@functools.lru_cache(maxsize=None)
def _warp_fn(symbol: str):
    """A C entry of csrc/warp_resample.cu (built and loaded at first call)."""
    from .._build import load

    fn = getattr(load("warp_resample"), symbol)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {"buctd_warp_fused": [p, i, p, p, p] + [i] * 6 + [p],
                   "buctd_warp_pass1": [p, p, p] + [i] * 6 + [p],
                   "buctd_warp_pass2": [p, p, p] + [i] * 7 + [p]}[symbol]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(name, images, trans_dst2src, dtypes):
    if images.device.type != "cuda":
        raise ValueError(f"{name} is the CUDA kernel, got {images.device}")
    if images.dim() != 4 or tuple(trans_dst2src.shape) != (images.shape[0], 2, 3):
        raise ValueError(f"want (B, H, W, C) images and (B, 2, 3) affines, got "
                         f"{tuple(images.shape)}, {tuple(trans_dst2src.shape)}")
    if images.dtype not in dtypes or trans_dst2src.dtype != torch.float32:
        raise TypeError(f"{name} takes {'/'.join(str(t)[6:] for t in dtypes)} images and "
                        f"f32 affines, got {images.dtype}, {trans_dst2src.dtype}")
    if not (images.is_contiguous() and trans_dst2src.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
    if trans_dst2src.device != images.device:
        raise ValueError(f"tensors on {images.device} and {trans_dst2src.device}")


def warp_resample(images, trans_dst2src, out_hw, mask_box=None):
    """The warp on the card: one launch of csrc/warp_resample.cu's fused
    kernel over the whole batch.  images (B, H, W, C) uint8 with mask_box
    (B, 4) f32 [x, y, w, h] (pixels outside read 0), or f32 with no mask box;
    trans_dst2src (B, 2, 3) f32; contiguous, on one CUDA device -> (B, oh, ow,
    C) f32."""
    _check_cuda_args("warp_resample", images, trans_dst2src, (torch.float32, torch.uint8))
    _check_mask_pairing(images, mask_box)
    B, H, W, C = images.shape
    if mask_box is not None and (tuple(mask_box.shape) != (B, 4)
                                 or mask_box.dtype != torch.float32
                                 or not mask_box.is_contiguous()
                                 or mask_box.device != images.device):
        raise ValueError(f"want a contiguous (B, 4) f32 mask box on {images.device}, got "
                         f"{tuple(mask_box.shape)} {mask_box.dtype} on {mask_box.device}")
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = torch.empty((B, oh, ow, C), dtype=torch.float32, device=images.device)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = _warp_fn("buctd_warp_fused")(
            images.data_ptr(), int(images.dtype == torch.uint8), trans_dst2src.data_ptr(),
            None if mask_box is None else mask_box.data_ptr(), out.data_ptr(), B, H, W, C,
            oh, ow, stream)
        if err != 0:
            raise RuntimeError(f"fused warp launch failed: cudaError_t {err} at "
                               f"{tuple(images.shape)} {images.dtype} -> {(oh, ow)}")
        warp_resample.launches += 1
    return out


warp_resample.launches = 0


def warp_resample_two_pass(images, trans_dst2src, out_hw):
    """The two-pass form the fused kernel replaced, for the A/B: two launches
    of csrc/warp_resample.cu over the whole batch with the (B, max(H, W), ow,
    C) intermediate in device memory.  f32 images only; bit for bit equal to
    ``warp_resample``."""
    _check_cuda_args("warp_resample_two_pass", images, trans_dst2src, (torch.float32,))
    B, H, W, C = images.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    rows = max(H, W)
    tmp = torch.empty((B, rows, ow, C), dtype=torch.float32, device=images.device)
    out = torch.empty((B, oh, ow, C), dtype=torch.float32, device=images.device)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = _warp_fn("buctd_warp_pass1")(images.data_ptr(), trans_dst2src.data_ptr(),
                                           tmp.data_ptr(), B, H, W, C, ow, rows, stream)
        if err != 0:
            raise RuntimeError(f"warp pass 1 launch failed: cudaError_t {err} at "
                               f"{tuple(images.shape)} -> {(oh, ow)}")
        warp_resample_two_pass.launches += 1
        err = _warp_fn("buctd_warp_pass2")(tmp.data_ptr(), trans_dst2src.data_ptr(),
                                           out.data_ptr(), B, H, W, C, oh, ow, rows,
                                           stream)
        if err != 0:
            raise RuntimeError(f"warp pass 2 launch failed: cudaError_t {err} at "
                               f"{tuple(images.shape)} -> {(oh, ow)}")
        warp_resample_two_pass.launches += 1
    return out


warp_resample_two_pass.launches = 0


def warp_affine_general(images, trans_dst2src, out_hw, engine: str = "auto",
                        mask_box=None):
    """General batched affine warp (any rotation), the ``TPU.WARP_ENGINE`` knob
    of buctd_tpu/ops/warp.py:234.  'auto' and 'pallas' take K4: the fused CUDA
    kernel for CUDA tensors (another dtype raises), the plain version of
    ``images.float() * inside`` for CPU tensors.  images: uint8 with mask_box,
    (B, 4) [x, y, w, h] per sample whose outside pixels read 0 (the loaders'
    bucket), or f32 with mask_box None; another pairing raises on either
    device.  'matmul' (the banded-matmul engine) is not ported and raises."""
    if engine not in WARP_ENGINES:
        raise ValueError(f"unknown warp engine {engine!r} (want auto|matmul|pallas)")
    if engine == "matmul":
        raise NotImplementedError(
            "TPU.WARP_ENGINE='matmul' (the banded-matmul warp) is not ported to "
            "buctd_tpu_torch: ROADMAP Queue 1 item 8, 'training: the rest'; "
            "use 'auto' or 'pallas' (the K4 kernel)")
    _check_mask_pairing(images, mask_box)
    trans = trans_dst2src.float().contiguous()
    if images.device.type == "cpu":
        x = images.float() if mask_box is None else apply_mask_box(images, mask_box.float())
        return warp_affine_reference(x, trans, out_hw)
    if mask_box is not None:
        mask_box = mask_box.float().contiguous()
    return warp_resample(images.contiguous(), trans, out_hw, mask_box)
