"""Affine crops and bilinear resize (torch), and the rotated-warp kernel K4.

Counterpart of buctd_tpu/ops/warp.py: ``warp_affine_aligned`` (:271) is the
serving crop, two batched matmuls against banded 2-tap weight matrices
(cv2 INTER_LINEAR + BORDER_CONSTANT(0) semantics); ``resize_bilinear`` (:63)
is the CoAM condition resize; ``warp_affine_general`` (:234) is the training
loader's rotated crop.  Its 'pallas' engine (the JAX default on a TPU) is the
hand-written CUDA kernel ``csrc/warp_resample.cu``, the port of
buctd_tpu/ops/pallas_warp.py::_resample_kernel (:30): a two-pass warp, each
pass a per-row 1-D tent resample, one launch per pass for the whole batch.
CPU tensors take ``warp_affine_reference``, the plain version that writes the
dense tent sum as the TPU kernel does.  ``warp_resample.launches`` counts the
kernel launches (two per call).  Images stay NHWC at these signatures, as in
the JAX functions.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F


def _axis_taps(coord, in_size: int):
    """Bilinear tap-weight matrix (..., out, in): relu(1 - |src - idx|).  Rows
    whose source lies outside [-1, in_size] are all zero (BORDER_CONSTANT 0)."""
    idx = torch.arange(in_size, dtype=torch.float32, device=coord.device)
    return torch.relu(1.0 - torch.abs(coord[..., None] - idx))


def warp_affine_aligned(images, trans_dst2src, out_hw):
    """Axis-aligned (rot == 0) warp: ``out = Wy @ img @ Wx^T`` per crop.

    images: (N, H, W, C); trans_dst2src: (B, 2, 3) output -> source affines with
    zero off-diagonal terms, B a multiple of N: crops ``[n*P, (n+1)*P)`` come
    from image n (P = B / N; the JAX function takes N == B).  Returns
    (B, out_h, out_w, C) f32.
    """
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

    img = images.float().reshape(n_img, H, W * C)
    rows = torch.matmul(wy.reshape(n_img, P * oh, H), img)  # (N, P*oh, W*C)
    rows = rows.reshape(B, oh, W, C).transpose(2, 3).reshape(B, oh * C, W)
    out = torch.matmul(rows, wx.transpose(1, 2))            # (B, oh*C, ow)
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


@functools.lru_cache(maxsize=None)
def _warp_fn(symbol: str):
    """A C entry of csrc/warp_resample.cu (built and loaded at first call)."""
    from .._build import load

    fn = getattr(load("warp_resample"), symbol)
    p, i = ctypes.c_void_p, ctypes.c_int
    n_ints = 6 if symbol == "buctd_warp_pass1" else 7
    fn.argtypes = [p, p, p] + [i] * n_ints + [p]
    fn.restype = ctypes.c_int
    return fn


def warp_resample(images, trans_dst2src, out_hw):
    """The two-pass warp on the card: two launches of csrc/warp_resample.cu
    over the whole batch.  images (B, H, W, C) and trans_dst2src (B, 2, 3), f32,
    contiguous, on one CUDA device -> (B, oh, ow, C) f32."""
    if images.device.type != "cuda":
        raise ValueError(f"warp_resample is the CUDA kernel, got {images.device}")
    if images.dim() != 4 or tuple(trans_dst2src.shape) != (images.shape[0], 2, 3):
        raise ValueError(f"want (B, H, W, C) images and (B, 2, 3) affines, got "
                         f"{tuple(images.shape)}, {tuple(trans_dst2src.shape)}")
    if images.dtype != torch.float32 or trans_dst2src.dtype != torch.float32:
        raise TypeError(f"warp_resample takes f32, got {images.dtype}, "
                        f"{trans_dst2src.dtype}")
    if not (images.is_contiguous() and trans_dst2src.is_contiguous()):
        raise ValueError("warp_resample needs contiguous tensors")
    if trans_dst2src.device != images.device:
        raise ValueError(f"tensors on {images.device} and {trans_dst2src.device}")
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
        warp_resample.launches += 1
        err = _warp_fn("buctd_warp_pass2")(tmp.data_ptr(), trans_dst2src.data_ptr(),
                                           out.data_ptr(), B, H, W, C, oh, ow, rows,
                                           stream)
        if err != 0:
            raise RuntimeError(f"warp pass 2 launch failed: cudaError_t {err} at "
                               f"{tuple(images.shape)} -> {(oh, ow)}")
        warp_resample.launches += 1
    return out


warp_resample.launches = 0


def warp_affine_general(images, trans_dst2src, out_hw, engine: str = "auto"):
    """General batched affine warp (any rotation), the ``TPU.WARP_ENGINE`` knob
    of buctd_tpu/ops/warp.py:234.  'auto' and 'pallas' take K4: the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors.  'matmul' (the
    banded-matmul engine) is not ported and raises."""
    if engine not in WARP_ENGINES:
        raise ValueError(f"unknown warp engine {engine!r} (want auto|matmul|pallas)")
    if engine == "matmul":
        raise NotImplementedError(
            "TPU.WARP_ENGINE='matmul' (the banded-matmul warp) is not ported to "
            "buctd_tpu_torch: ROADMAP Queue 1 item 8, 'training: the rest'; "
            "use 'auto' or 'pallas' (the K4 kernel)")
    images = images.float().contiguous()
    trans = trans_dst2src.float().contiguous()
    if images.device.type == "cpu":
        return warp_affine_reference(images, trans, out_hw)
    return warp_resample(images, trans, out_hw)
