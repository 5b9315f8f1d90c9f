"""Fused eval HRNet basic block: the hand-written CUDA kernel K5 and its plain
version.

Counterpart of buctd_tpu/ops/pallas_block.py::fused_basic_block (:106), with
the JAX contract: x (B, H, W, C) NHWC, HWIO (3, 3, C, C) weights w1/w2 and
(C,) biases b1/b2 with the block's BatchNorms already folded in
(``models/fuse.py::fold_bn``), one dtype (f32 or bf16), computes

    relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2 + x)

with SAME padding.  As the TPU kernel (:67-92): the taps are read in the
operand dtype and summed in f32, the intermediate is rounded to the operand
dtype before the second conv, the second conv reads zeros outside the image,
the residual is added in f32 and the output cast to x's dtype.

* CUDA tensors launch ``csrc/fused_block.cu``, which keeps the intermediate
  in shared memory (it never goes to device memory).  It launches or raises;
  nothing falls back to cuDNN or to the plain version.
* CPU tensors take ``fused_basic_block_plain``: the same arithmetic as two
  ``F.conv2d`` in f32 on the widened operands.

The JAX package wires the kernel into no model; its only callers are the
benchmark (``buctd_tpu_torch/tools/bench_block.py``, the counterpart of
tools/bench_block.py) and the checks.  ``fused_basic_block.launches`` counts
the kernel's launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_basic_block_plain(x, w1, w2, b1, b2):
    """Plain version, on any device: f32 convs of the widened operands (the
    products of two bf16 values are exact in f32), the intermediate rounded to
    x's dtype, the residual added in f32."""
    dtype = x.dtype
    xn = x.permute(0, 3, 1, 2).float()                       # NCHW view, f32
    k1 = w1.float().permute(3, 2, 0, 1)                      # HWIO -> OIHW
    k2 = w2.float().permute(3, 2, 0, 1)
    y = torch.relu(F.conv2d(xn, k1, padding=1) + b1.float()[:, None, None])
    y = y.to(dtype).float()                                  # (b): operand dtype
    z = (F.conv2d(y, k2, padding=1) + b2.float()[:, None, None]) + xn
    return torch.relu(z).to(dtype).permute(0, 2, 3, 1).contiguous()


def _check(x, w1, w2, b1, b2) -> None:
    if x.dim() != 4:
        raise ValueError(f"fused_basic_block wants (B, H, W, C) x, got {tuple(x.shape)}")
    c = x.shape[3]
    for name, t, shape in (("w1", w1, (3, 3, c, c)), ("w2", w2, (3, 3, c, c)),
                           ("b1", b1, (c,)), ("b2", b2, (c,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} for C = {c}, got {tuple(t.shape)}")
    tensors = (x, w1, w2, b1, b2)
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("fused_basic_block takes f32 or bf16 tensors of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}")


@functools.lru_cache(maxsize=None)
def _fn():
    """buctd_fused_block of csrc/fused_block.cu (built and loaded at first call)."""
    from .._build import load

    fn = load("fused_block").buctd_fused_block
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 5 + [p]
    fn.restype = ctypes.c_int
    return fn


def fused_basic_block(x, w1, w2, b1, b2):
    """The fused eval basic block.  CUDA tensors launch K5
    (``csrc/fused_block.cu``); CPU tensors take ``fused_basic_block_plain``;
    any other device raises."""
    _check(x, w1, w2, b1, b2)
    if x.device.type == "cpu":
        return fused_basic_block_plain(x, w1, w2, b1, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_basic_block runs on cuda or cpu, not {x.device}")
    x, w1, w2, b1, b2 = (t.contiguous() for t in (x, w1, w2, b1, b2))
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _fn()(
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), b1.data_ptr(), b2.data_ptr(),
            out.data_ptr(), B, H, W, C, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block launch failed: cudaError_t {err} at "
                           f"{tuple(x.shape)} {x.dtype}")
    fused_basic_block.launches += 1
    return out


fused_basic_block.launches = 0
