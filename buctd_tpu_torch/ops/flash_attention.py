"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

``flash_attention(q, k, v, scale)`` computes ``softmax(q k^T * scale) @ v`` and the
logsumexp of every query row for the long-sequence token attention of the CoAM
position module (L = 6912 at d = 48 and L = 1728 at d = 96 for BUCTD-CoAM-W48).

* On CUDA tensors it launches ``csrc/flash_fwd.cu`` (the port of
  buctd_tpu/ops/flash_attention.py::_fwd_kernel), which streams K/V tiles
  through shared memory with an online softmax, so no (L_q, L_k) matrix is
  written.  It launches the kernel or raises; it never falls back.
* On CPU tensors it runs ``flash_attention_reference``, the plain dense
  version, which the CPU tests hold against the JAX kernel.

``flash_attention.launches`` counts kernel launches (CPU calls do not count),
so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_BH = 65535   # grid.y of the kernel


def flash_attention_reference(q, k, v, scale: float):
    """Plain version: dense softmax in f32.  q (BH, Lq, d), k/v (BH, Lk, d) ->
    out f32 (BH, Lq, d), lse f32 (BH, Lq) (natural log)."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()), lse


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention wants (BH, L, d) operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, _, d = q.shape
    if k.shape[0] != bh or v.shape[0] != bh or k.shape[1] != v.shape[1]:
        raise ValueError(f"mismatched operands {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[2] != d or v.shape[2] != d:
        raise ValueError(f"flash_attention needs d_k == d_v == d_q, got "
                         f"{d}, {k.shape[2]}, {v.shape[2]}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if bh > MAX_BH:
        raise ValueError(f"BH = {bh} > {MAX_BH}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes f32 or bf16 operands of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous operands")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of csrc/flash_fwd.cu (built and loaded at first call)."""
    from .._build import load

    lib = load("flash_fwd")
    fn = lib.buctd_flash_fwd
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, scale: float):
    """out f32 (BH, Lq, d), lse f32 (BH, Lq) of softmax(q k^T * scale) @ v.

    q (BH, Lq, d), k/v (BH, Lk, d), one dtype (f32 or bf16), d <= 128,
    contiguous.  CUDA tensors launch the kernel; CPU tensors take the plain
    version; any other device raises.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    bh, lq, d = q.shape
    out = torch.empty((bh, lq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), bh, lq, k.shape[1], d, float(scale),
                        _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err} "
                           f"at q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
