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
  in shared memory (it never goes to device memory), on the tensor cores in
  both dtypes, C up to 384: bf16 in bf16 ``mma.sync``
  (``fused_block_tc_kernel``, ``csrc/fused_block_tc.cuh``), f32 in 3xTF32
  (``fused_block_tf32_kernel``, ``csrc/fused_block_tf32.cuh``: every operand
  split into two tf32 halves, each product in three passes, f32-accurate;
  ``fused_block_tf32`` emulates its arithmetic).  It launches or raises;
  nothing falls back to the SIMT kernel, cuDNN or the plain version.
* CPU tensors take ``fused_basic_block_plain``: the same arithmetic as two
  ``F.conv2d`` in f32 on the widened operands.
* ``fused_basic_block_simt`` launches the SIMT kernel (f32 or bf16), which
  both dtypes ran before their tensor-core kernels; it stays only for the
  A/B (``tools/bench_block.py --simt``, the checks).

``TC_PLANS`` and ``TF32_PLANS`` state the tensor-core kernels' tile plans as
the ``.cuh`` files do, and ``tc_plan(C)`` and ``tf32_plan(C)`` the tiles,
chunks and shared memory of the plan a C takes, for the CPU tests.  The JAX package wires the kernel into no model;
its only callers are the benchmark (``buctd_tpu_torch/tools/bench_block.py``,
the counterpart of tools/bench_block.py) and the checks.
``fused_basic_block.launches`` and ``fused_basic_block_simt.launches`` count
the kernels' launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .tf32 import tf32_product

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# csrc/fused_block_tc.cuh's tile plans, by C rounded up to 16 (``cmax``):
# th x tw output pixels a block, kc input channels a weight tile and input
# chunk, nc output channels a chunk, wm x wn warps, `stages` slots in the
# weight ring of `taps` taps each, `blocks` blocks an SM that the registers
# must allow
TC_PLANS = (
    {"cmax": 48, "th": 16, "tw": 8, "kc": 48, "nc": 48, "wm": 4, "wn": 1, "stages": 2,
     "taps": 3, "blocks": 2},
    {"cmax": 96, "th": 16, "tw": 12, "kc": 96, "nc": 48, "wm": 8, "wn": 1, "stages": 2,
     "taps": 3, "blocks": 1},
    {"cmax": 192, "th": 12, "tw": 18, "kc": 32, "nc": 64, "wm": 4, "wn": 2, "stages": 2,
     "taps": 3, "blocks": 1},
    {"cmax": 384, "th": 12, "tw": 9, "kc": 64, "nc": 128, "wm": 2, "wn": 4, "stages": 2,
     "taps": 1, "blocks": 1},
)
# csrc/fused_block_tf32.cuh's tile plans (f32 in 3xTF32), by C rounded up to
# 8, the same keys: 4-byte elements, so smaller tiles and input chunks than
# the bf16 plans
TF32_PLANS = (
    {"cmax": 48, "th": 16, "tw": 8, "kc": 48, "nc": 48, "wm": 4, "wn": 1, "stages": 2,
     "taps": 1, "blocks": 2},
    {"cmax": 96, "th": 16, "tw": 12, "kc": 16, "nc": 48, "wm": 8, "wn": 1, "stages": 2,
     "taps": 3, "blocks": 1},
    {"cmax": 192, "th": 12, "tw": 9, "kc": 16, "nc": 96, "wm": 4, "wn": 2, "stages": 2,
     "taps": 3, "blocks": 1},
    {"cmax": 384, "th": 6, "tw": 9, "kc": 16, "nc": 128, "wm": 2, "wn": 4, "stages": 2,
     "taps": 3, "blocks": 1},
)
SMEM_LIMIT = 232448          # bytes of shared memory a block may use on an H100


def _plan(c: int, plans, align: int, what: str) -> dict:
    """The plan of ``plans`` that C channels take, and the numbers every plan
    derives: C_pad (C rounded up to ``align``), the halo and input tiles, the
    m16 row tiles of each phase, a warp's m16 and n8 tiles, the chunk counts
    and the threads."""
    cpad = -(-c // align) * align
    plan = next((dict(p) for p in plans if cpad <= p["cmax"]), None)
    if c <= 0 or plan is None:
        raise ValueError(f"the {what} fused block takes 1 <= C <= {plans[-1]['cmax']}, "
                         f"got {c}")
    th, tw, kc, nc, wm, wn = (plan[k] for k in ("th", "tw", "kc", "nc", "wm", "wn"))
    p1, p2, px = (th + 2) * (tw + 2), th * tw, (th + 4) * (tw + 4)
    m1, m2 = -(-p1 // 16), -(-p2 // 16)
    plan.update(cpad=cpad, p1=p1, p2=p2, px=px, m1=m1, m2=m2,
                mt=max(-(-m1 // wm), -(-m2 // wm)), nt=nc // (8 * wn), threads=32 * wm * wn,
                nx=-(-cpad // kc), nn=-(-cpad // nc), xbufs=2 if cpad > kc else 1)
    return plan


def tc_plan(c: int) -> dict:
    """The bf16 tensor-core kernel's plan for C channels, as the kernel
    derives it: ``_plan``'s numbers, the row strides (elements: an odd
    number of 16-byte units) and the shared-memory bytes (the ring, the
    input tile, the intermediate and the f32 biases)."""
    plan = _plan(c, TC_PLANS, 16, "bf16")
    cpad, kc, nc = plan["cpad"], plan["kc"], plan["nc"]
    plan.update(sx=kc + 8, sw=nc + 8, sy=cpad + 8)
    plan["smem"] = (2 * (plan["stages"] * plan["taps"] * kc * plan["sw"]
                         + plan["xbufs"] * plan["px"] * plan["sx"] + plan["p1"] * plan["sy"])
                    + 4 * 2 * cpad)
    return plan


def tf32_plan(c: int) -> dict:
    """The f32 (3xTF32) kernel's plan for C channels: ``_plan``'s numbers
    with C rounded up to 8 (the k8 step), the row strides in words (the
    input tile and the intermediate 4 times an odd number, the weight tile 8
    mod 32) and the shared-memory bytes."""
    plan = _plan(c, TF32_PLANS, 8, "f32")
    cpad, kc, nc = plan["cpad"], plan["kc"], plan["nc"]
    plan.update(sx=kc + 4, sw=(nc + 23) // 32 * 32 + 8, sy=cpad + 4)
    plan["smem"] = 4 * (plan["stages"] * plan["taps"] * kc * plan["sw"]
                        + plan["xbufs"] * plan["px"] * plan["sx"] + plan["p1"] * plan["sy"]
                        + 2 * cpad)
    return plan


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


def _conv_tf32(x, w, kc: int, passes: int):
    """A 3x3 SAME conv of NHWC f32 ``x`` with HWIO ``w`` as f32 K5 takes it:
    input channels in chunks of ``kc``, for each chunk the 9 taps in order,
    each tap's product over the chunk from zero in ``passes`` tf32 passes
    (``tf32_product``) and added to the running f32 sum."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(B, H, W, w.shape[3], device=x.device)
    for c0 in range(0, C, kc):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            acc += tf32_product(xp[:, dy:dy + H, dx:dx + W, c0:c0 + kc],
                                w[dy, dx, c0:c0 + kc], passes)
    return acc


def fused_block_tf32(x, w1, w2, b1, b2, passes: int = 3):
    """f32 K5's arithmetic emulated on f32 tensors, for the checks: both
    convs as ``_conv_tf32`` with the input chunks of the kernel's plan
    (``tf32_plan``), + b1, relu, the f32 intermediate zero-padded outside the
    image, ((acc + b2) + x), relu.  ``passes`` 3 is the kernel's 3xTF32, 1
    the control a single-pass kernel would compute.  Nothing on a path calls
    it."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    x, w1, w2, b1, b2 = (t.float() for t in (x, w1, w2, b1, b2))
    kc = tf32_plan(x.shape[3])["kc"]
    y = torch.relu(_conv_tf32(x, w1, kc, passes) + b1)
    return torch.relu((_conv_tf32(y, w2, kc, passes) + b2) + x)


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
def _fn(name: str = "buctd_fused_block"):
    """``name`` of csrc/fused_block.cu (built and loaded at first call)."""
    from .._build import load

    fn = getattr(load("fused_block"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 5 + [p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, x, w1, w2, b1, b2):
    x, w1, w2, b1, b2 = (t.contiguous() for t in (x, w1, w2, b1, b2))
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _fn(name)(
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), b1.data_ptr(), b2.data_ptr(),
            out.data_ptr(), B, H, W, C, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err} at "
                           f"{tuple(x.shape)} {x.dtype}")
    return out


def fused_basic_block(x, w1, w2, b1, b2):
    """The fused eval basic block.  CUDA tensors launch K5
    (``csrc/fused_block.cu``: on the tensor cores, bf16 in bf16, f32 in
    3xTF32); CPU tensors take ``fused_basic_block_plain``; any other device
    raises."""
    _check(x, w1, w2, b1, b2)
    if x.device.type == "cpu":
        return fused_basic_block_plain(x, w1, w2, b1, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_basic_block runs on cuda or cpu, not {x.device}")
    (tc_plan if x.dtype == torch.bfloat16 else tf32_plan)(x.shape[3])   # raises past 384
    out = _launch("buctd_fused_block", x, w1, w2, b1, b2)
    fused_basic_block.launches += 1
    return out


fused_basic_block.launches = 0


def fused_basic_block_simt(x, w1, w2, b1, b2):
    """K5's SIMT kernel (f32 FMAs, on the widened operands in bf16), for the
    A/B against the tensor-core kernels: f32 or bf16 CUDA tensors only."""
    _check(x, w1, w2, b1, b2)
    if x.device.type != "cuda":
        raise TypeError(f"fused_basic_block_simt takes CUDA tensors, got {x.device}")
    out = _launch("buctd_fused_block_simt", x, w1, w2, b1, b2)
    fused_basic_block_simt.launches += 1
    return out


fused_basic_block_simt.launches = 0
