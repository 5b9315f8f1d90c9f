"""Transcendental throughput: the hand-written CUDA kernel K6 and its plain
version.

Counterpart of tools/bench_exp2.py::_kernel (:34): every element of an f32
tensor runs ``inner`` chained steps ``y = op(y * 0.03)`` with op one of
``VARIANTS``: exp, exp2, and exp written as exp2(x * log2(e)).  The 0.03 keeps
the values near 1.03 and the chain contracting; every variant pays the same
multiply, so their difference is the transcendental alone.

``exp_chain(x, variant)`` is one launch of ``csrc/exp_throughput.cu`` on a
CUDA tensor (counted in ``exp_chain.launches``) and the plain version on a
CPU tensor; any other device raises.  The benchmark
(``buctd_tpu_torch/tools/bench_exp2.py``) chains OUTER calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

INNER = 128          # chained transcendentals per element per launch
SCALE = 0.03
LOG2E = 1.4426950408889634
VARIANTS = {"exp": 0, "exp2": 1, "exp2(x*log2e)": 2}


def _op(variant: str):
    return {"exp": torch.exp, "exp2": torch.exp2,
            "exp2(x*log2e)": lambda y: torch.exp2(y * LOG2E)}[variant]


def exp_chain_plain(x, variant: str, inner: int = INNER):
    """Plain version: ``inner`` chained ``op(y * 0.03)`` in f32 torch ops."""
    op = _op(variant)
    y = x.float()
    for _ in range(inner):
        y = op(y * SCALE)
    return y


@functools.lru_cache(maxsize=None)
def _fn():
    """buctd_exp_chain of csrc/exp_throughput.cu (built and loaded at first call)."""
    from .._build import load

    fn = load("exp_throughput").buctd_exp_chain
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def exp_chain(x, variant: str, inner: int = INNER):
    """``inner`` chained ``op(y * 0.03)`` over f32 ``x``: one kernel launch on
    a CUDA tensor, the plain version on a CPU tensor."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {list(VARIANTS)}")
    if x.dtype != torch.float32:
        raise TypeError(f"exp_chain takes f32, got {x.dtype}")
    if x.device.type == "cpu":
        return exp_chain_plain(x, variant, inner)
    if x.device.type != "cuda":
        raise ValueError(f"exp_chain runs on cuda or cpu, not {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), out.data_ptr(), x.numel(), int(inner), VARIANTS[variant],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"exp_throughput launch failed: cudaError_t {err} at "
                           f"{tuple(x.shape)}, {variant}")
    exp_chain.launches += 1
    return out


exp_chain.launches = 0
