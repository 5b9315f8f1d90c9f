"""Model summary: parameters and forward FLOPs.

Counterpart of buctd_tpu/utils/summary.py.  The JAX package reads XLA's cost
analysis and adds the Pallas flash calls' products analytically (XLA counts
a custom call as ~0).  Here ``torch.utils.flop_counter.FlopCounterMode``
counts the torch operators of one forward (convolutions, matrix products;
the CPU's plain attention included), and the products of the CUDA flash
kernel K1 (or K1'), a ctypes call that the counter cannot see, are added
from the shapes ``ops/flash_attention.py::flash_attention`` records:
4 * BH * Lq * Lk * d each, JAX's ``logged_flops``.  ``mfu_string`` rates a
time against the H100's dense bf16 tensor-core peak.
"""

from __future__ import annotations

import torch

# one H100 SXM's dense bf16 tensor-core peak (NVIDIA's data sheet, 700 W)
H100_BF16_PEAK = 989e12


def _counted(fn, *args) -> tuple:
    """(FlopCounterMode's count of ``fn(*args)``, the (BH, Lq, Lk, d) of its
    CUDA flash calls)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import flash_attention as fa

    fa.flash_attention.shapes = []
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        return float(counter.get_total_flops()), fa.flash_attention.shapes
    finally:
        fa.flash_attention.shapes = None


def compiled_flops(fn, *args) -> float:
    """FLOPs of ``fn(*args)``: FlopCounterMode's count plus K1's products."""
    flops, shapes = _counted(fn, *args)
    return flops + float(sum(4.0 * bh * lq * lk * d for bh, lq, lk, d in shapes))


def model_summary(model: torch.nn.Module, input_shape) -> dict:
    """One eval-mode forward of an ``input_shape`` (N, C, H, W) zero input on
    the model's device: {'params': parameter count, 'flops': its FLOPs,
    'flash_calls': the K1 (or K1') launches it made, 'text': the summary
    block the entry points log}."""
    device = next(model.parameters()).device
    n_params = sum(p.numel() for p in model.parameters())
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            counted, shapes = _counted(model, torch.zeros(tuple(input_shape), device=device))
    finally:
        model.train(was_training)
    flops = counted + float(sum(4.0 * bh * lq * lk * d for bh, lq, lk, d in shapes))
    text = "\n".join([
        "=" * 60,
        f"Model: {type(model).__name__}",
        f"Input shape: {tuple(input_shape)}",
        f"Total parameters: {n_params:,} ({n_params * 4 / 1024 ** 2:.2f} MB fp32)",
        f"Forward FLOPs: {flops / 1e9:.2f} GFLOPs",
        "=" * 60])
    return {"params": n_params, "flops": flops, "flash_calls": len(shapes), "text": text}


def get_model_summary(model: torch.nn.Module, input_shape) -> str:
    """The summary block (JAX's ``get_model_summary``)."""
    return model_summary(model, input_shape)["text"]


def mfu_string(fn, args, dt_seconds: float, peak: float = H100_BF16_PEAK) -> str:
    """'  NN.NN TF -> MFU X.X%' for ``fn(*args)`` taking ``dt_seconds``,
    against the H100's dense bf16 peak."""
    flops = compiled_flops(fn, *args)
    return f"  {flops / 1e12:.2f} TF -> MFU {flops / dt_seconds / peak * 100:.1f}%"
