"""The f32 kernels' 3xTF32 arithmetic in PyTorch: the Python side of
csrc/mma_tf32.cuh, which K1, K2 and K5 share.  The dense emulations that
the checks hold against the kernels and the JAX package
(``flash_attention.forward_tf32``, ``flash_attention.backward_tf32``,
``fused_block.fused_block_tf32``) take their products from here; nothing
on the main path calls them.  ``tf32_operand`` is how a bf16 model's warp
and render take XLA's default precision on the card (core/refine.py): TF32
operands, multiplied exactly, with the process's TF32 flags left alone.
"""

from __future__ import annotations

import torch


def tf32_round(x):
    """f32 ``x`` rounded to tf32 as ``csrc/mma_tf32.cuh::rna`` rounds it: the
    low 13 of the 23 mantissa bits dropped, to nearest with ties away from
    zero, by adding half their range to the sign-magnitude bits and clearing
    them, in 32-bit unsigned arithmetic.  That is ``cvt.rna.tf32.f32``'s
    value for every x but a NaN, whose bits may carry into the sign or the
    exponent (0x7fffffff gives -0.0; ``tf32_split``'s lo carries the NaN).
    Returns f32."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)     # back to int32's range
    return bits.to(torch.int32).view(torch.float32)


def tf32_split(x):
    """(hi, lo) of f32 ``x`` as ``csrc/mma_tf32.cuh::split`` makes them: hi =
    tf32(x), rest = x - hi, lo = rest * 0 + tf32(rest): tf32(rest) where x
    is finite, NaN where x is NaN or infinite (rest is NaN there)."""
    x = x.float()
    hi = tf32_round(x)
    rest = x - hi
    return hi, rest * 0.0 + tf32_round(rest)


def tf32_product(a, b, passes: int):
    """a @ b of f32 operands as the f32 kernels (K1, K2, K5) take it on the
    tensor cores: each operand split into hi and lo (``tf32_split``); three
    passes (lo hi + hi lo, then + hi hi, f32 sums), or one (hi hi, plain
    TF32)."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    if passes == 1:
        return torch.matmul(a_hi, b_hi)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) + torch.matmul(a_hi, b_hi)


def tf32_operand(on: bool):
    """A matmul operand as it enters the product: ``tf32_round`` where
    ``on``, else the identity.  A product of two TF32 values is exact in f32,
    so a matmul of such operands computes a TF32 matmul whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says."""
    return tf32_round if on else (lambda a: a)
