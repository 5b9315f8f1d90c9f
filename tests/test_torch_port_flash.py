"""buctd_tpu_torch flash-attention forward (K1) vs the JAX Pallas kernel.

On CPU tensors the port's ``flash_attention`` is its plain version (dense
softmax in f32); it is held against buctd_tpu's kernel run in interpret mode,
as tests/test_flash_attention.py runs it, at the same four shapes with the
same atol/rtol 2e-5 (f32 sums over at most 700 keys).  The CUDA kernel itself
is held against the plain version by tests/test_torch_port_cuda.py (marked
``cuda``; skips on hosts without a card) and by chip_smoke.py on the H100.

bf16 operands: the plain forward rounds q' = bf16(q * bf16(scale)) and
p * keep * c to bf16 where JAX's ``_fwd_kernel`` does, so its out and lse are
held against the JAX kernel run in interpret mode on the same bf16 operands:
lse within BF16_LSE_ATOL (f32 sums over at most 700 keys in another order;
measured <= 9.6e-7 at these shapes), out within BF16_OUT_ATOL (values up to
0.56): JAX rounds p relative to the running max of the 128-key tiles seen so
far and the dense plain version relative to the final row max, so where the
running max moves a p lands one bf16 step apart (measured <= 1.34e-4).  The
f32 forward of the widened operands, which rounds nothing, misses JAX by
1.7e-3 to 4.6e-3 in lse and 3.7e-4 to 3.7e-3 in out at these shapes, and the
forward that rounds q' but leaves p * keep * c unrounded misses out by 3.7e-4
to 8.8e-4: the tolerances tell the rounding from its absence.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import flash_attention as fa

SHAPES = [
    (2, 256, 256, 48),      # CoAM-ish head dim, aligned L
    (1, 300, 300, 112),     # TransPose-ish head dim, unaligned L
    (3, 640, 384, 96),      # cross-attention lengths, multi-block
    (1, 128, 700, 64),      # single q block, ragged kv tail
]


BF16_OUT_ATOL = 4e-4
BF16_LSE_ATOL = 1e-5


def _qkv(bh, lq, lk, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, lq, d).astype(np.float32),
            rng.randn(bh, lk, d).astype(np.float32),
            rng.randn(bh, lk, d).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _bf16_case(bh, lq, lk, d):
    """bf16 operands (as torch tensors), scale, and JAX's interpret-mode
    _fwd_kernel out and lse on them."""
    from buctd_tpu.ops.flash_attention import _flash_fwd_impl

    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(bh, lq, lk, d))
    scale = 1.0 / np.sqrt(d)
    out, lse = _flash_fwd_impl(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                                 for x in (q, k, v)),
                               jnp.zeros((1,), jnp.int32), scale, 0.0, True)
    return (q, k, v), scale, np.asarray(out), np.asarray(lse)[:, :lq, 0]


@pytest.mark.parametrize("bh,lq,lk,d", SHAPES)
def test_flash_matches_jax_interpret(bh, lq, lk, d):
    from buctd_tpu.ops.flash_attention import _flash_fwd_impl, flash_attention

    q, k, v = _qkv(bh, lq, lk, d)
    scale = 1.0 / np.sqrt(d)
    out, lse = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), scale)
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == (bh, lq, d) and lse.shape == (bh, lq)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0,
                           scale, 0.0, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    _, want_lse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.zeros((1,), jnp.int32), scale, 0.0, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :lq, 0],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bh,lq,lk,d", SHAPES)
def test_bf16_plain_forward_matches_jax_interpret(bh, lq, lk, d):
    (q, k, v), scale, want_out, want_lse = _bf16_case(bh, lq, lk, d)
    out, lse = fa.flash_attention(q, k, v, scale)
    assert out.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want_out, atol=BF16_OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=BF16_LSE_ATOL, rtol=0)


def test_bf16_check_tells_rounding_from_f32():
    """The f32 forward of the widened operands (what the port computed for
    bf16 operands before it rounded) misses JAX by more than the tolerances
    above, and so does the forward that rounds q' but not p; the rounding
    forward's lse normalises the logits the backward recomputes,
    s' = q' k^T: rows of exp(s' - lse) sum to 1."""
    miss_out = miss_lse = miss_p = 0.0
    for shape in SHAPES:
        (q, k, v), scale, want_out, want_lse = _bf16_case(*shape)
        out32, lse32 = fa.flash_attention(q.float(), k.float(), v.float(), scale)
        miss_out = max(miss_out, np.abs(out32.numpy() - want_out).max())
        miss_lse = max(miss_lse, np.abs(lse32.numpy() - want_lse).max())
        s, _ = fa._logits(q, k, scale)
        out_p = torch.matmul(torch.softmax(s, dim=-1), v.float())
        miss_p = max(miss_p, np.abs(out_p.numpy() - want_out).max())
        _, lse = fa.flash_attention(q, k, v, scale)
        rows = torch.exp(s - lse[..., None]).sum(-1)
        assert (rows - 1).abs().max().item() <= 1e-5, shape
    assert miss_out > 2 * BF16_OUT_ATOL and miss_lse > 100 * BF16_LSE_ATOL, (miss_out,
                                                                              miss_lse)
    assert miss_p > BF16_OUT_ATOL, miss_p


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("bh,lq,lk,d", [(2, 40, 64, 48), (1, 50, 20, 112),
                                        (2, 70, 300, 48), (1, 90, 130, 96)])
def test_tile_rounded_forward(bh, lq, lk, d, dropout):
    """``forward_tile_rounded``, the card checks' emulation of bf16 K1's
    rounding at its running tile max (the key tile of the kernel that the
    dispatch picks, ``fwd_key_tile``): its
    unrounded control is the dense softmax(s) keep @ v (f32, 2e-6 for sums
    in another order); its out differs from the control by the bf16 rounding
    of p * keep * c, a relative 2^-9 rms each (1e-3 to 3e-3 of out's rms);
    and on one key tile, where the running max is the final one, it is the
    plain forward up to one-bf16-step flips of a p where exp2 and exp differ
    (2^-8 x max |v| a flip, two allowed)."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(bh, lq, lk, d))
    s, _ = fa._logits(q, k, 1.0 / np.sqrt(d))
    keep = fa.dropout_multiplier(5, bh, lq, lk, dropout) if dropout > 0.0 else None
    out, control = fa.forward_tile_rounded(s, v, keep)
    pk = torch.softmax(s, dim=-1) * (keep if keep is not None else 1.0)
    torch.testing.assert_close(control, torch.matmul(pk, v.float()), atol=2e-6, rtol=0)
    rms = ((out - control).square().sum() / out.square().sum()).sqrt().item()
    assert 1e-3 <= rms <= 3e-3, rms
    if lk <= fa.fwd_key_tile(d):
        plain, _ = fa.forward_from_logits(s, v, keep, True)
        flips = 2 * 2.0 ** -8 * v.float().abs().max().item()
        assert (out - plain).abs().max().item() <= flips


def test_cpu_calls_do_not_count_as_launches():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 16, 16, 8))
    before = fa.flash_attention.launches
    fa.flash_attention(q, k, v, 0.5)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("bad,err", [
    (lambda q, k, v: (q[..., :64], k[..., :64], v), ValueError),        # d_k != d_v
    (lambda q, k, v: (q, k, v[:, :-1]), ValueError),                    # Lk mismatch
    (lambda q, k, v: (q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2)), ValueError),                  # non-contiguous
    (lambda q, k, v: (q.double(), k.double(), v.double()), TypeError),  # f64
    (lambda q, k, v: (q[0], k[0], v[0]), ValueError),                   # not 3-D
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 16, 16, 160))
    q, k, v = bad(q[..., :128].contiguous(), k[..., :128].contiguous(), v[..., :128])
    with pytest.raises(err):
        fa.flash_attention(q, k, v, 0.1)
    qd, kd, vd = (torch.zeros(1, 8, 160) for _ in range(3))
    with pytest.raises(ValueError):                                     # d > 128
        fa.flash_attention(qd, kd, vd, 0.1)


def test_attention_routes_long_sequences_to_flash(monkeypatch):
    """models/attention.py: engine 'flash' takes the kernel wrapper; 'auto'
    takes it only for CUDA tensors at L_q * L_k >= 512^2 (CPU: the batched
    matmul); the mapped path and the wrapper agree."""
    from buctd_tpu_torch.models import attention

    calls = []
    real = attention.flash_attention

    def spy(q, k, v, scale):
        calls.append(tuple(q.shape))
        return real(q, k, v, scale)

    monkeypatch.setattr(attention, "flash_attention", spy)
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(2, 1, 768, 8).astype(np.float32))
               for _ in range(3))
    assert 768 * 768 >= attention.FLASH_MIN_TOKENS
    flash = attention._attend(q, k, v, 0.3, engine="flash")
    assert calls == [(2, 768, 8)]
    mapped = attention._attend(q, k, v, 0.3, engine="auto")   # CPU tensor
    assert calls == [(2, 768, 8)]
    np.testing.assert_allclose(flash.numpy(), mapped.numpy(), atol=2e-5, rtol=2e-5)
    assert not attention._use_flash(q, 768, 9, "flash")         # d_k != d_v
    assert not attention._use_flash(q, 768, 8, "mapped")
