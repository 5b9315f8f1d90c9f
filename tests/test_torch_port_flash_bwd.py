"""buctd_tpu_torch flash-attention backward (K2) and dropout (K1) on the CPU.

On CPU tensors ``flash_attention_train`` runs the plain forward and the plain
backward written out (p from lse, ds = p (g keep - delta)).  They are held
against:

* the JAX VJP of ``flash_attention(..., interpret=True)`` at dropout 0, at the
  four shapes of test_torch_port_flash.py, dq/dk/dv atol = rtol = 1e-4 (f32
  sums over at most 700 keys, in another order);
* torch autograd through the dense forward with the same hash mask at
  p = 0.3, atol = rtol = 1e-5 (the same f32 products, grouped differently).

The mask itself: keep rate within 1% of 1 - p over >= 1e5 entries, the same
bits for the same seed, other bits for another.  The CUDA kernels draw the same
hash; chip_smoke.py holds them against these plain versions on the card.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import flash_attention as fa
from test_torch_port_flash import SHAPES, _qkv


def _grads_port(q, k, v, dout, scale, dropout=0.0, seed=0):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention_train(qt, kt, vt, scale, dropout, seed)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


@pytest.mark.parametrize("bh,lq,lk,d", SHAPES)
def test_backward_matches_jax_vjp(bh, lq, lk, d):
    from buctd_tpu.ops.flash_attention import flash_attention

    q, k, v = _qkv(bh, lq, lk, d, seed=1)
    dout = np.random.RandomState(2).randn(bh, lq, d).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    out, dq, dk, dv = _grads_port(q, k, v, dout, scale)
    want_out, vjp = jax.vjp(lambda a, b, c: flash_attention(a, b, c, 0, scale, 0.0, True),
                            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out, np.asarray(want_out), atol=1e-4, rtol=1e-4)
    for got, want in zip((dq, dk, dv), vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bh,lq,lk,d", [(2, 96, 80, 16), (1, 64, 150, 24)])
def test_backward_with_dropout_matches_autograd(bh, lq, lk, d):
    q, k, v = _qkv(bh, lq, lk, d, seed=3)
    dout = np.random.RandomState(4).randn(bh, lq, d).astype(np.float32)
    scale, p, seed = d ** -0.5, 0.3, 12345
    out, dq, dk, dv = _grads_port(q, k, v, dout, scale, p, seed)

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    want_out, _ = fa.flash_attention_reference(qt, kt, vt, scale, p, seed)
    want_out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out, want_out.detach().numpy(), atol=1e-6, rtol=1e-6)
    for got, want in zip((dq, dk, dv), (qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=1e-5)
    # dropout really acted: the p = 0 output differs
    undropped, _ = fa.flash_attention_reference(qt, kt, vt, scale)
    assert not np.allclose(out, undropped.detach().numpy(), atol=1e-3)


@pytest.mark.parametrize("p", [0.1, 0.3, 0.5])
def test_dropout_mask_rate_and_determinism(p):
    bits = fa.dropout_bits(7, 3, 200, 300)               # 180000 entries
    assert bits.min() >= 0 and bits.max() < 2**32
    keep = fa.dropout_multiplier(7, 3, 200, 300, p)
    rate = float((keep > 0).float().mean())
    assert abs(rate - (1.0 - p)) < 0.01, rate
    np.testing.assert_allclose(keep[keep > 0].numpy(), 1.0 / (1.0 - p), rtol=1e-7)
    assert torch.equal(fa.dropout_bits(7, 3, 200, 300), bits)
    other = fa.dropout_bits(8, 3, 200, 300)
    assert float((other == bits).float().mean()) < 1e-3
    # a sub-block of the grid is the same block of the bigger grid: the mask
    # depends on (seed, bh, row, col) only, not on the shape it is drawn in
    assert torch.equal(fa.dropout_bits(7, 2, 50, 70), bits[:2, :50, :70])


def test_reference_slice_takes_the_mask_of_its_rows():
    """The plain versions over BH rows bh0.. with ``bh0`` equal the same rows
    of the whole call: the chunked checks on the card hold the kernels at the
    full BH with the mask of every row."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 24, 40, 8))
    scale, p, seed = 8 ** -0.5, 0.3, 11
    out, lse = fa.flash_attention_reference(q, k, v, scale, p, seed)
    part, part_lse = fa.flash_attention_reference(q[2:], k[2:], v[2:], scale, p, seed, bh0=2)
    torch.testing.assert_close(part, out[2:], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(part_lse, lse[2:], atol=1e-6, rtol=1e-6)
    unshifted, _ = fa.flash_attention_reference(q[2:], k[2:], v[2:], scale, p, seed)
    assert not torch.allclose(unshifted, out[2:])
    dout = torch.randn(4, 24, 8, generator=torch.Generator().manual_seed(0))
    delta = (dout * out).sum(-1)
    whole = fa.flash_attention_backward_reference(q, k, v, dout, lse, delta, scale, p, seed)
    sliced = fa.flash_attention_backward_reference(q[2:], k[2:], v[2:], dout[2:], lse[2:],
                                                   delta[2:], scale, p, seed, bh0=2)
    for got, want in zip(sliced, whole):
        torch.testing.assert_close(got, want[2:], atol=1e-6, rtol=1e-6)
    assert torch.equal(fa.dropout_bits(7, 2, 5, 6, bh0=1), fa.dropout_bits(7, 3, 5, 6)[1:])


def test_hash_matches_uint32_arithmetic():
    """The int64 emulation of the 32-bit hash against numpy uint32 math."""
    def fmix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))

    seed, bh, lq, lk = 2**31 + 5, 2, 5, 7
    with np.errstate(over="ignore"):
        b = np.arange(bh, dtype=np.uint32)
        r = np.arange(lq, dtype=np.uint32)
        c = np.arange(lk, dtype=np.uint32)
        bkey = fmix(np.uint32(seed) + b * np.uint32(0x9E3779B9))
        row = fmix(bkey[:, None] ^ (r * np.uint32(0x85EBCA77))[None])
        want = fmix(row[:, :, None] ^ (c * np.uint32(0xC2B2AE3D))[None, None])
    np.testing.assert_array_equal(fa.dropout_bits(seed, bh, lq, lk).numpy(),
                                  want.astype(np.int64))


def test_backward_wrappers_refuse_cpu_and_bad_inputs():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 16, 16, 8))
    lse = torch.zeros(1, 16)
    with pytest.raises(ValueError):
        fa.flash_bwd_dq(q, k, v, torch.zeros(1, 16, 8), lse, lse, 0.3)
    with pytest.raises(ValueError):
        fa.flash_bwd_dkv(q, k, v, torch.zeros(1, 16, 8), lse, lse, 0.3)
    with pytest.raises(ValueError):                                  # bad dout shape
        fa.flash_bwd_dkv(q, k, v, torch.zeros(1, 16, 9), lse, lse, 0.3)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, 0.3, dropout=1.0)
    assert fa.flash_bwd_dq.launches == fa.flash_bwd_dkv.launches == 0
