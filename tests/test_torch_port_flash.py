"""buctd_tpu_torch flash-attention forward (K1) vs the JAX Pallas kernel.

On CPU tensors the port's ``flash_attention`` is its plain version (dense
softmax in f32); it is held against buctd_tpu's kernel run in interpret mode,
as tests/test_flash_attention.py runs it, at the same four shapes with the
same atol/rtol 2e-5 (f32 sums over at most 700 keys).  The CUDA kernel itself
is held against the plain version by tests/test_torch_port_cuda.py (marked
``cuda``; skips on hosts without a card) and by chip_smoke.py on the H100.
"""

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


def _qkv(bh, lq, lk, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, lq, d).astype(np.float32),
            rng.randn(bh, lk, d).astype(np.float32),
            rng.randn(bh, lk, d).astype(np.float32))


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
