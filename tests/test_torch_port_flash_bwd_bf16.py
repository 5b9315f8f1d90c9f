"""buctd_tpu_torch flash-attention backward with bf16 operands, on the CPU.

For bf16 q/k/v the plain backward (``flash_attention_backward_reference``, what
CPU tensors run and what the card's checks hold K2's tensor-core kernels to)
rounds the products' operands where JAX's kernels round at Precision.DEFAULT:
q * bf16(scale), do, ds and p * keep * c, with f32 sums.  Held against:

* the JAX VJP of ``flash_attention(q, k, v, 0, scale, 0.0, True)`` (interpret
  mode) on the same bf16 inputs at dropout 0, with do bf16-representable so
  both sides see the same do: the port's gradients (bf16, as JAX returns them)
  within JAX_RTOL = 2^-7 x max |grad| of JAX's, one bf16 step of a value near
  the max.  The plain forward rounds q' and p as JAX's forward does, so both
  sides recompute p from the same logits and lse; what remains is the bf16
  rounding of f32 sums taken in another order, which can land a gradient one
  step apart (0 to 7.1e-3 of the max measured on these shapes; 2.8e-3 to
  6.8e-3 before the forward rounded, against a limit of 1e-2);
* a numpy emulation that rounds at exactly those four points, bit for bit, on
  a tiny input whose matrix products are exact in f32 by construction (few
  significant bits, one binade per operand), so the order of the sums cannot
  show; p = exp(s - lse) is the one primitive the emulation takes from torch,
  since numpy's and torch's f32 exp differ in the last bit.  Leaving out any
  one of the four roundings changes the result.

The K2 benchmark (buctd_tpu_torch/tools/bench_flash_bwd.py) builds variants of
csrc/flash_bwd.cu by text substitution; each variant's substitutions must
still apply to the source.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import flash_attention as fa

JAX_SHAPES = [(1, 200, 200, 48), (2, 300, 300, 96), (1, 130, 170, 40)]
JAX_RTOL = 2.0 ** -7


def _bf16_values(rng, *shape):
    """f32 normal values rounded to bf16, as a bf16 torch tensor."""
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("bh,lq,lk,d", JAX_SHAPES)
def test_bf16_backward_matches_jax_vjp(bh, lq, lk, d):
    from buctd_tpu.ops.flash_attention import flash_attention

    rng = np.random.RandomState(lq + d)
    q, k, v = _bf16_values(rng, bh, lq, d), _bf16_values(rng, bh, lk, d), _bf16_values(
        rng, bh, lk, d)
    dout = _bf16_values(rng, bh, lq, d).float()
    scale = 1.0 / np.sqrt(d)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.flash_attention_train(*leaves, scale, 0.0, 0).backward(dout)
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: flash_attention(a, b, c, 0, scale, 0.0, True),
                     jq, jk, jv)
    for got, want in zip(leaves, vjp(jnp.asarray(dout.numpy()))):
        assert got.grad.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.grad.float().numpy() - want).max()
        assert err <= JAX_RTOL * np.abs(want).max(), (err, np.abs(want).max())


def _rne_bf16(x):
    """float32 -> the nearest bf16 (ties to even), as float32: bit arithmetic."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _one_binade(rng, shape, bits=3):
    """+-[1/2, 1) values with ``bits`` significant bits: few-bit products."""
    m = rng.randint(2 ** (bits - 1), 2 ** bits, shape)
    return (m * rng.choice([-1.0, 1.0], shape) / 2.0 ** bits).astype(np.float32)


def _emulate(q, k, v, dout, lse, delta, scale, keep, skip=()):
    """The bf16 backward in numpy, rounding q * bf16(scale), do, ds and
    p * keep * c unless named in ``skip``; exact products (float64 sums of
    few-bit f32 operands), elementwise ops in float32."""
    rnd = {n: (lambda x: x) if n in skip else _rne_bf16 for n in ("q", "do", "ds", "pk")}
    f32, f64 = np.float32, np.float64

    def mm(a, b):
        return (a.astype(f64) @ b.astype(f64)).astype(f32)

    qs = rnd["q"](q * _rne_bf16(f32(scale)))
    do = rnd["do"](dout)
    s = mm(qs, k.transpose(0, 2, 1))
    p = torch.exp(torch.from_numpy(s - lse[..., None])).numpy()
    g, pk = mm(do, v.transpose(0, 2, 1)) * keep, p * keep
    ds = rnd["ds"](p * (g - delta[..., None]))
    return (mm(ds, k) * f32(scale), mm(ds.transpose(0, 2, 1), qs),
            mm(rnd["pk"](pk).transpose(0, 2, 1), do))


@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["p0", "p0.3"])
def test_bf16_plain_backward_rounds_where_jax_does(dropout):
    rng = np.random.RandomState(21)
    bh, lq, lk, d, scale, seed = 2, 2, 5, 4, 0.3, 77
    q, k, v = (_one_binade(rng, (bh, n, d)) for n in (lq, lk, lk))
    dout = _one_binade(rng, (bh, lq, d), bits=24)          # rounding do matters
    s = np.einsum("bid,bjd->bij", _rne_bf16(q * _rne_bf16(np.float32(scale))), k)
    lse = (s.max(-1) + 0.5).astype(np.float32)
    delta = np.full((bh, lq), -12.3, np.float32)
    keep = np.ones((bh, lq, lk), np.float32)
    if dropout:
        keep = fa.dropout_multiplier(seed, bh, lq, lk, dropout).numpy()
        assert 0 < (keep == 0).sum() < keep.size
    got = fa.flash_attention_backward_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        *(torch.from_numpy(x) for x in (dout, lse, delta)), scale, dropout, seed)
    want = _emulate(q, k, v, dout, lse, delta, scale, keep)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    for point in ("q", "do", "ds", "pk"):
        other = _emulate(q, k, v, dout, lse, delta, scale, keep, skip=(point,))
        assert any(not np.array_equal(g.numpy(), w) for g, w in zip(got, other)), point


def test_f32_plain_backward_rounds_nothing():
    """f32 operands of bf16-representable values: the bf16 path's roundings
    would show, the f32 path takes none (float64 autograd, 1e-5)."""
    rng = np.random.RandomState(3)
    q, k, v = (_bf16_values(rng, 2, n, 24).float() for n in (40, 56, 56))
    dout = torch.from_numpy(rng.randn(2, 40, 24).astype(np.float32))
    scale = 0.3
    out, lse = fa.flash_attention_reference(q, k, v, scale)
    delta = (dout * out).sum(-1)
    got = fa.flash_attention_backward_reference(q, k, v, dout, lse, delta, scale)
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    ref = torch.softmax(leaves[0] @ leaves[1].transpose(1, 2) * scale, -1) @ leaves[2]
    want = torch.autograd.grad(ref, leaves, dout.double())
    low = fa.flash_attention_backward_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                                dout, lse, delta, scale)
    for g, w, b in zip(got, want, low):
        tol = 1e-5 * w.abs().max().item()
        assert (g.double() - w).abs().max().item() <= tol
        assert (b.double() - w).abs().max().item() > 10 * tol


@pytest.mark.parametrize("name", ["no_cap", "cap4", "tiles32"])
def test_bench_variants_apply_to_the_kernel_source(name):
    from buctd_tpu_torch.tools import bench_flash_bwd as bench

    text = bench.variant_source(name)
    assert text != bench.variant_source("shipped")
    for _, new in bench.VARIANTS[name]:
        assert new in text
