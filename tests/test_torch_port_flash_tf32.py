"""f32 K1 on the tensor cores (3xTF32), on the CPU: its arithmetic and its
fragment layouts.

The CUDA kernel (csrc/flash_fwd_tf32.cuh) runs only on the card, where
tests/test_torch_port_cuda.py and chip_smoke.py hold it against the plain
f32 forward.  Here:

* ``forward_tf32`` (ops/flash_attention.py), the dense emulation of the
  kernel's arithmetic (every operand split into hi = tf32(x) and
  lo = tf32(x - hi), each product in three passes with f32 sums), against
  JAX's ``_fwd_kernel`` in interpret mode at Precision.HIGHEST (exact f32 on
  the CPU): within atol = rtol = 2e-5, the f32 gate of the kernels (measured
  <= 9e-7 in out and lse here), while one tf32 pass (``passes=1``, what a
  plain TF32 kernel would compute, 3.6e-4 to 5.1e-4 away) misses it.
  Dropout 0.1: the TPU PRNG has no CPU lowering, so the test hands JAX's
  kernel the port's hash mask in place of
  ``pltpu.prng_random_bits`` (a monkeypatch of the kernel's mask helper,
  keyed by the same (bh, row, key)); the kernel's own math (mask after the
  sum l, kept entries scaled by 1 / (1 - p)) is unchanged.
* ``tf32_round`` (ops/tf32.py, csrc/mma_tf32.cuh's rna) bit for bit
  against a model of cvt.rna.tf32.f32 written from its definition (11
  significant bits, to nearest, ties away from zero) on finite values and
  +-inf.  ``tf32_split`` makes lo NaN beside every NaN or infinite operand
  (whose hi may wrap), so a NaN operand reaches the 3xTF32 product as it
  reaches f32's.
* A model of mma.m16n8k8's tf32 fragments (PTX ISA layouts): q' k^T with
  K's B fragment read as K[key g][t], K[key g][t + 4], and p v with the
  accumulators of s reused as the A fragment in the permuted key order (A
  column t <- key 2t, column t + 4 <- key 2t + 1) and V's B fragment read in
  the same order, give the products exactly; and the shared-memory reads of
  both, at the row stride D + 4 words, hit 32 distinct banks (the stride D
  would not).
* The variants of tools/bench_flash_fwd.py still apply to the kernel's
  source.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import flash_attention as fa
from buctd_tpu_torch.ops import tf32

# head dims 7 (padded to 16), 48, 96 and 112; every Lk ragged against the
# kernel's 64- and 32-key tiles
SHAPES = [(2, 40, 50, 7), (2, 64, 90, 48), (1, 70, 130, 96), (1, 50, 100, 112)]
ATOL = RTOL = 2e-5
SEED = 1234


def _qkv(bh, lq, lk, d):
    rng = np.random.RandomState(d)
    return tuple(rng.randn(bh, n, d).astype(np.float32) for n in (lq, lk, lk))


def _hash_keep(seed: int):
    """A stand-in for the JAX kernel's ``_dropout_keep`` that draws the port's
    hash mask (csrc/dropout_hash.cuh) for the kernel's current tile."""
    import jax
    from jax.experimental import pallas as pl

    def fmix(h):
        h = h ^ (h >> 16)
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> 13)
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> 16)

    def keep(shape, dropout):
        bh = pl.program_id(0).astype(jnp.uint32)
        rows = pl.program_id(1) * shape[0] + jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        cols = pl.program_id(2) * shape[1] + jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        row_key = fmix(fmix(np.uint32(seed) + bh * np.uint32(0x9E3779B9))
                       ^ (rows.astype(jnp.uint32) * np.uint32(0x85EBCA77)))
        bits = fmix(row_key ^ (cols.astype(jnp.uint32) * np.uint32(0xC2B2AE3D)))
        return jnp.where(bits >= np.uint32(fa.dropout_threshold(dropout)),
                         1.0 / (1.0 - dropout), 0.0)

    return keep


def _jax_forward(monkeypatch, q, k, v, scale, dropout):
    """out, lse of JAX's _fwd_kernel in interpret mode (f32: Precision.HIGHEST),
    with the port's mask where dropout > 0."""
    from buctd_tpu.ops import flash_attention as jax_fa

    if dropout > 0.0:
        monkeypatch.setattr(jax_fa, "_dropout_keep", _hash_keep(SEED))
        monkeypatch.setattr(jax_fa.pltpu, "prng_seed", lambda *seeds: None)
    out, lse = jax_fa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.zeros((1,), jnp.int32), scale, dropout, True)
    return np.asarray(out), np.asarray(lse)[:, :q.shape[1], 0]


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("bh,lq,lk,d", SHAPES)
def test_forward_tf32_matches_jax_interpret(monkeypatch, bh, lq, lk, d, dropout):
    q, k, v = _qkv(bh, lq, lk, d)
    scale = 1.0 / np.sqrt(d)
    want_out, want_lse = _jax_forward(monkeypatch, q, k, v, scale, dropout)
    keep = fa.dropout_multiplier(SEED, bh, lq, lk, dropout) if dropout > 0.0 else None
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = fa.forward_tf32(qt, kt, vt, scale, 3, keep)
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=RTOL)
    # the plain f32 forward draws the same mask: the JAX kernel took it
    plain, _ = fa.flash_attention_reference(qt, kt, vt, scale, dropout, SEED)
    np.testing.assert_allclose(plain.numpy(), want_out, atol=ATOL, rtol=RTOL)
    one_pass, _ = fa.forward_tf32(qt, kt, vt, scale, 1, keep)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(one_pass.numpy(), want_out, atol=ATOL, rtol=RTOL)


def test_forward_tf32_refuses_other_pass_counts():
    q = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        fa.forward_tf32(q, q, q, 0.5, 2)


# ------------------------------------------------------------- cvt.rna ----
def _cvt_rna(x):
    """cvt.rna.tf32.f32 from its definition: |x| rounded to 11 significant
    bits, to nearest with ties away from zero (normal numbers, 0 and
    +-inf)."""
    x64 = x.astype(np.float64)
    m, e = np.frexp(np.abs(x64))                    # |x| = m 2^e, m in [0.5, 1)
    r = np.floor(m * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return (np.sign(x64) * np.ldexp(r, e)).astype(np.float32)


# NaNs of both signs (CUDA's canonical 0x7fffffff, whose rounding carry
# reaches the sign bit; a quiet NaN; one with only low mantissa bits, which
# rounds to inf), then +-inf
NON_FINITE = np.array([0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000, 0xFFC00000, 0x7F800001,
                       0x7FFFF000, 0x7F800000, 0xFF800000], np.uint32).view(np.float32)


def test_tf32_round_matches_cvt_rna_model():
    rng = np.random.RandomState(0)
    spread = (rng.randn(20000) * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
    # exact ties, just below and above them, and mantissas of all ones (which
    # round up into the next binade), both signs
    base = (rng.randint(0x00800000, 0x7E000000, 4000) & ~0x1FFF).astype(np.uint32)
    edges = np.concatenate([base | 0x1000, base | 0x0FFF, base | 0x1001, base | 0x1FFF,
                            base | 0x7FFFFF]).view(np.float32)
    x = np.concatenate([spread, edges, -edges, np.zeros(2, np.float32), NON_FINITE])
    got = tf32.tf32_round(torch.from_numpy(x)).numpy()
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), _cvt_rna(x[~nan]).view(np.uint32))
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    # a NaN's carry wraps, as the kernels' rna does: the canonical NaN gives -0.0
    assert got.view(np.uint32)[-len(NON_FINITE)] == 0x80000000 and nan.sum() == 6
    ties = (base | 0x1000).view(np.float32)
    assert (np.abs(tf32.tf32_round(torch.from_numpy(ties)).numpy()) > ties).all()


def test_tf32_split_keeps_non_finite_operands():
    """lo is NaN beside every NaN or infinite operand, whatever hi became,
    and hi of an infinity is that infinity; so no operand that is not finite
    enters a product as a finite one (the rounding alone made the canonical
    NaN -0.0 in both halves)."""
    hi, lo = tf32.tf32_split(torch.from_numpy(NON_FINITE))
    assert torch.isnan(lo).all()
    np.testing.assert_array_equal(hi.numpy()[-2:], NON_FINITE[-2:])
    # a finite x: hi + lo = x to 2^-22, lo itself tf32
    x = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(np.float32))
    hi, lo = tf32.tf32_split(x)
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all()
    assert torch.equal(tf32.tf32_round(lo), lo)


@pytest.mark.parametrize("passes", [1, 3])
def test_tf32_product_takes_nan_as_f32_does(passes):
    """A NaN in one row of a makes that row of a b NaN and leaves the others
    as they were, as the f32 product does."""
    rng = np.random.RandomState(passes)
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((6, 24), (24, 5)))
    clean = tf32.tf32_product(a, b, passes)
    a[2, 7] = float("nan")
    got = tf32.tf32_product(a, b, passes)
    np.testing.assert_array_equal(torch.isnan(got).numpy(), torch.isnan(a @ b).numpy())
    keep = torch.arange(6) != 2
    assert torch.equal(got[keep], clean[keep])


# -------------------------------------------------- m16n8k8 tf32 fragments ----
def _lanes():
    lane = np.arange(32)
    return lane // 4, lane % 4                      # g, t


def _mma(a_regs, b_regs):
    """mma.m16n8k8 (.tf32): lane registers in, lane registers out.  a_regs
    (32, 4), b_regs (32, 2) -> c (32, 4), by the PTX ISA layouts:
    A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
    B b0 (t, g), b1 (t + 4, g); C c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
    c3 (g + 8, 2t + 1)."""
    g, t = _lanes()
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for reg, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
        a[g + dr, t + dc] = a_regs[:, reg]
    b[t, g], b[t + 4, g] = b_regs[:, 0], b_regs[:, 1]
    c = a @ b
    return np.stack([c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t], c[g + 8, 2 * t + 1]], 1)


def test_fragments_give_qk_and_pv_exactly():
    """s = q' k^T from q's A fragment and K read as K[g][t], K[g][t + 4];
    then p v with s's accumulators as the A fragment, permuted (a0 = c0,
    a1 = c2, a2 = c1, a3 = c3) and V read as V[2t][g], V[2t + 1][g]: both
    the exact products (integer values, no rounding)."""
    rng = np.random.RandomState(3)
    g, t = _lanes()
    q = rng.randint(-8, 8, (16, 8)).astype(np.float64)     # 16 rows x 8 of d
    k = rng.randint(-8, 8, (8, 8)).astype(np.float64)      # 8 keys x 8 of d
    v = rng.randint(-8, 8, (8, 8)).astype(np.float64)      # 8 keys x 8 of d
    qa = np.stack([q[g, t], q[g + 8, t], q[g, t + 4], q[g + 8, t + 4]], 1)
    s = _mma(qa, np.stack([k[g, t], k[g, t + 4]], 1))
    want_s = q @ k.T
    np.testing.assert_array_equal(s, np.stack([want_s[g, 2 * t], want_s[g, 2 * t + 1],
                                               want_s[g + 8, 2 * t],
                                               want_s[g + 8, 2 * t + 1]], 1))
    p = rng.randint(0, 8, (16, 8)).astype(np.float64)      # p in s's layout
    pc = np.stack([p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t], p[g + 8, 2 * t + 1]], 1)
    o = _mma(pc[:, [0, 2, 1, 3]], np.stack([v[2 * t, g], v[2 * t + 1, g]], 1))
    want_o = p @ v
    np.testing.assert_array_equal(o, np.stack([want_o[g, 2 * t], want_o[g, 2 * t + 1],
                                               want_o[g + 8, 2 * t],
                                               want_o[g + 8, 2 * t + 1]], 1))
    # the unpermuted reuse (a0 = c0, a1 = c1, ...) is not p v
    wrong = _mma(pc, np.stack([v[2 * t, g], v[2 * t + 1, g]], 1))
    assert not np.array_equal(wrong, o)


def _banks(stride: int, d_pad: int):
    """The 32-bit shared-memory banks of one warp's K and V fragment reads
    (every 8-key chunk and 8-column step of a tile with rows `stride` words
    apart): the sets of banks of b0 and b1 of each read."""
    g, t = _lanes()
    reads = []
    for chunk in range(8):
        for col in range(0, d_pad, 8):
            k_row = (chunk * 8 + g) * stride + col + t            # K[key g][t]
            v_row = (chunk * 8 + 2 * t) * stride + col + g        # V[key 2t][g]
            reads += [k_row, k_row + 4, v_row, v_row + stride]
    return [set(r % 32) for r in reads]


@pytest.mark.parametrize("d_pad", [16, 32, 48, 64, 80, 96, 112, 128])
def test_fragment_reads_are_free_of_bank_conflicts(d_pad):
    stride = d_pad + 4                                # csrc/mma_tf32.cuh::stride<D>()
    assert stride * 4 % 16 == 0                       # rows 16-byte aligned for cp.async
    assert all(len(b) == 32 for b in _banks(stride, d_pad))
    assert any(len(b) < 32 for b in _banks(d_pad, d_pad))   # the unpadded stride conflicts


@pytest.mark.parametrize("name", ["one_sm", "warps4", "tiles32", "cvtsplit", "nanfree"])
def test_bench_variants_apply_to_the_kernel_source(name):
    """tools/bench_flash_fwd.py builds its variants by text substitution in
    the kernel's headers: each still applies and changes the source."""
    from buctd_tpu_torch.tools import bench_flash_fwd as bench

    texts = bench.variant_sources(name)
    assert texts != bench.variant_sources("shipped")
    for header, _, new in bench.VARIANTS[name]:
        assert new in texts[header]
