"""f32 K2 on the tensor cores (3xTF32), on the CPU: its arithmetic and its
fragment layouts.

The CUDA kernels (csrc/flash_bwd_tf32.cuh: flash_bwd_dq_tf32_kernel and
flash_bwd_dkv_tf32_kernel, which K2' launches too) run only on the card,
where tests/test_torch_port_cuda.py and chip_smoke.py hold them against the
plain backward.  Here:

* ``backward_tf32`` (ops/flash_attention.py), the dense emulation of the
  kernels' arithmetic (q' = q * scale * log2 e, every operand split into hi
  = tf32(x) and lo = tf32(x - hi), each product in three passes with f32
  sums, dq, dk and dv folded over the kernels' looped tiles), against the
  VJP of JAX's flash attention (``_dq_kernel`` and ``_dkv_kernel``) in
  interpret mode at Precision.HIGHEST (exact f32 on the CPU), from JAX's own
  forward (lse, out): within atol = rtol = 1e-4, chip_smoke.py's f32 K2 gate
  (measured at most 1.7e-6 here), while one tf32 pass (``passes=1``, what a
  single-pass kernel would compute, measured 2.8e-4 to 1.4e-3 away) misses
  it in each of dq, dk and dv.
  Dropout 0.1: JAX's kernels take the port's hash mask in place of the TPU
  PRNG (the stand-in of test_torch_port_flash_tf32.py; the backward tiles
  here are one block in each direction, so the tile's rows and columns are
  the call's).
* A model of mma.m16n8k8's tf32 fragments for every product of both
  kernels: s = q' k^T and g = do v^T (dq kernel; A the warp's rows, B the
  looped tile's rows T[g][t], T[g][t + 4]), s^T = k q'^T and g^T = v do^T
  (dk/dv kernel), and the three products whose A operand is an accumulator,
  dq = ds k, dv = (p keep c)^T do and dk = ds^T q' (A permuted by
  tf32::c_to_a, B read as T[2t][g], T[2t + 1][g]): each gives the exact
  product.  Every 32-bit shared read of them (the B reads of both orders,
  and the A reads of the block's own tile: dq's above d = 48, dk/dv's at
  every d) hits 32 distinct banks at the row stride D + 4 words, where the
  stride D would conflict.
* ``bwd_loop_tile`` against the .cuh's looped-tile rule.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch._build import CSRC
from buctd_tpu_torch.ops import flash_attention as fa
from test_torch_port_flash_tf32 import SEED, _hash_keep

# head dims 40 (padded to 48), 48, 96 and 112; Lq, Lk ragged against every
# looped tile and at most 768 (one backward block of the JAX kernels)
SHAPES = [(2, 100, 130, 40), (2, 64, 90, 48), (1, 70, 130, 96), (1, 50, 100, 112)]
ATOL = RTOL = 1e-4


def _operands(bh, lq, lk, d):
    rng = np.random.RandomState(d + lq)
    q, k, v = (rng.randn(bh, n, d).astype(np.float32) for n in (lq, lk, lk))
    return q, k, v, rng.randn(bh, lq, d).astype(np.float32)


def _jax_backward(monkeypatch, q, k, v, dout, scale, dropout):
    """dq, dk, dv of JAX's backward kernels in interpret mode (f32:
    Precision.HIGHEST), from its forward's lse and out, with the port's mask
    where dropout > 0; and that lse and out."""
    from buctd_tpu.ops import flash_attention as jax_fa

    if dropout > 0.0:
        monkeypatch.setattr(jax_fa, "_dropout_keep", _hash_keep(SEED))
        monkeypatch.setattr(jax_fa.pltpu, "prng_seed", lambda *seeds: None)
    args = [jnp.asarray(x) for x in (q, k, v)]
    seed = jnp.zeros((1,), jnp.int32)
    out, lse = jax_fa._flash_fwd_impl(*args, seed, scale, dropout, True)
    grads = jax_fa._flash_bwd_impl(*args, seed, scale, dropout, True, lse, out,
                                   jnp.asarray(dout))
    return ([np.asarray(g) for g in grads], np.array(lse)[:, :q.shape[1], 0].copy(),
            np.array(out))


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("bh,lq,lk,d", SHAPES)
def test_backward_tf32_matches_jax_interpret(monkeypatch, bh, lq, lk, d, dropout):
    q, k, v, dout = _operands(bh, lq, lk, d)
    scale = 1.0 / np.sqrt(d)
    want, lse, out = _jax_backward(monkeypatch, q, k, v, dout, scale, dropout)
    keep = fa.dropout_multiplier(SEED, bh, lq, lk, dropout) if dropout > 0.0 else None
    qt, kt, vt, dt = (torch.from_numpy(x) for x in (q, k, v, dout))
    lse_t = torch.from_numpy(lse)
    delta = (dt * torch.from_numpy(out)).sum(-1)
    for got, ref in zip(fa.backward_tf32(qt, kt, vt, dt, lse_t, delta, scale, 3, keep), want):
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    # the plain f32 backward draws the same mask: the JAX kernels took it
    plain = fa.flash_attention_backward_reference(qt, kt, vt, dt, lse_t, delta, scale,
                                                  dropout, SEED)
    for got, ref in zip(plain, want):
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    one_pass = fa.backward_tf32(qt, kt, vt, dt, lse_t, delta, scale, 1, keep)
    misses = 0
    for got, ref in zip(one_pass, want):
        try:
            np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
        except AssertionError:
            misses += 1
    assert misses == 3


@pytest.mark.parametrize("passes", [1, 3])
def test_emulations_take_nan_as_plain(passes):
    """A NaN in q reaches forward_tf32's out and lse and backward_tf32's dq,
    dk and dv where it reaches the plain versions' (the split's lo carries
    it: chip_smoke.py and the card tests hold the kernels to the same)."""
    q, k, v, dout = (torch.from_numpy(x) for x in _operands(2, 40, 50, 48))
    q[1, 17, 5] = float("nan")
    scale = 48 ** -0.5
    out, lse = fa.flash_attention_reference(q, k, v, scale)
    delta = (dout * out).sum(-1)
    want = ((out, lse), fa.flash_attention_backward_reference(q, k, v, dout, lse, delta, scale))
    got = (fa.forward_tf32(q, k, v, scale, passes),
           fa.backward_tf32(q, k, v, dout, lse, delta, scale, passes))
    for g_set, w_set in zip(got, want):
        for g, w in zip(g_set, w_set):
            bad = ~torch.isfinite(w)
            assert bad.any() and torch.equal(~torch.isfinite(g), bad)


def test_backward_tf32_refuses_other_pass_counts():
    q = torch.zeros(1, 4, 8)
    lse = torch.zeros(1, 4)
    with pytest.raises(ValueError):
        fa.backward_tf32(q, q, q, q, lse, lse, 0.5, 2)


@pytest.mark.parametrize("d", [7, 16, 40, 48, 64, 96, 128])
def test_loop_tile_follows_the_kernel_source(d):
    """The mma.sync kernels' tiles (``wgmma=False``; the dispatch's at d = 7,
    which no wgmma kernel takes): dq's key tile is 64 while the padded head
    dim is at most 48 (the .cuh's rule), else 32; dk/dv's q tile is 32.  The
    wgmma kernels' tiles are held to their source by
    test_torch_port_flash_bwd_tf32_wgmma.py."""
    src = (CSRC / "flash_bwd_tf32.cuh").read_text()
    assert "constexpr int bwd_loop_tile() { return kDq && D <= 48 ? 64 : 32; }" in src
    assert re.search(r"constexpr bool bwd_reg_a\(\) \{ return D <= 48; \}", src)
    pad = -(-d // 16) * 16
    assert fa.bwd_loop_tile(d, True, wgmma=False) == (64 if pad <= 48 else 32)
    assert fa.bwd_loop_tile(d, False, wgmma=False) == 32
    if d % 8:
        assert fa.bwd_loop_tile(d, True) == (64 if pad <= 48 else 32)


# -------------------------------------------------- m16n8k8 tf32 fragments ----
def _lanes():
    lane = np.arange(32)
    return lane // 4, lane % 4                      # g, t


def _mma(a_regs, b_regs):
    """mma.m16n8k8 (.tf32): lane registers in, lane registers out (the PTX
    ISA layouts: A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
    B b0 (t, g), b1 (t + 4, g); C c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
    c3 (g + 8, 2t + 1))."""
    g, t = _lanes()
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for reg, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
        a[g + dr, t + dc] = a_regs[:, reg]
    b[t, g], b[t + 4, g] = b_regs[:, 0], b_regs[:, 1]
    c = a @ b
    return np.stack([c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t], c[g + 8, 2 * t + 1]], 1)


def _c_layout(m):
    """A 16 x 8 matrix in the C layout (lane registers)."""
    g, t = _lanes()
    return np.stack([m[g, 2 * t], m[g, 2 * t + 1], m[g + 8, 2 * t], m[g + 8, 2 * t + 1]], 1)


def _a_rows(m, k0=0):
    """The A fragment of rows 0..15, columns k0..k0 + 7 of m (the block's
    own tile: a_frags / a_frag)."""
    g, t = _lanes()
    return np.stack([m[g, k0 + t], m[g + 8, k0 + t], m[g, k0 + t + 4], m[g + 8, k0 + t + 4]], 1)


def _b_rows(tile, n0, k0):
    """B of the looped tile read as T[row n0 + g][k0 + t], [k0 + t + 4]: the
    n8 tile of rows n0.. over the k8 step k0 (s = q' K^T, g = do V^T and
    their transposes)."""
    g, t = _lanes()
    return np.stack([tile[n0 + g, k0 + t], tile[n0 + g, k0 + t + 4]], 1)


def _b_perm(tile, k0, n0):
    """B of the looped tile read in the permuted order T[k0 + 2t][n0 + g],
    T[k0 + 2t + 1][n0 + g] (the products whose A is an accumulator)."""
    g, t = _lanes()
    return np.stack([tile[k0 + 2 * t, n0 + g], tile[k0 + 2 * t + 1, n0 + g]], 1)


def _c_to_a(c):
    """tf32::c_to_a: a0 = c0, a1 = c2, a2 = c1, a3 = c3."""
    return c[:, [0, 2, 1, 3]]


def _product(own, looped, d):
    """The warp's 16 rows of own (16, d) times the looped tile (n, d)^T as
    the kernels take it: per n8 tile of looped rows, k8 steps over d, A from
    the own rows and B = T[g][t], [t + 4].  Returns the C tiles."""
    return [sum(_mma(_a_rows(own, k0), _b_rows(looped, n0, k0)) for k0 in range(0, d, 8))
            for n0 in range(0, looped.shape[0], 8)]


def _from_acc(c_tiles, looped, d):
    """The product whose A is the accumulators c_tiles (16 x 8 NL) and whose
    B is the looped tile (8 NL, d): A permuted, B read as T[2t][g]; per n8
    tile of d, k8 steps over the looped rows."""
    return [sum(_mma(_c_to_a(c), _b_perm(looped, 8 * kk, n0)) for kk, c in enumerate(c_tiles))
            for n0 in range(0, d, 8)]


def _ints(rng, *shape):
    return rng.randint(-8, 8, shape).astype(np.float64)


@pytest.mark.parametrize("nl", [32, 64])
@pytest.mark.parametrize("d", [16, 48])
def test_dq_kernel_fragments_give_every_product_exactly(d, nl):
    """dq kernel: s = q' K^T and g = do V^T from the warp's q' and do rows and
    the key tile's rows; then dq = ds K with the accumulators (here s
    itself, an integer matrix in s's layout) as A, permuted, and K read as
    K[2t][g]: the exact products (integer values, no rounding)."""
    rng = np.random.RandomState(d + nl)
    q, do = _ints(rng, 16, d), _ints(rng, 16, d)
    k, v = _ints(rng, nl, d), _ints(rng, nl, d)
    for own, looped in ((q, k), (do, v)):
        got = _product(own, looped, d)
        want = own @ looped.T
        for n, c in enumerate(got):
            np.testing.assert_array_equal(c, _c_layout(want[:, 8 * n:8 * n + 8]))
    ds = _ints(rng, 16, nl)
    dq = _from_acc([_c_layout(ds[:, 8 * j:8 * j + 8]) for j in range(nl // 8)], k, d)
    want = ds @ k
    for n, c in enumerate(dq):
        np.testing.assert_array_equal(c, _c_layout(want[:, 8 * n:8 * n + 8]))
    # the unpermuted reuse of the accumulators is not ds K
    wrong = sum(_mma(_c_layout(ds[:, 8 * j:8 * j + 8]), _b_perm(k, 8 * j, 0))
                for j in range(nl // 8))
    assert not np.array_equal(wrong, dq[0])


@pytest.mark.parametrize("d", [16, 48, 96])
def test_dkv_kernel_fragments_give_every_product_exactly(d):
    """dk/dv kernel: s^T = K q'^T and g^T = V do^T from the warp's key rows
    and the q tile's rows; dv = (p keep c)^T do and dk = ds^T q' from the
    accumulators (16 keys x 32 queries) as A, permuted, and do, q' read as
    T[2t][g]."""
    rng = np.random.RandomState(d)
    kr, vr = _ints(rng, 16, d), _ints(rng, 16, d)
    q, do = _ints(rng, 32, d), _ints(rng, 32, d)
    for own, looped in ((kr, q), (vr, do)):
        for n, c in enumerate(_product(own, looped, d)):
            np.testing.assert_array_equal(c, _c_layout((own @ looped.T)[:, 8 * n:8 * n + 8]))
    pk, ds = _ints(rng, 16, 32), _ints(rng, 16, 32)        # keys x queries
    for acc, looped in ((pk, do), (ds, q)):
        got = _from_acc([_c_layout(acc[:, 8 * j:8 * j + 8]) for j in range(4)], looped, d)
        want = acc @ looped
        for n, c in enumerate(got):
            np.testing.assert_array_equal(c, _c_layout(want[:, 8 * n:8 * n + 8]))


def _bank_sets(stride: int, d_pad: int, rows: int):
    """The 32-bit banks of every shared read of one warp, one set per load
    instruction: B T[g][t] and T[g][t + 4] of each n8 row tile and k8 step,
    B T[2t][g] and T[2t + 1][g] of each k8 row step and n8 column tile, and
    the A reads of a 16-row own tile (rows g, g + 8; columns k0 + t, + 4)."""
    g, t = _lanes()
    reads = []
    for r0 in range(0, rows, 8):
        for c0 in range(0, d_pad, 8):
            rows_read = (r0 + g) * stride + c0 + t               # T[g][t]
            perm = (r0 + 2 * t) * stride + c0 + g                # T[2t][g]
            reads += [rows_read, rows_read + 4, perm, perm + stride]
    for k0 in range(0, d_pad, 8):
        own = g * stride + k0 + t
        reads += [own, own + 8 * stride, own + 4, own + 8 * stride + 4]
    return [set(r % 32) for r in reads]


@pytest.mark.parametrize("d_pad", [16, 32, 48, 64, 80, 96, 112, 128])
def test_shared_reads_are_free_of_bank_conflicts(d_pad):
    """At the kernels' row stride D + 4 words (4 times an odd number) every
    32-bit shared read of both kernels is one wavefront; the unpadded stride
    would conflict."""
    stride = d_pad + 4                                # csrc/mma_tf32.cuh::stride<D>()
    assert stride * 4 % 16 == 0 and (stride // 4) % 2 == 1
    assert all(len(b) == 32 for b in _bank_sets(stride, d_pad, 64))
    assert any(len(b) < 32 for b in _bank_sets(d_pad, d_pad, 64))


def test_simt_wrappers_refuse_what_they_do_not_launch():
    """The f32 SIMT kernels kept for the A/B take f32 CUDA tensors: bf16
    operands raise TypeError, CPU tensors ValueError (the plain backward is
    theirs), and neither counts a launch."""
    q, lse = torch.zeros(1, 16, 8), torch.zeros(1, 16)
    before = (fa.flash_bwd_dq_simt.launches, fa.flash_bwd_dkv_simt.launches)
    for fn in (fa.flash_bwd_dq_simt, fa.flash_bwd_dkv_simt):
        with pytest.raises(ValueError, match="CUDA kernel"):
            fn(q, q, q, q, lse, lse, 0.3)
        with pytest.raises(TypeError):
            fn(*(x.to(torch.bfloat16) for x in (q, q, q)), q, lse, lse, 0.3)
    assert (fa.flash_bwd_dq_simt.launches, fa.flash_bwd_dkv_simt.launches) == before


@pytest.mark.parametrize("name", ["smem_a", "cvtsplit", "nanfree"])
def test_bench_variants_apply_to_the_kernel_source(name):
    """tools/bench_flash_bwd.py --dtype float32 builds its variants by text
    substitution: each applies and changes the source, the kernel header
    beside any other header it changes."""
    from buctd_tpu_torch.tools import bench_flash_bwd as bench

    texts = bench.variant_sources(name, "float32")
    assert "flash_bwd_tf32.cuh" in texts
    assert texts != bench.variant_sources("shipped", "float32")
