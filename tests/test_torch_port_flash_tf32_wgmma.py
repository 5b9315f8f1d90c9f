"""f32 K1's TMA + wgmma kernel (csrc/flash_fwd_tf32_wgmma.cuh), on the CPU:
its dispatch, its tiles and ring, a model of its tf32 fragments and shared
layouts, and its arithmetic against the JAX kernel.

The kernel runs only on the card, where tests/test_torch_port_cuda.py and
chip_smoke.py hold it against the plain f32 forward.  Here:

* ``takes_wgmma_f32`` (the rule of csrc/flash_fwd_tf32_wgmma.cuh::takes: f32,
  d a multiple of 8 up to 128, q, k and v 16-byte aligned) by head dim and
  base alignment, and the launch counters that follow it (f32 calls counted
  on ``f32_wgmma_launches`` or ``f32_mma_launches``; CPU calls count none);
* the key tiles and ring slots of ``tf32_wgmma_key_tile`` and
  ``tf32_wgmma_stages`` against the constants and the shared-memory formula
  of the .cuh;
* a numpy model of wgmma m64nNk8 on tf32 operands (PTX ISA layouts): S = q'
  K^T with both operands read K-major through 64-byte-swizzle descriptors
  from the bytes TMA's 64-byte swizzle writes (q' and K split in place, so
  the kernel computes a swizzled address only for q' hi's register
  fragments up to d = 48, also modelled), and P V with the S
  accumulators reused as the A fragment in the kernel's permuted key order
  against V^T as the split warps write it (the unswizzled core-matrix
  layout, read through the kernel's descriptor): both the exact products,
  while the unpermuted reuse is not; every element of each layout is read
  back from one address of its own, and the split warps' reads and writes
  of V hit distinct banks;
* ``forward_tf32``, the dense emulation of the kernel's 3xTF32 arithmetic,
  against JAX's ``_fwd_kernel`` in interpret mode at Precision.HIGHEST over
  several of the kernel's key tiles at d = 48 and 112, dropout 0 and 0.1,
  within 2e-5 (the one-pass control misses);
* the f32 variants of tools/bench_flash_fwd.py still apply to the source.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import itertools
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import flash_attention as fa
from test_torch_port_flash_tf32 import ATOL, RTOL, SEED, _jax_forward

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "flash_fwd_tf32_wgmma.cuh"
# (BH, Lq, Lk, d): several 64-key tiles at d = 48 and several 32-key tiles
# at d = 112, each with a ragged last tile and a ragged last q block
JAX_SHAPES = [(1, 70, 200, 48), (2, 130, 150, 112), (1, 40, 96, 112)]


def _f32(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _constants() -> dict:
    text = SOURCE.read_text()
    names = ("kConsumers", "kPanel", "kSplitWarps", "kStages", "kKvresStages",
             "kNarrowKeyTile", "kWideKeyTile", "kPvSplitFrom", "kSmemLimit")
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", text).group(1)) for n in names}


def _smem(c, d, bk, stages):
    """csrc/flash_fwd_tf32_wgmma.cuh::smem_for, from its constants."""
    rows = 64 * c["kConsumers"]
    return 1024 + 2 * rows * d * 4 + stages * 4 * bk * d * 4 + 8 * (c["kConsumers"] + 6 * stages)


def test_tiles_and_ring_match_the_cuda_source():
    c = _constants()
    text = SOURCE.read_text()
    assert ("return 1024 + 2 * kRows * D * 4 + stages * 4 * BK * D * 4 + 8 * (kConsumers + 6 * "
            "stages);") in text
    assert fa.TF32_WGMMA_KEY_TILE == {"narrow": c["kNarrowKeyTile"], "wide": c["kWideKeyTile"]}
    assert fa.TF32_WGMMA_STAGES == {"k1": c["kStages"], "k1_kvres": c["kKvresStages"]}
    assert fa.SMEM_LIMIT == c["kSmemLimit"] and fa.WGMMA_ROWS == 64 * c["kConsumers"]
    for d in range(8, fa.MAX_HEAD_DIM + 1, 8):
        dp = -(-d // 16) * 16
        bk = c["kNarrowKeyTile"] if dp <= 64 else c["kWideKeyTile"]
        while bk > 8 and _smem(c, dp, bk, 2) > c["kSmemLimit"]:
            bk //= 2
        assert fa.tf32_wgmma_key_tile(d) == bk
        assert fa.tf32_wgmma_smem(d, bk, 2) == _smem(c, dp, bk, 2) <= c["kSmemLimit"]
        for kvres, want in ((False, c["kStages"]), (True, c["kKvresStages"])):
            s = fa.tf32_wgmma_stages(d, kvres)
            assert 2 <= s <= want and _smem(c, dp, bk, s) <= c["kSmemLimit"]
            assert s == want or _smem(c, dp, bk, s + 1) > c["kSmemLimit"]
    # the model paths: 64-key tiles at d = 48, 32 at 96 and 112; K1' three
    # slots at d = 48 and K1's two at 96 and 112 (three do not fit there)
    assert [fa.tf32_wgmma_key_tile(d) for d in (48, 96, 112, 128)] == [64, 32, 32, 16]
    assert [fa.tf32_wgmma_stages(d, True) for d in (48, 96, 112)] == [3, 2, 2]
    assert all(fa.tf32_wgmma_stages(d) == 2 for d in (48, 96, 112))


@pytest.mark.parametrize("d,want", [(48, True), (96, True), (112, True), (128, True),
                                    (8, True), (40, True), (7, False), (47, False),
                                    (100, False), (136, False)])
def test_dispatch_by_head_dim(d, want):
    q = _f32(2, 30, d)
    assert fa.takes_wgmma_f32(q, q.clone(), q.clone()) is want
    # bf16 operands take the bf16 rule, and the bf16 rule no f32 operand
    assert fa.takes_wgmma_f32(*(q.to(torch.bfloat16),) * 3) is False
    assert fa.takes_wgmma(q, q, q) is False


def _view(d, offset, dtype=torch.float32):
    """A contiguous (1, 30, d) view that starts ``offset`` elements into its
    storage."""
    return _f32(offset + 30 * d).to(dtype)[offset:].view(1, 30, d)


@pytest.mark.parametrize("d,offset,want", [(48, 0, True), (48, 48, True), (48, 4, True),
                                           (48, 2, False), (48, 1, False), (112, 56, True),
                                           (112, 58, False), (8, 4, True), (8, 6, False)])
def test_dispatch_by_base_alignment(d, offset, want):
    """TMA reads from 16-byte aligned bases: an f32 view ``offset`` elements
    into its storage qualifies where offset is a multiple of 4 (d a multiple
    of 8 keeps every row start aligned), for any of q, k and v."""
    view, ok = _view(d, offset), _view(d, 0)
    assert view.data_ptr() % 16 == (offset * 4) % 16
    assert fa.takes_wgmma_f32(view, ok, ok) is want
    assert fa.takes_wgmma_f32(ok, view, ok) is want
    assert fa.takes_wgmma_f32(ok, ok, view) is want


@pytest.mark.parametrize("dtype,d,offset,counted", [
    (torch.float32, 48, 0, "f32_wgmma"), (torch.float32, 112, 0, "f32_wgmma"),
    (torch.float32, 47, 0, "f32_mma"), (torch.float32, 48, 2, "f32_mma"),
    (torch.bfloat16, 48, 0, "wgmma"), (torch.bfloat16, 48, 4, "mma")])
def test_launch_counters_follow_the_dispatch(dtype, d, offset, counted):
    """One launch on the wrapper and one on the counter of the kernel the
    rule picks, by dtype: f32 calls never move the bf16 counters, nor bf16
    calls the f32 ones."""
    kinds = ("wgmma", "mma", "f32_wgmma", "f32_mma")
    wrapper = types.SimpleNamespace(launches=0, **{f"{k}_launches": 0 for k in kinds})
    q, kv = _view(d, offset, dtype), _view(d, 0, dtype)
    fa._count(wrapper, q, kv, kv)
    assert wrapper.launches == 1
    assert {k: getattr(wrapper, f"{k}_launches") for k in kinds} == \
        {k: int(k == counted) for k in kinds}


def test_cpu_calls_count_no_kernel():
    q = _f32(1, 16, 48)
    names = ("launches", "wgmma_launches", "mma_launches", "f32_wgmma_launches",
             "f32_mma_launches")
    wrappers = (fa.flash_attention, fa.flash_attention_kvres)
    before = [getattr(f, n) for f in wrappers for n in names]
    fa.flash_attention(q, q, q, 0.2)
    assert [getattr(f, n) for f in wrappers for n in names] == before


def test_mma_wrapper_refuses_cpu_tensors_in_f32():
    q = _f32(1, 16, 48)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attention_mma(q, q, q, 0.2)


# --------------------------------------------- the wgmma fragment model ----
def _lanes():
    lane = np.arange(32)
    return lane // 4, lane % 4                      # gid, tig


def _acc_rows_cols(n):
    """The m64nN f32 accumulator: (thread, register) -> (row, col), for the
    128 threads of a warpgroup and the N / 2 registers of each."""
    thread = np.arange(128)
    warp, lane = thread // 32, thread % 32
    gid, tig = lane // 4, lane % 4
    i = np.arange(n // 2)
    row = 16 * warp[:, None] + gid[:, None] + 8 * ((i[None, :] >> 1) & 1)
    col = 8 * (i[None, :] >> 2) + 2 * tig[:, None] + (i[None, :] & 1)
    return row, col


def _a_frag_rows_cols():
    """The tf32 A fragment of one k8 step in registers: (thread, register)
    -> (row, column): a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4),
    a3 (gid + 8, tig + 4), rows 16 warp + ... ."""
    thread = np.arange(128)
    warp, lane = thread // 32, thread % 32
    gid, tig = lane // 4, lane % 4
    dr, dc = np.array([0, 8, 0, 8]), np.array([0, 0, 4, 4])
    return (16 * warp[:, None] + gid[:, None] + dr[None, :], tig[:, None] + dc[None, :])


def _tma_sw64(x):
    """The bytes TMA's 64-byte swizzle writes for an (R, D) f32 box set cut
    into 16-column panels (one box a panel), as a flat f32 array: element (r,
    c) of panel c // 16 at byte 64 r + 16 ((c % 16 // 4) ^ (r // 2 % 4)) + 4
    (c % 4) of its panel."""
    rows, d = x.shape
    smem = np.full(rows * d, np.nan)
    r, c = np.meshgrid(np.arange(rows), np.arange(d), indexing="ij")
    byte = (c // 16) * rows * 64 + 64 * r + 16 * ((c % 16 // 4) ^ (r // 2 % 4)) + 4 * (c % 4)
    smem[byte // 4] = x
    return smem


def _sw64(addr):
    """wgmma's 64-byte swizzle of a byte address (Swizzle<2,4,3>): the 16-byte
    chunk bits 4-5 XOR bits 7-8."""
    return addr ^ (((addr >> 7) & 3) << 4)


def _read_kmajor(smem, start, rows, layout, lbo=0, sbo=512):
    """The (rows, 8) K-major operand a descriptor at byte ``start`` gives one
    k8 step: row r, column k at start + (r // 8) SBO + in-group offset, with
    the 64-byte swizzle (``layout`` "sw64": rows 64 bytes apart, the two
    16-byte halves of the step adjacent, the address swizzled) or none
    ("il": core matrices of 8 rows x 16 bytes, the halves LBO apart).  Also
    returns the byte address of every element."""
    r, k = np.meshgrid(np.arange(rows), np.arange(8), indexing="ij")
    if layout == "sw64":
        addr = _sw64(start + (r // 8) * sbo + (r % 8) * 64 + (k // 4) * 16 + 4 * (k % 4))
    else:
        addr = start + (r // 8) * sbo + (k // 4) * lbo + (r % 8) * 16 + 4 * (k % 4)
    return smem[addr // 4], addr


def _issue_s(q_img, k_img, bk, d):
    """The kernel's issue_s over one warpgroup's 64 q' rows and a BK-key
    tile, both in TMA's 64-byte-swizzled panels: A at panel kk // 2 + 32
    bytes for the odd step, B likewise; D[m][n] += A[m][:] . B[n][:]."""
    s, seen_q, seen_k = np.zeros((64, bk)), [], []
    for kk in range(d // 8):
        a, qa = _read_kmajor(q_img, (kk // 2) * 64 * 64 + (kk % 2) * 32, 64, "sw64")
        b, ka = _read_kmajor(k_img, (kk // 2) * bk * 64 + (kk % 2) * 32, bk, "sw64")
        s += a @ b.T
        seen_q.append(qa)
        seen_k.append(ka)
    return s, np.concatenate(seen_q, 1), np.concatenate(seen_k, 1)


def _vt_offset(c, q, bk):
    """csrc/flash_fwd_tf32_wgmma.cuh::vt_offset: byte offset of the 4 key
    positions 4 q .. 4 q + 3 of column c of V^T."""
    return (c // 8) * (32 * bk) + q * 128 + (c % 8) * 16


def _split_warps_vt(v, bk, split_warps=3):
    """The split warps' writes of V^T from a raw (BK, D) tile, unit by unit
    as the kernel's loop walks them: each warp iteration ``it`` of key octet a
    and 16-column panel, lane -> key parity vp, column c; the unit reads keys
    8 a + vp + 2 e (e = 0..3) of column c and writes them as positions 8 a + 4
    vp + e.  Returns the V^T image, and per warp iteration the banks of each
    of the 4 reads (an array of 32 lanes each) and the byte offsets of the
    16-byte writes, lane by lane."""
    bkeys, d = v.shape
    img = np.full(bkeys * d, np.nan)
    lane = np.arange(32)
    vp, vc = (lane >> 3) & 1, 8 * (lane >> 4) + (lane & 7)
    reads, writes = [], []
    for sw in range(split_warps):
        for it in range(sw, (bkeys // 8) * (d // 16), split_warps):
            a, c = it // (d // 16), 16 * (it % (d // 16)) + vc
            off = _vt_offset(c, 2 * a + vp, bkeys)
            for e in range(4):
                key = 8 * a + vp + 2 * e
                img[off // 4 + e] = v[key, c]
                reads.append((key * d + c) % 32)
            writes.extend(off.tolist())
    return img, reads, writes


def _kernel_text_has(*lines):
    text = SOURCE.read_text()
    for line in lines:
        assert line in text, line


@pytest.mark.parametrize("d,bk", [(48, 64), (96, 32), (112, 32), (128, 16)])
def test_fragments_give_qk_and_pv_exactly(d, bk):
    """S = q' K^T from the swizzled q' and K images through the kernel's
    descriptors, then P V with S's accumulators as the A fragment in the
    permuted key order (a0 <- c0, a1 <- c2, a2 <- c1, a3 <- c3) against the
    split warps' V^T through the kernel's descriptor (LBO 128, SBO 32 BK,
    256 bytes a k8 step), as one product over d and as two column halves
    (kPvSplitFrom): both the exact
    products (integer values).  The unpermuted reuse is not P V.  q' hi read
    into A fragments from its swizzled place (q_in_regs) is q' itself."""
    _kernel_text_has(
        "const uint64_t a = wgt::sw64_desc(qa + (kk / 2) * 64 * 64 + (kk % 2) * 32);",
        "const uint64_t b = wgt::sw64_desc(kb + (kk / 2) * BK * 64 + (kk % 2) * 32);",
        "const uint64_t b = wgt::il_desc(vb + kk * 256, 128, 32 * BK);",
        "return (c / 8) * (32 * BK) + q * 128 + (c % 8) * 16;",
        "tf32::split(s[4 * kk + 0], ph[kk][0], pl[kk][0]);",
        "tf32::split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);",
        "tf32::split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);",
        "tf32::split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);",
        "((((c % 16) >> 2) ^ ((r >> 1) & 3)) << 4) + (c % 4) * 4);")
    rng = np.random.RandomState(d)
    q = rng.randint(-8, 8, (64, d)).astype(np.float64)
    k = rng.randint(-8, 8, (bk, d)).astype(np.float64)
    v = rng.randint(-8, 8, (bk, d)).astype(np.float64)
    q_img = _tma_sw64(q)
    s, _, _ = _issue_s(q_img, _tma_sw64(k), bk, d)
    np.testing.assert_array_equal(s, q @ k.T)
    # q' hi as registers (kQRegsUpTo): each A fragment read at its swizzled
    # place is q's element, so the register passes take the same operand
    arow, acol = _a_frag_rows_cols()
    for kk in range(d // 8):
        r, c = arow, 8 * kk + acol
        addr = (c // 16) * 64 * 64 + r * 64 + (((c % 16) >> 2) ^ ((r >> 1) & 3)) * 16 + 4 * (c % 4)
        np.testing.assert_array_equal(q_img[addr // 4], q[r, c])

    p = rng.randint(0, 8, (64, bk)).astype(np.float64)
    row, col = _acc_rows_cols(bk)
    acc = p[row, col]                                 # (128 threads, BK / 2) registers
    vt, _, _ = _split_warps_vt(v, bk)
    # one product over d, or two halves (kPvSplitFrom)
    for parts, (order, exact) in itertools.product((1, 2), (([0, 2, 1, 3], True),
                                                            ([0, 1, 2, 3], False))):
        out = np.zeros((64, d))
        for part in range(parts):
            n = d // parts
            for kk in range(bk // 8):
                regs = acc[:, 4 * kk:4 * kk + 4][:, order]
                a = np.zeros((64, 8))
                a[arow, acol] = regs
                b, _ = _read_kmajor(vt, part * (n // 8) * 32 * bk + kk * 256, n, "il",
                                    lbo=128, sbo=32 * bk)
                out[:, part * n:(part + 1) * n] += a @ b.T
        assert np.array_equal(out, p @ v) is exact


@pytest.mark.parametrize("d,bk", [(48, 64), (96, 32), (112, 32), (128, 16)])
def test_layouts_read_back_every_element_once(d, bk):
    """Each descriptor read of the kernel's tiles hits every element of its
    tile once and nothing else: q' (64 rows) and K (BK rows) in TMA's
    swizzled panels over all d / 8 steps, V^T over all BK / 8 steps and
    both column halves; the split warps write every V^T position once."""
    _, qa, ka = _issue_s(np.zeros(64 * d), np.zeros(bk * d), bk, d)
    for addr, rows in ((qa, 64), (ka, bk)):
        assert np.array_equal(np.sort(addr.ravel()), np.arange(rows * d) * 4)
    vt, _, writes = _split_warps_vt(np.arange(bk * d, dtype=np.float64).reshape(bk, d), bk)
    assert not np.isnan(vt).any() and np.array_equal(np.sort(vt), np.arange(bk * d))
    assert sorted(writes) == sorted(set(writes)) and len(writes) == bk * d // 4 // 32 * 32
    seen = np.concatenate([_read_kmajor(vt, kk * 256, d, "il", lbo=128, sbo=32 * bk)[1]
                           for kk in range(bk // 8)], 1)
    assert np.array_equal(np.sort(seen.ravel()), np.arange(bk * d) * 4)


@pytest.mark.parametrize("d,bk", [(48, 64), (112, 32)])
def test_split_warps_touch_distinct_banks(d, bk):
    """A warp's 4 scalar reads of the raw V tile (rows of d f32) hit 32
    distinct banks at d = 48 and 112 (d = 16 mod 32); each 8 lanes of a
    warp's 16-byte writes fill one 128-byte core matrix (one wavefront)."""
    _, reads, writes = _split_warps_vt(np.zeros((bk, d)), bk)
    assert all(len(set(banks.tolist())) == 32 for banks in reads)
    for i in range(0, len(writes), 8):
        group = sorted(writes[i:i + 8])
        assert group[-1] - group[0] == 112 and group[0] % 128 == 0


# ----------------------------------------------------- against the JAX kernel ----
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("bh,lq,lk,d", JAX_SHAPES)
def test_forward_tf32_matches_jax_over_the_wgmma_tiles(monkeypatch, bh, lq, lk, d, dropout):
    """The kernel's arithmetic (``forward_tf32``, 3 passes) against JAX's
    f32 kernel in interpret mode, over several of the wgmma kernel's key
    tiles at d = 48 (64 keys) and d = 112 (32 keys): within 2e-5; one tf32
    pass misses."""
    assert -(-lk // fa.tf32_wgmma_key_tile(d)) >= 3
    rng = np.random.RandomState(d + lk)
    q, k, v = (rng.randn(bh, n, d).astype(np.float32) for n in (lq, lk, lk))
    scale = 1.0 / np.sqrt(d)
    want_out, want_lse = _jax_forward(monkeypatch, q, k, v, scale, dropout)
    keep = fa.dropout_multiplier(SEED, bh, lq, lk, dropout) if dropout > 0.0 else None
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = fa.forward_tf32(qt, kt, vt, scale, 3, keep)
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=RTOL)
    one_pass, _ = fa.forward_tf32(qt, kt, vt, scale, 1, keep)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(one_pass.numpy(), want_out, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["solo", "turns_all", "ring3", "keys32", "keys16",
                                  "pv_halves", "pv_halves_wide", "qsmem", "rows64"])
def test_bench_variants_apply_to_the_wgmma_source(name):
    """tools/bench_flash_fwd.py builds its f32 variants by text substitution
    in csrc/flash_fwd_tf32_wgmma.cuh: each still applies and changes the
    source; the key-tile variants change the key tile the Python rule
    mirrors."""
    from buctd_tpu_torch.tools import bench_flash_fwd as bench

    texts = bench.variant_sources(name, "tf32_wgmma")
    assert texts != bench.variant_sources("shipped", "tf32_wgmma")
    for header, old, new in bench.TF32_WGMMA_VARIANTS[name]:
        assert new in texts[header] and old in (CSRC / header).read_text()
    if name.startswith("keys"):
        width = "narrow" if name == "keys32" else "wide"
        tile = int(re.search(r"= (\d+);", bench.TF32_WGMMA_VARIANTS[name][0][2]).group(1))
        assert tile != fa.TF32_WGMMA_KEY_TILE[width]
