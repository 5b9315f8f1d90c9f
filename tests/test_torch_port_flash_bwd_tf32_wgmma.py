"""f32 K2's TMA + wgmma kernels (csrc/flash_bwd_tf32_wgmma.cuh), on the CPU:
their dispatch, their plans, ring and shared memory, a model of their tf32
fragments and shared layouts, and their arithmetic against JAX's kernels.

The kernels run only on the card, where tests/test_torch_port_cuda.py and
chip_smoke.py hold them against the plain f32 backward.  Here:

* ``takes_wgmma_bwd_f32`` (the rule of csrc/flash_bwd_tf32_wgmma.cuh::takes:
  f32, d a multiple of 8 up to 128, q, k, v and do 16-byte aligned) by head
  dim and base alignment, and the launch counters that follow it (f32 calls
  counted on ``f32_wgmma_launches`` or ``f32_mma_launches``, bf16 calls on
  the bf16 pair; CPU calls count none);
* ``tf32_wgmma_bwd_plan`` and ``tf32_wgmma_bwd_stages`` against the
  constants, the plans and the shared-memory formula of the .cuh, every
  plan within SMEM_LIMIT;
* a numpy model of wgmma m64nNk8 on tf32 operands, fed from the bytes as
  TMA's 64-byte swizzle and the split warps lay them: s = q' K^T and g = do
  V^T (dq), s^T = K q'^T and g^T = V do^T (dk/dv) through 64-byte-swizzle
  descriptors, and the three products whose A is an accumulator (dq = ds K,
  dv = (p keep c)^T do, dk = ds^T q') against the transposed tiles the
  split warps write, in the permuted row order: each the exact product,
  while the unpermuted reuse is not; every element of each layout is read
  back from one address of its own, the split warps read every element of
  the swizzled tile once and write every transposed position once;
* ``backward_tf32`` over the wgmma kernels' looped tiles against JAX's
  ``_dq_kernel`` and ``_dkv_kernel`` in interpret mode at
  Precision.HIGHEST, at d = 48, 96 and 112, dropout 0 and 0.1, several
  looped tiles long, within atol = rtol = 1e-4 (one tf32 pass misses);
* the f32 wgmma variants of tools/bench_flash_bwd.py still apply to the
  source.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import re
import types

import numpy as np
import pytest
import torch

from buctd_tpu_torch._build import CSRC
from buctd_tpu_torch.ops import flash_attention as fa
from test_torch_port_flash_bwd_tf32 import ATOL, RTOL, _jax_backward
from test_torch_port_flash_tf32 import SEED
from test_torch_port_flash_tf32_wgmma import (_a_frag_rows_cols, _acc_rows_cols, _issue_s,
                                              _read_kmajor, _tma_sw64, _vt_offset)

SOURCE = CSRC / "flash_bwd_tf32_wgmma.cuh"
# (BH, Lq, Lk, d): at least three looped tiles of each kernel (dq: 32 keys
# at d = 48, 16 above; dk/dv: 32 q rows at d = 48, 16 above), ragged against
# them and against the own rows (64 a consumer warpgroup)
JAX_SHAPES = [(1, 70, 100, 48), (2, 50, 70, 96), (1, 40, 58, 112)]


def _f32(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _constants() -> dict:
    text = SOURCE.read_text()
    names = ("kDqSplitWarps", "kDkvSplitWarps", "kPanel", "kStages", "kKvresStages",
             "kSmemLimit", "kPlans")
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", text).group(1)) for n in names}


def _smem(dq, d, c, t, stages):
    """csrc/flash_bwd_tf32_wgmma.cuh::smem_for."""
    slot = 6 * t * d * 4 if dq else 8 * t * d * 4 + 3 * t * 4
    return 1024 + 4 * 64 * c * d * 4 + stages * slot + 8 * (c + 3 * stages)


def test_plans_and_ring_match_the_cuda_source():
    c = _constants()
    text = SOURCE.read_text()
    for line in (
            "__host__ __device__ constexpr int plan_consumers(int i) { return i == 0 ? 2 : 1; }",
            "__host__ __device__ constexpr int plan_tile(int i) { return i < 2 ? 32 : "
            "(i == 2 ? 16 : 8); }",
            "return 1024 + 4 * 64 * c * D * 4 + stages * (dq ? 6 * t * D * 4 : 8 * t * D * 4 "
            "+ 3 * t * 4) +",
            "8 * (c + 3 * stages);"):
        assert line in text, line
    plans = [(2 if i == 0 else 1, 32 if i < 2 else (16 if i == 2 else 8))
             for i in range(c["kPlans"])]
    assert list(fa.TF32_WGMMA_BWD_PLANS) == plans
    assert fa.TF32_WGMMA_BWD_STAGES == {"k2": c["kStages"], "k2_kvres": c["kKvresStages"]}
    assert fa.SMEM_LIMIT == c["kSmemLimit"]
    for d in range(8, fa.MAX_HEAD_DIM + 1, 8):
        dp = -(-d // 16) * 16
        for dq in (True, False):
            want = next((p for p in plans[:-1]
                         if _smem(dq, dp, *p, c["kStages"]) <= c["kSmemLimit"]), plans[-1])
            assert fa.tf32_wgmma_bwd_plan(d, dq) == want
            assert fa.tf32_wgmma_bwd_smem(d, dq, *want, 2) == _smem(dq, dp, *want, 2)
            assert _smem(dq, dp, *want, c["kStages"]) <= c["kSmemLimit"]
            assert fa.bwd_loop_tile(d, dq) == want[1]
            for kvres, ask in ((False, c["kStages"]), (True, c["kKvresStages"])):
                s = fa.tf32_wgmma_bwd_stages(d, dq, kvres)
                assert c["kStages"] <= s <= ask and _smem(dq, dp, *want, s) <= c["kSmemLimit"]
                assert s == ask or _smem(dq, dp, *want, s + 1) > c["kSmemLimit"]


@pytest.mark.parametrize("d", [48, 96, 112, 128])
def test_plans_fit_at_the_model_widths(d):
    """Every plan's shared memory at d = 48, 96, 112 and 128 within the
    block's 232,448 bytes for K2's slots and K2''s; the model paths' plans:
    dq (2, 32) at d = 48, (1, 16) at 96 and 112; dk/dv the same; K2' three
    slots for dq at 48 and 96, K2's two elsewhere."""
    for dq in (True, False):
        plan = fa.tf32_wgmma_bwd_plan(d, dq)
        for kvres in (False, True):
            stages = fa.tf32_wgmma_bwd_stages(d, dq, kvres)
            assert fa.tf32_wgmma_bwd_smem(d, dq, *plan, stages) <= fa.SMEM_LIMIT
    want = {48: ((2, 32), (2, 32), 3, 2), 96: ((1, 16), (1, 16), 3, 2),
            112: ((1, 16), (1, 16), 2, 2), 128: ((1, 16), (1, 8), 2, 3)}[d]
    assert (fa.tf32_wgmma_bwd_plan(d, True), fa.tf32_wgmma_bwd_plan(d, False),
            fa.tf32_wgmma_bwd_stages(d, True, True),
            fa.tf32_wgmma_bwd_stages(d, False, True)) == want


def test_loop_tile_follows_the_dispatch():
    """backward_tf32's fold follows the kernel the dispatch picks: the wgmma
    plans' tiles at d a multiple of 8, the mma.sync kernels' tiles at other d or
    when asked for."""
    for d in (8, 40, 48, 96, 112, 128):
        for dq in (True, False):
            assert fa.bwd_loop_tile(d, dq) == fa.tf32_wgmma_bwd_plan(d, dq)[1]
            assert fa.bwd_loop_tile(d, dq, wgmma=True) == fa.tf32_wgmma_bwd_plan(d, dq)[1]
            pad = -(-d // 16) * 16
            assert fa.bwd_loop_tile(d, dq, wgmma=False) == (64 if dq and pad <= 48 else 32)
    assert fa.bwd_loop_tile(47, True) == 64 and fa.bwd_loop_tile(47, False) == 32


@pytest.mark.parametrize("d,want", [(48, True), (96, True), (112, True), (128, True),
                                    (8, True), (40, True), (7, False), (47, False),
                                    (100, False), (136, False)])
def test_dispatch_by_head_dim(d, want):
    q = _f32(2, 30, d)
    assert fa.takes_wgmma_bwd_f32(q, q.clone(), q.clone(), q.clone()) is want
    # bf16 operands take the bf16 rule, and the bf16 rule no f32 operand
    low = q.to(torch.bfloat16)
    assert fa.takes_wgmma_bwd_f32(low, low, low, low) is False
    assert fa.takes_wgmma_bwd(q, q, q, q) is False


def _view(d, offset, dtype=torch.float32):
    """A contiguous (1, 30, d) view that starts ``offset`` elements into its
    storage."""
    return _f32(offset + 30 * d).to(dtype)[offset:].view(1, 30, d)


@pytest.mark.parametrize("d,offset,want", [(48, 0, True), (48, 48, True), (48, 4, True),
                                           (48, 2, False), (48, 1, False), (112, 56, True),
                                           (112, 58, False), (8, 4, True), (8, 6, False)])
def test_dispatch_by_base_alignment(d, offset, want):
    """TMA reads from 16-byte aligned bases: an f32 view ``offset`` elements
    into its storage qualifies where offset is a multiple of 4, for any of
    q, k, v and do."""
    view, ok = _view(d, offset), _view(d, 0)
    assert view.data_ptr() % 16 == (offset * 4) % 16
    for at in range(4):
        ops = [ok] * 4
        ops[at] = view
        assert fa.takes_wgmma_bwd_f32(*ops) is want


@pytest.mark.parametrize("dtype,d,offset,counted", [
    (torch.float32, 48, 0, "f32_wgmma"), (torch.float32, 112, 0, "f32_wgmma"),
    (torch.float32, 47, 0, "f32_mma"), (torch.float32, 48, 2, "f32_mma"),
    (torch.bfloat16, 48, 0, "wgmma"), (torch.bfloat16, 48, 4, "mma")])
@pytest.mark.parametrize("operand", ["q", "dout"])
def test_launch_counters_follow_the_dispatch(dtype, d, offset, counted, operand):
    """One launch on the wrapper and one on the counter of the kernel the
    rule picks, by dtype (an unaligned q or do sends the call to the
    mma.sync kernels); the A/B wrappers' calls count on the wrapper only."""
    kinds = ("wgmma", "mma", "f32_wgmma", "f32_mma")
    wrapper = types.SimpleNamespace(launches=0, **{f"{k}_launches": 0 for k in kinds})
    odd, ok = _view(d, offset, dtype), _view(d, 0, dtype)
    q, do = (odd, ok) if operand == "q" else (ok, odd)
    fa._count_bwd(wrapper, q, ok, ok, do, False)
    assert wrapper.launches == 1
    assert {k: getattr(wrapper, f"{k}_launches") for k in kinds} == \
        {k: int(k == counted) for k in kinds}
    fa._count_bwd(wrapper, q, ok, ok, do, True)
    assert wrapper.launches == 2 and sum(getattr(wrapper, f"{k}_launches") for k in kinds) == 1


def test_cpu_calls_count_no_kernel():
    q, k, v, dout = (_f32(1, 16, 48, seed=i) for i in range(4))
    names = ("launches", "wgmma_launches", "mma_launches", "f32_wgmma_launches",
             "f32_mma_launches")
    wrappers = (fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dq_kvres, fa.flash_bwd_dkv_kvres)
    before = [getattr(f, n) for f in wrappers for n in names]
    out, lse = fa.flash_attention(q, k, v, 0.2)
    fa.flash_attention_backward(q, k, v, out, lse, dout, 0.2, 0.1, 3)
    assert [getattr(f, n) for f in wrappers for n in names] == before


@pytest.mark.parametrize("fn", ["flash_bwd_dq_mma", "flash_bwd_dkv_mma"])
def test_mma_wrappers_take_f32_and_refuse_cpu_tensors(fn):
    """The mma.sync A/B wrappers take either dtype (no dtype refusal before
    the device check) and refuse CPU tensors."""
    q = _f32(1, 16, 48)
    lse = torch.zeros(1, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        getattr(fa, fn)(q, q, q, q, lse, lse, 0.2)


# --------------------------------------------- the wgmma fragment model ----
def _sw64_offset(r, c, rows):
    """csrc/flash_bwd_tf32_wgmma.cuh::sw64_offset: element (r, c) of a tile
    of ``rows`` rows in TMA's 64-byte-swizzled 16-column panels."""
    return (c // 16) * rows * 64 + r * 64 + (((c % 16) >> 2) ^ ((r >> 1) & 3)) * 16 + (c % 4) * 4


def _split_transpose(nat, rows, d, split_warps):
    """The split warps' split_transpose over a landed tile (``nat`` the TMA
    image, a flat f32 array): unit by unit as the kernel's loop walks them,
    each lane reads rows 8 a + vp + 2 e of column c at sw64_offset and
    writes them as positions 8 a + 4 vp + e of the transposed tile at
    vt_offset.  Returns the transposed image and the byte offsets read (one
    a read) and written (one a 16-byte write)."""
    img = np.full(rows * d, np.nan)
    lane = np.arange(32)
    vp, vc = (lane >> 3) & 1, 8 * (lane >> 4) + (lane & 7)
    reads, writes = [], []
    for sw in range(split_warps):
        for it in range(sw, (rows // 8) * (d // 16), split_warps):
            a, c = it // (d // 16), 16 * (it % (d // 16)) + vc
            off = _vt_offset(c, 2 * a + vp, rows)
            for e in range(4):
                at = _sw64_offset(8 * a + vp + 2 * e, c, rows)
                img[off // 4 + e] = nat[at // 4]
                reads.extend(at.tolist())
            writes.extend(off.tolist())
    return img, reads, writes


def _from_acc(acc, order, n, img, t):
    """An accumulator (64 x T, in its m64nT register layout ``acc``) reused
    as the A fragments of a product over its T columns (``order`` the
    registers' order in each k8 step) times the transposed tile ``img``
    through the kernel's descriptor (LBO 128, SBO 32 T, 256 bytes a k8
    step): the 64 x n product."""
    arow, acol = _a_frag_rows_cols()
    out = np.zeros((64, n))
    for kk in range(t // 8):
        a = np.zeros((64, 8))
        a[arow, acol] = acc[:, 4 * kk:4 * kk + 4][:, order]
        b, _ = _read_kmajor(img, kk * 256, n, "il", lbo=128, sbo=32 * t)
        out += a @ b.T
    return out


@pytest.mark.parametrize("d", [48, 96, 112, 128])
@pytest.mark.parametrize("dq", [True, False], ids=["dq", "dkv"])
def test_fragments_give_every_product_exactly(d, dq):
    """Both kernels' products from the bytes as TMA (64-byte swizzle) and the
    split warps lay them, through the kernel's descriptors: s (s^T) from the
    own rows (64 a warpgroup, split in place) and the looped tile (split in
    place), then the products whose A is an accumulator from the permuted
    registers and the transposed tile: each exact (integer values), the
    unpermuted reuse not.  dq: s = q' K^T, dq = ds K; dk/dv: s^T = K q'^T,
    dv = (p keep c)^T do, dk = ds^T q'."""
    text = SOURCE.read_text()
    for line in ("return (c / kPanel) * T * 64 + r * 64 + ((((c % kPanel) >> 2) ^ "
                 "((r >> 1) & 3)) << 4) +",
                 "const int off = sw64_offset<T>(8 * a + vp + 2 * e, c);",
                 "const int at = t3::vt_offset<T>(c, 2 * a + vp);",
                 "const int vp = (lane >> 3) & 1, vc = 8 * (lane >> 4) + (lane & 7);"):
        assert line in text, line
    t = fa.tf32_wgmma_bwd_plan(d, dq)[1]
    split_warps = _constants()["kDqSplitWarps" if dq else "kDkvSplitWarps"]
    rng = np.random.RandomState(d + dq)
    own = rng.randint(-8, 8, (64, d)).astype(np.float64)       # q' (dq) or K (dk/dv)
    looped = rng.randint(-8, 8, (t, d)).astype(np.float64)     # K (dq) or q' / do (dk/dv)
    nat = _tma_sw64(looped)
    # the swizzled offset the split warps compute is where TMA put the element
    r, c = np.meshgrid(np.arange(t), np.arange(d), indexing="ij")
    assert np.array_equal(nat[_sw64_offset(r, c, t) // 4], looped)
    s, _, _ = _issue_s(_tma_sw64(own), nat, t, d)
    np.testing.assert_array_equal(s, own @ looped.T)
    # a (64 x T) accumulator (ds, or p keep c and ds in (key, query) layout)
    # reused as A against the transposed looped tile: ds K, (p keep c)^T do,
    # ds^T q' all read it the same way
    x = rng.randint(-4, 4, (64, t)).astype(np.float64)
    row, col = _acc_rows_cols(t)
    img, _, _ = _split_transpose(nat, t, d, split_warps)
    np.testing.assert_array_equal(_from_acc(x[row, col], [0, 2, 1, 3], d, img, t),
                                  x @ looped)
    assert not np.array_equal(_from_acc(x[row, col], [0, 1, 2, 3], d, img, t),
                              x @ looped)


@pytest.mark.parametrize("d", [48, 96, 112, 128])
@pytest.mark.parametrize("dq", [True, False], ids=["dq", "dkv"])
def test_layouts_read_back_every_element_once(d, dq):
    """The split warps read every element of the landed swizzled tile once
    (and write its hi and lo there) and write every transposed position once;
    the descriptors read every element of the own rows, of the swizzled
    looped tile and of the transposed tile once, and nothing else."""
    t = fa.tf32_wgmma_bwd_plan(d, dq)[1]
    split_warps = _constants()["kDqSplitWarps" if dq else "kDkvSplitWarps"]
    img, reads, writes = _split_transpose(np.arange(t * d, dtype=np.float64), t, d, split_warps)
    assert sorted(reads) == list(range(0, t * d * 4, 4))
    assert not np.isnan(img).any() and np.array_equal(np.sort(img), np.arange(t * d))
    assert sorted(writes) == sorted(set(writes)) and len(writes) == t * d // 4
    _, qa, ka = _issue_s(np.zeros(64 * d), np.zeros(t * d), t, d)
    for addr, rows in ((qa, 64), (ka, t)):
        assert np.array_equal(np.sort(addr.ravel()), np.arange(rows * d) * 4)
    seen = np.concatenate([_read_kmajor(img, kk * 256, d, "il", lbo=128, sbo=32 * t)[1]
                           for kk in range(t // 8)], 1)
    assert np.array_equal(np.sort(seen.ravel()), np.arange(t * d) * 4)


@pytest.mark.parametrize("d", [48, 112])
def test_split_warps_touch_distinct_banks(d):
    """Each of a warp's 4 reads of the swizzled tile hits 32 distinct banks
    (two rows, 16 columns each, the swizzle a permutation within a row);
    each 8 lanes of its 16-byte transposed writes fill one 128-byte core
    matrix."""
    t = fa.tf32_wgmma_bwd_plan(d, False)[1]
    _, reads, writes = _split_transpose(np.zeros(t * d), t, d, 1)
    for i in range(0, len(reads), 32 * 4):
        unit = np.array(reads[i:i + 128]).reshape(4, 32)   # e, lane
        for e in range(4):
            assert len(set(((unit[e] // 4) % 32).tolist())) == 32
    for i in range(0, len(writes), 8):
        group = sorted(writes[i:i + 8])
        assert group[-1] - group[0] == 112 and group[0] % 128 == 0


# ----------------------------------------------------- against the JAX kernels ----
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("bh,lq,lk,d", JAX_SHAPES)
def test_backward_tf32_matches_jax_over_the_wgmma_tiles(monkeypatch, bh, lq, lk, d, dropout):
    """The kernels' arithmetic (``backward_tf32``, 3 passes, folded over the
    wgmma plans' looped tiles) against the VJP of JAX's f32 kernels in
    interpret mode at d = 48, 96 and 112, several looped tiles long, within
    1e-4; one tf32 pass misses in dq, dk and dv."""
    assert -(-lk // fa.bwd_loop_tile(d, True)) >= 3 and -(-lq // fa.bwd_loop_tile(d, False)) >= 3
    rng = np.random.RandomState(d + lq)
    q, k, v = (rng.randn(bh, n, d).astype(np.float32) for n in (lq, lk, lk))
    dout = rng.randn(bh, lq, d).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    want, lse, out = _jax_backward(monkeypatch, q, k, v, dout, scale, dropout)
    keep = fa.dropout_multiplier(SEED, bh, lq, lk, dropout) if dropout > 0.0 else None
    qt, kt, vt, dt = (torch.from_numpy(x) for x in (q, k, v, dout))
    lse_t = torch.from_numpy(lse)
    delta = (dt * torch.from_numpy(out)).sum(-1)
    got = fa.backward_tf32(qt, kt, vt, dt, lse_t, delta, scale, 3, keep, wgmma=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)
    one_pass = fa.backward_tf32(qt, kt, vt, dt, lse_t, delta, scale, 1, keep, wgmma=True)
    for g, w in zip(one_pass, want):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["overlap", "stale_desc", "split3", "dq_split8", "dkv_split4",
                                  "ring3"])
def test_bench_variants_apply_to_the_wgmma_source(name):
    """tools/bench_flash_bwd.py builds its f32 wgmma variants by text
    substitution in csrc/flash_bwd_tf32_wgmma.cuh: each still applies and
    changes the source."""
    from buctd_tpu_torch.tools import bench_flash_bwd as bench

    texts = bench.variant_sources(name, "float32")
    assert list(texts) == ["flash_bwd_tf32_wgmma.cuh"]
    assert texts["flash_bwd_tf32_wgmma.cuh"] != SOURCE.read_text()
    for old, new in bench.F32_WGMMA_VARIANTS[name]:
        assert old in SOURCE.read_text() and new in texts["flash_bwd_tf32_wgmma.cuh"]
