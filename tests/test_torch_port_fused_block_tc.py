"""K5's bf16 tensor-core kernel (csrc/fused_block_tc.cuh) on the CPU: its tile
plans, its fragment addresses and its schedule.

The CUDA kernel runs only on the card, where tests/test_torch_port_cuda.py
and chip_smoke.py hold it against the plain version.  Here:

* ``ops/fused_block.py::TC_PLANS`` against the plans of the ``.cuh`` (parsed
  from its ``using PlanN = Plan<...>;`` lines), and every plan's shared memory
  (``tc_plan``) within an H100 block's 232,448 bytes at C = 16, 40, 48, 96,
  192 and 384 and other widths; row strides an odd number of 16-byte units;
  the tiles cover images that no tile divides, each pixel once; the input
  chunks' double buffer is never written while a stage still reads it.
* A numpy model of ldmatrix (PTX ISA: lane t receives row t / 4, columns
  2 (t % 4) and 2 (t % 4) + 1 of each 8x8 matrix, or the transposed matrix
  with .trans) fed the kernel's row addresses for every tap, lane, m16 tile
  and k16 step of every plan, in both phases: the A fragments are the
  im2col rows of the lane's pixels (the input tile shifted by the tap), the
  B fragments the tap's (C_in, C_out) weights, in the m16n8k16 layouts; an
  accumulator row is stored at the pixel its A rows are centred on; the 8
  rows of every weight ldmatrix fall in distinct bank groups, those of an A
  ldmatrix at most two to one (where 8 pixels wrap into the next tile row:
  ``python tests/test_torch_port_fused_block_tc.py`` prints the wavefronts
  over the conflict-free ideal).
* A torch emulation of the kernel's schedule (tiles with halo recompute,
  channels padded to 16, output-channel and input-channel chunks, taps in
  the kernel's order with each tap's products added in f32, the
  intermediate zeroed outside the image and rounded to the operand dtype)
  against ``fused_basic_block_plain`` and against JAX's
  ``buctd_tpu.ops.pallas_block.fused_basic_block(..., interpret=True)`` at
  tests/test_pallas_block.py's shapes.  Tolerances as
  tests/test_torch_port_fused_block.py's: f32 atol 5e-5, rtol 1e-4 against
  JAX (two 3x3 convs summed in another order), 2e-5 against the plain
  version (chip_smoke.py's f32 K5 gate); bf16 one bf16 step (2^-7) at JAX's
  shapes, two (2^-6, chip_smoke.py's K5_ATOL) at C up to 384, where an f32
  sum in another order can round the intermediate and then the output one
  step apart.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch._build import CSRC
from buctd_tpu_torch.ops import fused_block as fb

PLAN_KEYS = ("cmax", "th", "tw", "kc", "nc", "wm", "wn", "stages", "taps", "blocks")
WIDTHS = [16, 40, 48, 96, 192, 384]
SM_SMEM = 233472          # bytes of shared memory an H100 SM holds for blocks
RESERVED = 1024           # bytes the card reserves for each block


def _source() -> str:
    return (CSRC / "fused_block_tc.cuh").read_text()


def _cuh_plans() -> list:
    rows = re.findall(r"using Plan(\d+) = Plan<([^>]*)>;", _source())
    plans = [dict(zip(PLAN_KEYS, (int(v) for v in args.split(",")))) for _, args in rows]
    assert [int(name) for name, _ in rows] == [p["cmax"] for p in plans]
    return plans


def _plan(c: int, **changes) -> dict:
    """tc_plan(c) with some of its choices changed, the derived numbers
    derived again (for schedules the shipped plans do not reach at small C)."""
    base = fb.tc_plan(c)
    if not changes:
        return base
    saved = fb.TC_PLANS
    fb.TC_PLANS = ({k: changes.get(k, base[k]) for k in PLAN_KEYS},)
    try:
        return fb.tc_plan(c)
    finally:
        fb.TC_PLANS = saved


# ---------------------------------------------------------------- (i) the plans

def test_plans_match_the_kernel_source():
    src = _source()
    assert _cuh_plans() == [dict(p) for p in fb.TC_PLANS]
    assert f"kMaxSmem = {fb.SMEM_LIMIT};" in src
    # run() takes the first plan whose CMax holds C_pad, in ascending order
    order = re.findall(r"if \(cp <= Plan(\d+)::CMax\)", src)
    assert [int(n) for n in order] == [p["cmax"] for p in fb.TC_PLANS[:-1]]
    assert [p["cmax"] for p in fb.TC_PLANS] == sorted(p["cmax"] for p in fb.TC_PLANS)


@pytest.mark.parametrize("c", WIDTHS + [1, 8, 77, 100, 200, 300])
def test_plan_fits_the_card(c):
    p = fb.tc_plan(c)
    assert p["cpad"] % 16 == 0 and c <= p["cpad"] < c + 16 and p["cpad"] <= p["cmax"]
    assert p["smem"] <= fb.SMEM_LIMIT
    assert p["blocks"] * (p["smem"] + RESERVED) <= SM_SMEM      # the blocks an SM holds
    assert p["blocks"] * p["threads"] <= 2048
    for stride in (p["sx"], p["sy"], p["sw"]):                  # odd 16-byte units
        assert stride * 2 % 16 == 0 and stride * 2 // 16 % 2 == 1
    assert p["kc"] % 16 == 0 and p["nt"] % 2 == 0 and 9 % p["taps"] == 0
    assert p["nn"] * p["nc"] >= p["cpad"] and p["nx"] * p["kc"] >= p["cpad"]
    assert p["wm"] * p["mt"] * 16 >= max(p["p1"], p["p2"])      # every row tile a warp


def test_plan_refuses_what_the_kernel_does_not_take():
    for c in (0, fb.TC_PLANS[-1]["cmax"] + 1):
        with pytest.raises(ValueError):
            fb.tc_plan(c)


def _tiles(h, w, p):
    """The output tiles of one image, in blockIdx.x order: (ty0, tx0)."""
    tiles_w, tiles_h = -(-w // p["tw"]), -(-h // p["th"])
    return [((b // tiles_w) * p["th"], (b % tiles_w) * p["tw"])
            for b in range(tiles_w * tiles_h)]


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("h,w", [(96, 72), (48, 36), (24, 18), (12, 9), (13, 11), (17, 23),
                                 (5, 7), (1, 1)])
def test_tiles_cover_the_image_once(h, w, c):
    p = fb.tc_plan(c)
    seen = np.zeros((h, w), int)
    for ty0, tx0 in _tiles(h, w, p):
        for q in range(p["p2"]):                    # the epilogue's pixels
            gy, gx = ty0 + q // p["tw"], tx0 + q % p["tw"]
            if gy < h and gx < w:
                seen[gy, gx] += 1
    assert (seen == 1).all()


def _stages(p):
    """The kernel's sequence of stages: (phase, n, ci, tap group)."""
    groups = 9 // p["taps"]
    return [(phase, n, ci, g) for phase in (0, 1) for n in range(p["nn"])
            for ci in range(p["nx"]) for g in range(groups)]


def _overwrites(p) -> list:
    """The stages computing while a copy of an input chunk lands in the
    buffer they read.  The copy of a stage is issued Stages - 1 stages ahead;
    the chunk a tap-group-0 stage of phase 1 brings goes to buffer
    (n nx + ci) & 1 (buffer 0, once, when one chunk holds C_pad)."""
    seq, st = _stages(p), p["stages"]

    def buffer(n, ci):
        return (n * p["nx"] + ci) & 1 if p["nx"] > 1 else 0

    bad, loads = [], 0
    for s2, (phase, n, ci, g) in enumerate(seq):
        if phase or g or (p["nx"] == 1 and n):
            continue
        loads += 1
        for s in range(max(0, s2 - st + 1), s2):             # computing while it lands
            ph, n1, ci1, _ = seq[s]
            if ph == 0 and buffer(n1, ci1) == buffer(n, ci):
                bad.append((s, s2))
    assert loads == (p["nn"] * p["nx"] if p["nx"] > 1 else 1)
    return bad


@pytest.mark.parametrize("c,changes", [(c, {}) for c in WIDTHS] + [
    (40, {"kc": 16, "nc": 16}), (384, {"stages": 3}), (192, {"taps": 9, "stages": 2})])
def test_input_chunks_are_never_overwritten_while_read(c, changes):
    assert _overwrites(_plan(c, **changes)) == []


@pytest.mark.parametrize("taps", [1, 3, 9])
def test_ring_depth_bound_is_the_kernels(taps):
    """The .cuh's static_assert Stages <= 9 / Taps + 1 is exactly the depth at
    which the input chunks' double buffer stays safe (C = 384: 6 chunks)."""
    assert "static_assert(Stages <= 9 / Taps + 1" in _source()
    deepest = 9 // taps + 1
    assert _overwrites(_plan(384, taps=taps, stages=deepest)) == []
    assert _overwrites(_plan(384, taps=taps, stages=deepest + 1)) != []


# ---------------------------------------------------- (ii) the fragment addresses

def _lanes():
    t = np.arange(32)
    return t // 4, t % 4                               # gid, tig


def _ldsm(mem, addrs, trans=False):
    """ldmatrix.x4 on the flat shared array ``mem`` (elements): lanes
    8q .. 8q + 7 give the row addresses of matrix q; lane t receives row
    t / 4, columns 2 (t % 4), +1 of each matrix (of its transpose with
    .trans).  Returns (32, 4, 2)."""
    out = np.empty((32, 4, 2), mem.dtype)
    for q in range(4):
        m = np.stack([mem[a:a + 8] for a in addrs[8 * q:8 * q + 8]])
        if trans:
            m = m.T
        for t in range(32):
            out[t, q] = m[t // 4, 2 * (t % 4):2 * (t % 4) + 2]
    return out


def _a_layout(a):
    """The m16k16 A matrix from a lane's fragments a0..a3 (PTX ISA)."""
    gid, tig = _lanes()
    m = np.full((16, 16), np.nan)
    for t in range(32):
        for q, (r, c) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
            m[gid[t] + r, c + 2 * tig[t]:c + 2 * tig[t] + 2] = a[t, q]
    return m


def _b_layout(b0, b1):
    """The k16n8 B matrix from a lane's b0, b1 (PTX ISA)."""
    gid, tig = _lanes()
    m = np.full((16, 8), np.nan)
    for t in range(32):
        m[2 * tig[t]:2 * tig[t] + 2, gid[t]] = b0[t]
        m[8 + 2 * tig[t]:8 + 2 * tig[t] + 2, gid[t]] = b1[t]
    return m


def _conflicts(addrs) -> list:
    """For each 8x8 matrix of one ldmatrix: the most distinct 16-byte units
    its 8 row addresses put in one bank group (1: conflict-free; rows at one
    address are one broadcast)."""
    out = []
    for q in range(4):
        units = {a * 2 // 16 for a in addrs[8 * q:8 * q + 8]}
        groups = [u % 8 for u in units]
        out.append(max(groups.count(g) for g in groups))
    return out


def a_row_addresses(p, phase):
    """Every A ldmatrix of one k16 step of a plan's phase (1 or 2), at
    channel 0: {(m16 tile, tap): 32 lane row addresses}, in elements."""
    lane = np.arange(32)
    tw, w1, wx = p["tw"], p["tw"] + 2, p["tw"] + 4
    ss, src_w = (p["sx"], wx) if phase == 1 else (p["sy"], w1)
    pixels, mtiles = (p["p1"], p["m1"]) if phase == 1 else (p["p2"], p["m2"])
    out = {}
    for mt in range(mtiles):
        q = mt * 16 + (lane & 15)
        q = np.where(q < pixels, q, 0)                 # rows past the tile read pixel 0
        base = (q // w1) * wx + q % w1 if phase == 1 else (q // tw) * w1 + q % tw
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            out[mt, tap] = (base + dy * src_w + dx) * ss + (lane >> 4) * 8
    return out


def a_wavefronts(p, phase) -> float:
    """Shared-memory wavefronts of the A ldmatrix of a phase over the
    conflict-free ideal (one a matrix)."""
    degrees = [d for addrs in a_row_addresses(p, phase).values() for d in _conflicts(addrs)]
    return sum(degrees) / len(degrees)


@pytest.mark.parametrize("c", WIDTHS)
def test_a_reads_conflict_at_most_two_ways(c):
    """8 consecutive pixels of a row hit distinct bank groups (odd row strides
    in 16-byte units); where the 8 wrap into the next tile row, two of them
    may share one: never more."""
    p = fb.tc_plan(c)
    for phase in (1, 2):
        assert max(max(_conflicts(a)) for a in a_row_addresses(p, phase).values()) <= 2
        assert 1.0 <= a_wavefronts(p, phase) <= 2.0


@pytest.mark.parametrize("c", [48, 96, 192, 384])
@pytest.mark.parametrize("phase", [1, 2])
def test_fragments_are_the_im2col_rows(c, phase):
    p = fb.tc_plan(c)
    rng = np.random.RandomState(c + phase)
    kc, sw = p["kc"], p["sw"]
    lane = np.arange(32)
    # the A source, distinct values: one input chunk (stride sx) in phase 1,
    # ys (every channel, stride sy) from the last chunk's channel ci0 in phase 2
    if phase == 1:
        rows, cols, ss, ci0 = p["px"], kc, p["sx"], 0
    else:
        rows, cols, ss, ci0 = p["p1"], p["cpad"], p["sy"], (p["nx"] - 1) * kc
    act = rng.randn(rows, cols)
    src = np.zeros(rows * ss)
    for r in range(rows):
        src[r * ss:r * ss + cols] = act[r]
    wts = rng.randn(9, kc, p["nc"])                    # a ring slot of each tap
    slots = np.zeros((9, kc * sw))
    for tap in range(9):
        for r in range(kc):
            slots[tap, r * sw:r * sw + p["nc"]] = wts[tap, r]
    for (mt, tap), addrs in a_row_addresses(p, phase).items():
        pix = (addrs - (lane >> 4) * 8) // ss          # the lane's pixel, tap-shifted
        for k0 in range(0, min(kc, p["cpad"] - ci0), 16):
            np.testing.assert_array_equal(_a_layout(_ldsm(src, addrs + ci0 + k0)),
                                          act[pix[:16], ci0 + k0:ci0 + k0 + 16])
            for n0 in range(0, p["nc"], 16):           # every warp's ldsm_t pairs
                # b_kn: rows (l & 7) + ((l >> 3) & 1) 8, column (l >> 4) 8
                b_addr = ((lane & 7) + ((lane >> 3) & 1) * 8 + k0) * sw + (lane >> 4) * 8 + n0
                b = _ldsm(slots[tap], b_addr, trans=True)
                for h in range(2):
                    np.testing.assert_array_equal(
                        _b_layout(b[:, 2 * h], b[:, 2 * h + 1]),
                        wts[tap, k0:k0 + 16, n0 + 8 * h:n0 + 8 * h + 8])
                assert _conflicts(b_addr) == [1, 1, 1, 1]


@pytest.mark.parametrize("c", WIDTHS)
def test_epilogue_stores_the_rows_it_computed(c):
    """An accumulator row (pixel p of the m16 tiles) is computed from the A
    rows centred (tap (1, 1)) on one pixel of the image, and the epilogue
    stores it at that pixel: in phase 1 at ys row p, image pixel
    (ty0 - 1 + p / (TW+2), tx0 - 1 + p % (TW+2)); in phase 2 at image pixel
    (ty0 + p / TW, tx0 + p % TW)."""
    p = fb.tc_plan(c)
    tw, w1, wx = p["tw"], p["tw"] + 2, p["tw"] + 4
    for q in range(p["p1"]):                           # input tile from (ty0 - 2, tx0 - 2)
        centre = (q // w1) * wx + q % w1 + wx + 1
        assert (centre // wx - 2, centre % wx - 2) == (q // w1 - 1, q % w1 - 1)
    for q in range(p["p2"]):                           # ys from (ty0 - 1, tx0 - 1)
        centre = (q // tw) * w1 + q % tw + w1 + 1
        assert (centre // w1 - 1, centre % w1 - 1) == (q // tw, q % tw)


# -------------------------------------------------------- (iii) the schedule

def emulate(x, w1, w2, b1, b2, plan=None):
    """The tensor-core kernel's schedule in torch: per TH x TW tile, conv1 on
    the tile and its 1-pixel halo from the (TH+4) x (TW+4) input tile, for
    each output-channel chunk, input-channel chunk and tap in the kernel's
    order, each tap's product (f32, from the operands' values) added to the
    running f32 sum; + b1, relu, 0 outside the image, rounded to x's dtype;
    conv2 the same way from there; ((acc + b2) + x), relu, x's dtype."""
    B, H, W, C = x.shape
    p = plan or fb.tc_plan(C)
    th, tw, kc, nc = p["th"], p["tw"], p["kc"], p["nc"]
    kpad, npad = p["nx"] * kc, p["nn"] * nc            # the chunks' padded extents
    dtype = x.dtype

    def pad(t, *shape):
        out = torch.zeros(*shape)
        out[tuple(slice(0, s) for s in t.shape)] = t.float()
        return out

    wk = [pad(w.reshape(9, C, C), 9, kpad, npad) for w in (w1, w2)]
    bias = [pad(b, npad) for b in (b1, b2)]
    xpad = pad(x, B, H + th + 4, W + tw + 4, kpad).roll((2, 2), (1, 2))   # 2 px of zeros
    out = torch.empty_like(x)

    def conv(src, w, rows, cols):
        """sum over (n, ci, tap) in the kernel's order of src's tap-shifted
        (rows x cols) window, channels ci.., times w[tap][ci.., n..]"""
        acc = torch.zeros(B, rows, cols, npad)
        for n in range(p["nn"]):
            for ci in range(p["nx"]):
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    a = src[:, dy:dy + rows, dx:dx + cols, ci * kc:(ci + 1) * kc]
                    acc[..., n * nc:(n + 1) * nc] += (
                        a @ w[tap, ci * kc:(ci + 1) * kc, n * nc:(n + 1) * nc])
        return acc

    for ty0, tx0 in _tiles(H, W, p):
        xt = xpad[:, ty0:ty0 + th + 4, tx0:tx0 + tw + 4]        # from (ty0 - 2, tx0 - 2)
        y = torch.relu(conv(xt, wk[0], th + 2, tw + 2) + bias[0])
        gy = torch.arange(ty0 - 1, ty0 + th + 1)[:, None]
        gx = torch.arange(tx0 - 1, tx0 + tw + 1)[None, :]
        inside = ((gy >= 0) & (gy < H) & (gx >= 0) & (gx < W))[None, :, :, None]
        y = torch.where(inside, y, 0.0).to(dtype).float()
        ys = pad(y[..., :p["cpad"]], B, th + 2, tw + 2, kpad)  # ys holds C_pad channels
        z = conv(ys, wk[1], th, tw)[..., :C] + bias[1][:C] + xt[:, 2:th + 2, 2:tw + 2, :C]
        hh, ww = min(th, H - ty0), min(tw, W - tx0)
        out[:, ty0:ty0 + hh, tx0:tx0 + ww] = torch.relu(z[:, :hh, :ww]).to(dtype)
    return out


def _operands(b, h, w, c, seed=0, scale=0.1):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, w, c), rng.randn(3, 3, c, c) * scale,
            rng.randn(3, 3, c, c) * scale, rng.randn(c) * 0.1, rng.randn(c) * 0.1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c", [(3, 12, 9, 16), (4, 8, 8, 8), (2, 6, 16, 4)])
def test_schedule_matches_pallas_kernel(b, h, w, c, dtype):
    """At tests/test_pallas_block.py's shapes: the emulated schedule against
    JAX's Pallas kernel in interpret mode."""
    from buctd_tpu.ops.pallas_block import fused_basic_block as jax_block

    ops = _operands(b, h, w, c)
    want = np.asarray(jax_block(*[jnp.asarray(a, getattr(jnp, dtype)) for a in ops],
                                interpret=True).astype(jnp.float32))
    got = emulate(*[torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
                    for a in ops])
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -7, rtol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c,changes", [
    (2, 13, 11, 40, {}),                       # ragged tiles, C_pad 48
    (1, 17, 23, 77, {}),                       # C_pad 80: two output-channel chunks
    (1, 12, 9, 384, {}),                       # the W48 branch-3 width: 6 x 3 chunks
    (2, 24, 18, 192, {}),                      # branch 2: 3 x 2 chunks, three taps a stage
    (2, 7, 10, 40, {"th": 3, "tw": 4, "kc": 16, "nc": 16}),   # many chunks and tiles
])
def test_schedule_matches_plain_block(b, h, w, c, changes, dtype):
    tdtype = getattr(torch, dtype)
    ops = [torch.from_numpy(a.astype(np.float32)).to(tdtype)
           for a in _operands(b, h, w, c, seed=c, scale=1 / (3 * c ** 0.5))]
    got = emulate(*ops, plan=_plan(c, **changes))
    want = fb.fused_basic_block_plain(*ops)
    tol = 2e-5 if dtype == "float32" else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_schedule_control_without_the_halo_zeros_misses():
    """The emulation with the intermediate left at relu(b1) outside the image
    (not point (d) of the contract) lands far from the plain version, so the
    tests above tell the zeros from their absence."""
    ops = [torch.from_numpy(a.astype(np.float32))
           for a in _operands(2, 6, 5, 16, seed=1, scale=0.2)]
    ops[3] = ops[3].abs() + 0.5                               # relu(b1) > 0
    want = fb.fused_basic_block_plain(*ops)
    assert torch.allclose(emulate(*ops), want, atol=2e-5, rtol=2e-5)
    saved = torch.where
    torch.where = lambda cond, a, b: a                        # no zeros outside the image
    try:
        bad = emulate(*ops)
    finally:
        torch.where = saved
    assert (bad - want).abs().max() > 0.1


if __name__ == "__main__":
    # the A reads' shared-memory wavefronts over the conflict-free ideal
    for c in (48, 96, 192, 384):
        p = fb.tc_plan(c)
        print(f"C {c} ({p['th']}x{p['tw']} tiles): A wavefronts / ideal, phase 1 "
              f"{a_wavefronts(p, 1):.3f}, phase 2 {a_wavefronts(p, 2):.3f}")
