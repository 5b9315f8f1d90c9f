"""K5's f32 tensor-core kernel (csrc/fused_block_tf32.cuh, 3xTF32) on the CPU:
its arithmetic, its tile plans and its fragment addresses.

The CUDA kernel runs only on the card, where tests/test_torch_port_cuda.py
and chip_smoke.py hold it against the plain version.  Here:

* ``ops/fused_block.py::fused_block_tf32``, the emulation of the kernel's
  arithmetic (every operand split into hi = tf32(x) and lo = tf32(x - hi),
  each tap's product over an input chunk in three passes from zero and added
  to the running f32 sum, the f32 intermediate zero outside the image),
  against JAX's ``buctd_tpu.ops.pallas_block.fused_basic_block(...,
  interpret=True)`` in f32 at C = 16 and 48: within atol = rtol = 2e-5,
  chip_smoke.py's f32 K5 gate (measured at most 2.9e-6 here), while one tf32
  pass (``passes=1``, measured 1.4e-3 and 4.4e-3 away) misses it; and
  against ``fused_basic_block_plain`` up to C = 384 the same way (at most
  4.2e-6 against 1.1e-3 to 1.2e-3).
* ``TF32_PLANS`` against the ``using PlanN = Plan<...>;`` lines of the .cuh,
  and every plan's shared memory (``tf32_plan``) within an H100 block's
  232,448 bytes at C = 1, 16, 47, 48, 96, 192 and 384; row strides 4 times
  an odd number of words (the input tile, the intermediate) and 8 mod 32
  (the weight tile); the input chunks' double buffer never written while a
  stage still reads it, which the .cuh's ring bound keeps.
* A numpy model of the m16n8k8 tf32 fragments fed the kernel's addresses
  for every tap, lane, m16 tile and k8 step of every plan in both phases:
  the A fragments are the im2col rows of the lane's two pixels (rows g and
  g + 8, tap-shifted), the B fragments the tap's (C_in, C_out) weights; the
  weight reads hit 32 distinct banks, the A reads at most two addresses a
  bank (where a lane's 8 pixels wrap into the next tile row: 1.0 to 1.79
  times the conflict-free wavefronts;
  ``PYTHONPATH=.:tests python tests/test_torch_port_fused_block_tf32.py``
  prints them).
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch._build import CSRC
from buctd_tpu_torch.ops import fused_block as fb
from test_torch_port_fused_block_tc import (PLAN_KEYS, RESERVED, SM_SMEM, _operands,
                                            _overwrites, _tiles)

TOL = 2e-5
WIDTHS = [1, 16, 47, 48, 96, 192, 384]


def _source() -> str:
    return (CSRC / "fused_block_tf32.cuh").read_text()


def _plan(c: int, **changes) -> dict:
    """tf32_plan(c) with some of its choices changed, the derived numbers
    derived again."""
    base = fb.tf32_plan(c)
    if not changes:
        return base
    saved = fb.TF32_PLANS
    fb.TF32_PLANS = ({k: changes.get(k, base[k]) for k in PLAN_KEYS},)
    try:
        return fb.tf32_plan(c)
    finally:
        fb.TF32_PLANS = saved


# ------------------------------------------------------------ the arithmetic

@pytest.mark.parametrize("b,h,w,c", [(3, 12, 9, 16), (2, 10, 12, 48)])
def test_emulation_matches_pallas_kernel(b, h, w, c):
    from buctd_tpu.ops.pallas_block import fused_basic_block as jax_block

    ops = _operands(b, h, w, c)
    want = np.asarray(jax_block(*[jnp.asarray(a, jnp.float32) for a in ops], interpret=True))
    args = [torch.from_numpy(a.astype(np.float32)) for a in ops]
    np.testing.assert_allclose(fb.fused_block_tf32(*args).numpy(), want, atol=TOL, rtol=TOL)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(fb.fused_block_tf32(*args, passes=1).numpy(), want,
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,h,w,c", [(2, 13, 11, 40), (1, 24, 18, 192), (1, 12, 9, 384)])
def test_emulation_matches_plain_block(b, h, w, c):
    args = [torch.from_numpy(a.astype(np.float32))
            for a in _operands(b, h, w, c, seed=c, scale=1 / (3 * c ** 0.5))]
    want = fb.fused_basic_block_plain(*args)
    torch.testing.assert_close(fb.fused_block_tf32(*args), want, atol=TOL, rtol=TOL)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(fb.fused_block_tf32(*args, passes=1), want, atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("passes", [1, 3])
def test_emulation_takes_nan_as_plain(passes):
    """A NaN in x reaches the emulation's output where it reaches the plain
    version's, every channel of the 5x5 pixels around it (the split's lo
    carries it; the kernels' relu keeps it)."""
    args = [torch.from_numpy(a.astype(np.float32))
            for a in _operands(2, 9, 8, 16, seed=3, scale=1 / 12)]
    args[0][1, 4, 0, 7] = float("nan")
    want = ~torch.isfinite(fb.fused_basic_block_plain(*args))
    assert want.sum() == 5 * 3 * 16
    assert torch.equal(~torch.isfinite(fb.fused_block_tf32(*args, passes=passes)), want)


def test_emulation_refuses_other_pass_counts():
    x = torch.zeros(1, 2, 2, 4)
    w, b = torch.zeros(3, 3, 4, 4), torch.zeros(4)
    with pytest.raises(ValueError):
        fb.fused_block_tf32(x, w, w, b, b, passes=2)


# ----------------------------------------------------------------- the plans

def test_plans_match_the_kernel_source():
    src = _source()
    rows = re.findall(r"using Plan(\d+) = Plan<([^>]*)>;", src)
    plans = [dict(zip(PLAN_KEYS, (int(v) for v in args.split(",")))) for _, args in rows]
    assert [int(name) for name, _ in rows] == [p["cmax"] for p in plans]
    assert plans == [dict(p) for p in fb.TF32_PLANS]
    assert f"kMaxSmem = {fb.SMEM_LIMIT};" in src
    order = re.findall(r"if \(cp <= Plan(\d+)::CMax\)", src)
    assert [int(n) for n in order] == [p["cmax"] for p in fb.TF32_PLANS[:-1]]
    assert "static_assert(Stages <= 9 / Taps + 1" in src
    assert "int cpad(int C) { return (C + 7) / 8 * 8; }" in src


@pytest.mark.parametrize("c", WIDTHS + [8, 77, 100, 200, 300])
def test_plan_fits_the_card(c):
    p = fb.tf32_plan(c)
    assert p["cpad"] % 8 == 0 and c <= p["cpad"] < c + 8 and p["cpad"] <= p["cmax"]
    assert p["smem"] <= fb.SMEM_LIMIT
    assert p["blocks"] * (p["smem"] + RESERVED) <= SM_SMEM      # the blocks an SM holds
    assert p["blocks"] * p["threads"] <= 2048
    for stride in (p["sx"], p["sy"]):                           # 4 x odd words, 16-byte rows
        assert stride % 4 == 0 and (stride // 4) % 2 == 1
    assert p["sw"] % 32 == 8 and p["sw"] >= p["nc"]
    assert p["kc"] % 8 == 0 and p["nc"] % (8 * p["wn"]) == 0 and 9 % p["taps"] == 0
    assert p["nn"] * p["nc"] >= p["cpad"] and p["nx"] * p["kc"] >= p["cpad"]
    assert p["wm"] * p["mt"] * 16 >= max(p["p1"], p["p2"])


def test_plan_smem_at_c384_is_the_sum_of_its_parts():
    """C = 384 at 6x9 tiles: the intermediate 88 x 388 words, the ring 2 slots
    x 3 taps x 16 x 136, two 130-pixel input chunks of 20 and the two
    biases."""
    p = fb.tf32_plan(384)
    assert (p["p1"], p["sy"], p["sw"], p["px"], p["sx"]) == (88, 388, 136, 130, 20)
    assert p["smem"] == 4 * (88 * 388 + 2 * 3 * 16 * 136 + 2 * 130 * 20 + 2 * 384) == 212672


def test_plan_refuses_what_the_kernel_does_not_take():
    for c in (0, fb.TF32_PLANS[-1]["cmax"] + 1):
        with pytest.raises(ValueError):
            fb.tf32_plan(c)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("h,w", [(96, 72), (48, 36), (24, 18), (12, 9), (13, 11), (5, 7)])
def test_tiles_cover_the_image_once(h, w, c):
    p = fb.tf32_plan(c)
    seen = np.zeros((h, w), int)
    for ty0, tx0 in _tiles(h, w, p):
        for q in range(p["p2"]):
            gy, gx = ty0 + q // p["tw"], tx0 + q % p["tw"]
            if gy < h and gx < w:
                seen[gy, gx] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("c", [48, 96, 192, 384])
def test_input_chunks_are_never_overwritten_while_read(c):
    p = fb.tf32_plan(c)
    assert _overwrites(p) == []
    deepest = 9 // p["taps"] + 1                                # the .cuh's bound
    assert _overwrites(_plan(c, stages=deepest)) == []


# ------------------------------------------------------ the fragment addresses

def _lanes():
    t = np.arange(32)
    return t // 4, t % 4                               # gid, tig


def a_loads(p, phase):
    """Every A load of one k8 step of a plan's phase (1 or 2), at channel 0:
    {(m16 tile, tap): 4 arrays of 32 lane addresses (words), a0..a3}: a
    lane's rows g and g + 8 are two pixels, tap-shifted, of the input tile
    (phase 1) or the intermediate (phase 2)."""
    gid, tig = _lanes()
    tw, w1, wx = p["tw"], p["tw"] + 2, p["tw"] + 4
    ss, src_w = (p["sx"], wx) if phase == 1 else (p["sy"], w1)
    pixels, mtiles = (p["p1"], p["m1"]) if phase == 1 else (p["p2"], p["m2"])
    out = {}
    for mt in range(mtiles):
        bases = []
        for h in range(2):
            q = mt * 16 + gid + 8 * h
            q = np.where(q < pixels, q, 0)             # rows past the tile read pixel 0
            bases.append((q // w1) * wx + q % w1 if phase == 1 else (q // tw) * w1 + q % tw)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            r0, r1 = ((b + dy * src_w + dx) * ss + tig for b in bases)
            out[mt, tap] = (r0, r1, r0 + 4, r1 + 4)
    return out


def _wavefronts(addrs) -> int:
    """Shared-memory wavefronts of one 32-lane 32-bit load: the most distinct
    addresses in one bank (lanes at one address are one broadcast)."""
    distinct = set(int(a) for a in addrs)
    banks = [a % 32 for a in distinct]
    return max(banks.count(b) for b in set(banks))


def a_wavefronts(p, phase) -> float:
    """A loads' wavefronts of a phase over the conflict-free ideal (one)."""
    counts = [_wavefronts(a) for loads in a_loads(p, phase).values() for a in loads]
    return sum(counts) / len(counts)


@pytest.mark.parametrize("c", [48, 96, 192, 384])
def test_a_reads_conflict_at_most_two_ways(c):
    """A lane's 8 pixels g of a tile row hit distinct groups of 4 banks (rows
    4 x odd words apart); where they wrap into the next tile row, two may
    share one: never more."""
    p = fb.tf32_plan(c)
    for phase in (1, 2):
        assert max(_wavefronts(a) for loads in a_loads(p, phase).values() for a in loads) <= 2
        assert 1.0 <= a_wavefronts(p, phase) <= 2.0


@pytest.mark.parametrize("c", [48, 96, 192, 384])
@pytest.mark.parametrize("phase", [1, 2])
def test_fragments_give_the_tap_products(c, phase):
    """For every m16 tile and tap of the phase, and every k8 step and n8
    tile: the A fragment (m16n8k8 layout) at the kernel's addresses is the
    16 pixel rows of the im2col matrix that the accumulator rows stand for,
    and B (rows k0 + t, t + 4 of the weight tile at row stride SW, column g
    of the n8 tile) the tap's weights, read from 32 distinct banks."""
    p = fb.tf32_plan(c)
    rng = np.random.RandomState(c + phase)
    gid, tig = _lanes()
    kc, sw, nc = p["kc"], p["sw"], p["nc"]
    if phase == 1:
        rows, cols, ss, ci0 = p["px"], kc, p["sx"], 0
    else:
        rows, cols, ss, ci0 = p["p1"], p["cpad"], p["sy"], (p["nx"] - 1) * kc
    act = rng.randint(-8, 8, (rows, cols)).astype(np.float64)
    src = np.zeros(rows * ss)
    for r in range(rows):
        src[r * ss:r * ss + cols] = act[r]
    wts = rng.randint(-8, 8, (kc, nc)).astype(np.float64)     # one tap's slot
    slot = np.zeros(kc * sw)
    for r in range(kc):
        slot[r * sw:r * sw + nc] = wts[r]
    for (mt, tap), loads in a_loads(p, phase).items():
        pix = [(loads[h] - tig) // ss for h in range(2)]     # the lane's two pixels
        for k0 in range(0, min(kc, p["cpad"] - ci0), 8):
            a_regs = np.stack([src[a + ci0 + k0] for a in loads], 1)
            a = np.zeros((16, 8))
            for reg, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
                a[gid + dr, tig + dc] = a_regs[:, reg]
            want_a = np.concatenate([act[pix[0][::4], ci0 + k0:ci0 + k0 + 8],
                                     act[pix[1][::4], ci0 + k0:ci0 + k0 + 8]])
            np.testing.assert_array_equal(a, want_a)
            for n0 in range(0, nc, 8):
                b_addr = (k0 + tig) * sw + n0 + gid
                assert len({int(x) % 32 for x in b_addr}) == 32
                b = np.zeros((8, 8))
                b[tig, gid], b[tig + 4, gid] = slot[b_addr], slot[b_addr + 4 * sw]
                np.testing.assert_array_equal(b, wts[k0:k0 + 8, n0:n0 + 8])


@pytest.mark.parametrize("name", ["fold0", "cvtsplit", "nanfree", "p48_k16t3", "p96_8x12", "p192_n64",
                                  "p192_k32t1", "p384_k32t1", "ko_mma", "ko_mma1", "ko_split",
                                  "ko_copy", "ko_cm"])
def test_bench_variants_apply_to_the_kernel_source(name):
    """tools/bench_block_variants.py --dtype float32 builds its variants by
    text substitution in the kernel's headers: each applies and changes the
    source, and a variant of another header carries the kernel header with
    it (its quoted includes find the changed header beside it)."""
    from buctd_tpu_torch.tools import bench_block_variants as bv

    shipped = bv.variant_sources("shipped", "float32")
    texts = bv.variant_sources(name, "float32")
    assert "fused_block_tf32.cuh" in texts and texts != shipped
    if name == "cvtsplit":
        assert texts["mma_tf32.cuh"].count("asm(\"cvt.rna.tf32.f32") == 2


if __name__ == "__main__":
    # the A loads' shared-memory wavefronts over the conflict-free ideal
    for c in (48, 96, 192, 384):
        p = fb.tf32_plan(c)
        print(f"C {c} ({p['th']}x{p['tw']} tiles): A wavefronts / ideal, phase 1 "
              f"{a_wavefronts(p, 1):.3f}, phase 2 {a_wavefronts(p, 2):.3f}")
