"""bf16 K1's two hand-written kernels: the dispatch between them, their key
tiles, and the rounding emulation at the wgmma kernel's tile widths against
the JAX kernel.

bf16 K1 and K1' run csrc/flash_fwd_wgmma.cuh (TMA loads, wgmma) where the
head dim is a multiple of 8 and q, k and v start 16-byte aligned, else
csrc/flash_fwd_tc.cuh (mma.sync).  ``takes_wgmma`` is that rule in Python,
for the launch counters; ``fwd_key_tile`` gives each kernel's key tile, which
the checks' ``forward_tile_rounded`` follows (p is rounded to bf16 relative to
the running row max after each key tile).  Both are held here to the
constants of the CUDA sources.

``forward_tile_rounded`` at the wgmma kernel's tiles against JAX's
``_fwd_kernel`` in interpret mode on the same bf16 operands (as
tests/test_torch_port_flash.py runs it): JAX rounds p relative to the running
max of its own key tiles (up to 1024 keys), so the two differ by one-bf16-step
flips where the running maxima differ, within K1_BF16_RTOL of max |out|
(chip_smoke.py's gate for the kernel against the plain forward; measured
1.08e-3 to 1.65e-3 of max here), and the emulation lies nearer JAX in
relative rms than its control, the same with p left unrounded (9.6e-4 to
1.41e-3 against 1.44e-3 to 1.56e-3).  The kernels themselves are held to the emulation on the
card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import functools
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
K1_BF16_RTOL = 4e-3   # chip_smoke.py's
# (BH, Lq, Lk, d): several key tiles of 128 at d = 48, 96 and 112, one of
# them ragged, and one JAX tiles in two (1100 keys > its 1024)
JAX_SHAPES = [(2, 200, 300, 48), (1, 130, 520, 96), (1, 150, 400, 112),
              (1, 70, 1100, 112), (2, 256, 256, 48)]


def _bf16(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)) \
        .to(torch.bfloat16)


def _source_constants():
    """The key tiles and rows of the two kernels as the .cuh sources state
    them."""
    wg = (CSRC / "flash_fwd_wgmma.cuh").read_text()
    tc = (CSRC / "flash_fwd_tc.cuh").read_text()
    narrow, wide_name = re.search(
        r"constexpr int key_tile\(\) \{ return D <= 64 \? (\d+) : (\w+); \}", wg).groups()
    wide = re.search(rf"constexpr int {wide_name} = (\d+);", wg).group(1)
    mma = re.search(r"constexpr int fwd_key_tile\(\) \{ return D <= 64 \? (\d+) : (\d+); \}",
                    tc).groups()
    consumers = re.search(r"constexpr int kConsumers = (\d+);", wg).group(1)
    rows = re.search(r"constexpr int kRows = (\d+) \* kConsumers;", wg).group(1)
    return {"wgmma": {"narrow": int(narrow), "wide": int(wide)},
            "mma": {"narrow": int(mma[0]), "wide": int(mma[1])},
            "rows": int(rows) * int(consumers)}


def test_key_tiles_match_the_cuda_sources():
    src = _source_constants()
    assert fa.WGMMA_KEY_TILE == src["wgmma"]
    assert fa.MMA_KEY_TILE == src["mma"]
    assert fa.WGMMA_ROWS == src["rows"]
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        width = "narrow" if -(-d // 16) * 16 <= 64 else "wide"
        assert fa.fwd_key_tile(d, wgmma=True) == src["wgmma"][width]
        assert fa.fwd_key_tile(d, wgmma=False) == src["mma"][width]
        # the default: the kernel that the dispatch picks for aligned operands
        assert fa.fwd_key_tile(d) == src["wgmma" if d % 8 == 0 else "mma"][width]


@pytest.mark.parametrize("d,want", [(48, True), (96, True), (112, True), (128, True),
                                    (8, True), (40, True), (6, False), (47, False),
                                    (100, False)])
def test_dispatch_by_head_dim(d, want):
    q = _bf16(2, 30, d)
    assert fa.takes_wgmma(q, q.clone(), q.clone()) is want
    assert fa.takes_wgmma(q.float(), q.float(), q.float()) is False


def _view(d, offset, dtype=torch.bfloat16):
    """A contiguous (1, 30, d) view that starts ``offset`` elements into its
    storage."""
    return _bf16(offset + 30 * d).to(dtype)[offset:].view(1, 30, d)


@pytest.mark.parametrize("d,offset,want", [(48, 0, True), (48, 48, True), (48, 8, True),
                                           (48, 4, False), (48, 1, False), (112, 56, True),
                                           (112, 60, False), (8, 8, True), (8, 2, False)])
def test_dispatch_by_base_alignment(d, offset, want):
    """TMA reads from 16-byte aligned bases: a bf16 view ``offset`` elements
    into its storage qualifies where offset is a multiple of 8 (with d a
    multiple of 8 every row start then is too), for any of q, k and v."""
    view, ok = _view(d, offset), _view(d, 0)
    assert view.data_ptr() % 16 == (offset * 2) % 16
    assert fa.takes_wgmma(view, ok, ok) is want
    assert fa.takes_wgmma(ok, view, ok) is want
    assert fa.takes_wgmma(ok, ok, view) is want


@pytest.mark.parametrize("dtype,d,offset,counted", [
    (torch.bfloat16, 48, 0, "wgmma"), (torch.bfloat16, 6, 0, "mma"),
    (torch.bfloat16, 48, 4, "mma"), (torch.float32, 48, 0, None)])
def test_launch_counters_follow_the_dispatch(dtype, d, offset, counted):
    """One launch on the wrapper, and on the counter of the bf16 kernel the
    rule picks (none for f32)."""
    wrapper = types.SimpleNamespace(launches=0, wgmma_launches=0, mma_launches=0)
    q, kv = _view(d, offset, dtype), _view(d, 0, dtype)
    fa._count(wrapper, q, kv, kv)
    assert wrapper.launches == 1
    assert wrapper.wgmma_launches == (counted == "wgmma")
    assert wrapper.mma_launches == (counted == "mma")


def test_cpu_calls_count_no_kernel():
    q = _bf16(1, 16, 48)
    before = [getattr(f, n) for f in (fa.flash_attention, fa.flash_attention_kvres)
              for n in ("launches", "wgmma_launches", "mma_launches")]
    fa.flash_attention(q, q, q, 0.2)
    after = [getattr(f, n) for f in (fa.flash_attention, fa.flash_attention_kvres)
             for n in ("launches", "wgmma_launches", "mma_launches")]
    assert before == after


def test_mma_wrapper_refuses_cpu_tensors():
    q = _bf16(1, 16, 48)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attention_mma(q, q, q, 0.2)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attention_mma(q.float(), q.float(), q.float(), 0.2)


@functools.lru_cache(maxsize=None)
def _jax_case(bh, lq, lk, d):
    """bf16 operands, the logits s of ``_logits``, and JAX's interpret-mode
    ``_fwd_kernel`` out on them."""
    from buctd_tpu.ops.flash_attention import _flash_fwd_impl

    q, k, v = _bf16(bh, lq, d, seed=0), _bf16(bh, lk, d, seed=1), _bf16(bh, lk, d, seed=2)
    scale = 1.0 / np.sqrt(d)
    out, _ = _flash_fwd_impl(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                               for x in (q, k, v)),
                             jnp.zeros((1,), jnp.int32), scale, 0.0, True)
    s, _ = fa._logits(q, k, scale)
    return s, v, torch.from_numpy(np.asarray(out))


@pytest.mark.parametrize("bh,lq,lk,d", JAX_SHAPES)
def test_tile_rounding_at_the_wgmma_tiles_against_jax(bh, lq, lk, d):
    """``forward_tile_rounded`` at the wgmma kernel's key tile for d (128 up
    to d = 64, its wide tile above) against JAX's bf16 kernel: within
    K1_BF16_RTOL of max |out|, and nearer JAX in relative rms than its
    control, which leaves p unrounded."""
    s, v, want = _jax_case(bh, lq, lk, d)
    bk = fa.fwd_key_tile(d)
    assert bk == fa.WGMMA_KEY_TILE["narrow" if d <= 64 else "wide"]
    tiled, control = fa.forward_tile_rounded(s, v, None, bk)
    top = want.abs().max().item()

    def rms(x):
        return ((x - want).square().sum() / want.square().sum()).sqrt().item()

    assert (tiled - want).abs().max().item() <= K1_BF16_RTOL * top
    assert rms(tiled) < rms(control), (rms(tiled), rms(control))


@pytest.mark.parametrize("bk", [128, 64, 32])
def test_tile_rounding_follows_the_tile_width(bk):
    """The rounding depends on the tile width, so the checks use the
    kernel's own: the default width at d = 48 is 128 keys, and 64 and 32
    round differently somewhere.  On one tile of lk <= bk keys, where the
    running max is the final one, the emulation is the plain forward up to
    one-bf16-step flips of a p where exp2 and exp differ (2^-8 x max |v|
    each, two allowed)."""
    s, v, _ = _jax_case(2, 200, 300, 48)
    tiled, _ = fa.forward_tile_rounded(s, v, None, bk)
    ref, _ = fa.forward_tile_rounded(s, v, None, 128)
    if bk == 128:
        assert torch.equal(tiled, ref)
    else:
        assert (tiled - ref).abs().max().item() > 0.0
    s1, v1 = s[..., :bk], v[:, :bk]
    one, _ = fa.forward_tile_rounded(s1, v1, None, bk)
    plain, _ = fa.forward_from_logits(s1, v1, None, True)
    assert (one - plain).abs().max().item() <= 2 * 2.0 ** -8 * v1.float().abs().max().item()


@pytest.mark.parametrize("name", ["solo", "ring3", "keys64", "keys128", "qregs", "qsmem_all"])
def test_bench_variants_apply_to_the_wgmma_source(name):
    """tools/bench_flash_fwd.py builds its bf16 variants by text substitution
    in csrc/flash_fwd_wgmma.cuh: each still applies and changes the source;
    the key-tile variants change the key tile the Python rule mirrors."""
    from buctd_tpu_torch.tools import bench_flash_fwd as bench

    texts = bench.variant_sources(name, "bfloat16")
    assert texts != bench.variant_sources("shipped", "bfloat16")
    for header, old, new in bench.BF16_VARIANTS[name]:
        assert new in texts[header] and old in (CSRC / header).read_text()
    assert (name in bench.SAME_BITS) == (name in ("solo", "ring3"))
