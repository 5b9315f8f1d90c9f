"""bf16 K2's two pairs of hand-written kernels: the dispatch between them,
their launch counters, the looped tiles of the wgmma kernels, and the plain
bf16 backward that the card's checks hold both to, against JAX's VJP.

bf16 K2 and K2' run csrc/flash_bwd_wgmma.cuh (TMA loads, wgmma) where the
head dim is a multiple of 8 and q, k, v and the cast do start 16-byte
aligned, else csrc/flash_bwd_tc.cuh (mma.sync).  ``takes_wgmma_bwd`` is that
rule in Python, for the launch counters (``wgmma_launches``,
``mma_launches`` on flash_bwd_dq, flash_bwd_dkv and their K2' twins);
``flash_bwd_dq_mma`` and ``flash_bwd_dkv_mma`` launch the mma.sync kernels at
any shape for the A/B and refuse CPU tensors.  The tiles of the wgmma kernels
(``WGMMA_BWD_ROWS``, ``wgmma_bwd_tiles``) are held to the CUDA source, and
the benchmark's variants of it (tools/bench_flash_bwd.py) to its text.

``flash_attention_backward_reference`` (what CPU tensors run, and what the
card holds the kernels to within K2_BF16_RTOL x max |grad|) against the VJP
of JAX's flash attention run as the JAX tests run it (interpret mode, bf16
operands at Precision.DEFAULT), from JAX's own forward (lse, out), at d = 48,
96 and 112 and a ragged L of 1100 (two of JAX's 768-row backward blocks),
dropout 0 and 0.1.  At dropout 0.1 JAX's kernels draw the port's hash mask in
place of the TPU PRNG (a stand-in for ``_dropout_keep`` that reads the global
row and column from the grid, as test_torch_port_flash_tf32.py's does; here
also in the dk/dv kernel, whose grid walks keys before q rows), so the masks
agree element for element.  do is bf16-representable, so JAX's f32 do and the
port's bf16 do are the same values.  JAX's program is compiled with XLA's
``xla_allow_excess_precision`` off: left on, XLA's CPU compiler drops the
bf16 rounding of q' in the dk product (dk then lay 1.3e-3 to 1.6e-3 of max
from the port's; with it off 2e-5).  JAX returns bf16 gradients (its final
``.astype``): each of the port's f32 gradients must lie within K2_BF16_RTOL x
max |grad| of the interval of f32 values that round to JAX's bf16 value
(measured: dq and dk below 7e-5).  dv also gets the rounding of p * keep * c
that JAX's interpret mode leaves out (its do is f32, and the CPU takes an f32
operand of a Precision.DEFAULT product unrounded, where the TPU's single MXU
pass and the port round it to bf16): |(bf16(p keep c) - p keep c)^T do|, what
that rounding moves dv by (dv measured within 2.9e-3 of max without it).
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
K2_BF16_RTOL = 2e-3   # chip_smoke.py's
# JAX's programs keep every bf16 rounding they state (the module docstring)
XLA_OPTIONS = {"xla_allow_excess_precision": False}
SEED = 4321
# (BH, L, d): the head dims of the bf16 training paths, L ragged against the
# kernels' tiles and JAX's 768-row backward blocks
JAX_SHAPES = [(2, 200, 48), (1, 1100, 48), (1, 300, 96), (1, 1100, 112)]
K2_WRAPPERS = ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_kvres", "flash_bwd_dkv_kvres")


def _bf16(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)) \
        .to(torch.bfloat16)


def _view(d, offset, dtype=torch.bfloat16):
    """A contiguous (1, 30, d) view that starts ``offset`` elements into its
    storage."""
    return _bf16(offset + 30 * d).to(dtype)[offset:].view(1, 30, d)


@pytest.mark.parametrize("d,want", [(48, True), (96, True), (112, True), (128, True),
                                    (8, True), (40, True), (6, False), (47, False),
                                    (100, False)])
def test_bwd_dispatch_by_head_dim(d, want):
    q = _bf16(2, 30, d)
    assert fa.takes_wgmma_bwd(q, q.clone(), q.clone(), q.clone()) is want
    f = q.float()
    assert fa.takes_wgmma_bwd(f, f, f, f) is False


@pytest.mark.parametrize("d,offset,want", [(48, 0, True), (48, 8, True), (48, 4, False),
                                           (112, 56, True), (112, 60, False), (8, 2, False)])
@pytest.mark.parametrize("which", range(4), ids=["q", "k", "v", "do"])
def test_bwd_dispatch_by_base_alignment(d, offset, want, which):
    """TMA reads from 16-byte aligned bases: a bf16 view ``offset`` elements
    into its storage qualifies where offset is a multiple of 8, for any of q,
    k, v and the cast do."""
    ops = [_view(d, 0) for _ in range(4)]
    ops[which] = _view(d, offset)
    assert ops[which].data_ptr() % 16 == (offset * 2) % 16
    assert fa.takes_wgmma_bwd(*ops) is want


@pytest.mark.parametrize("dtype,d,offset,mma,counted", [
    (torch.bfloat16, 48, 0, False, "wgmma"), (torch.bfloat16, 112, 0, False, "wgmma"),
    (torch.bfloat16, 47, 0, False, "mma"), (torch.bfloat16, 48, 4, False, "mma"),
    (torch.bfloat16, 48, 0, True, None), (torch.float32, 48, 0, False, None)])
def test_bwd_launch_counters_follow_the_dispatch(dtype, d, offset, mma, counted):
    """One launch on the wrapper, and on the counter of the bf16 kernel the
    rule picks; none for f32 or the mma.sync A/B wrappers (``mma``)."""
    wrapper = types.SimpleNamespace(launches=0, wgmma_launches=0, mma_launches=0)
    q, kv = _view(d, offset, dtype), _view(d, 0, dtype)
    fa._count_bwd(wrapper, q, kv, kv, kv, mma)
    assert wrapper.launches == 1
    assert wrapper.wgmma_launches == (counted == "wgmma")
    assert wrapper.mma_launches == (counted == "mma")


def _counts():
    return [getattr(getattr(fa, name), c) for name in K2_WRAPPERS
            for c in ("launches", "wgmma_launches", "mma_launches")] + \
        [fa.flash_bwd_dq_mma.launches, fa.flash_bwd_dkv_mma.launches]


@pytest.mark.parametrize("kvres", ["0", "1"])
def test_cpu_backward_calls_count_no_kernel(monkeypatch, kvres):
    monkeypatch.setenv(fa.KVRES_ENV, kvres)
    q, k, v = (x.requires_grad_() for x in (_bf16(1, 20, 48), _bf16(1, 24, 48, seed=1),
                                            _bf16(1, 24, 48, seed=2)))
    before = _counts()
    fa.flash_attention_train(q, k, v, 0.2, 0.1, 3).sum().backward()
    assert _counts() == before
    assert all(x.grad is not None and torch.isfinite(x.grad.float()).all() for x in (q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", ["flash_bwd_dq_mma", "flash_bwd_dkv_mma"])
def test_mma_wrappers_refuse_cpu_tensors(name, dtype):
    q = _bf16(1, 16, 48).to(dtype)
    stats = torch.zeros(1, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        getattr(fa, name)(q, q, q, q.float(), stats, stats, 0.2)


def _source_tiles():
    """The wgmma kernels' block rows and looped tiles as the .cuh states them."""
    src = (CSRC / "flash_bwd_wgmma.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|bool) {name} = (\w+);", src).group(1))

    rows = re.search(r"constexpr int kRows = (\d+) \* kConsumers;", src).group(1)
    dq = re.search(r"constexpr int dq_key_tile\(\) \{ return (\w+); \}", src).group(1)
    limit, narrow, wide = re.search(
        r"constexpr int dkv_q_tile\(\) \{ return D <= (\d+) \? (\w+) : (\w+); \}", src).groups()
    return {"rows": int(rows) * const("kConsumers"), "dq": const(dq), "limit": int(limit),
            "narrow": const(narrow), "wide": const(wide)}


def test_wgmma_tiles_match_the_cuda_source():
    src = _source_tiles()
    assert fa.WGMMA_BWD_ROWS == src["rows"]
    assert fa.WGMMA_DQ_KEY_TILE == src["dq"]
    assert fa.WGMMA_DKV_Q_TILE == {"narrow": src["narrow"], "wide": src["wide"]}
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        want = src["narrow"] if -(-d // 16) * 16 <= src["limit"] else src["wide"]
        assert fa.wgmma_bwd_tiles(d) == {"dq": src["dq"], "dkv": want}


@pytest.mark.parametrize("lib", ["flash_bwd", "flash_bwd_kvres"])
def test_c_dispatch_is_the_python_rule(lib):
    """The C entries take the wgmma kernels for bf16 where hwb::takes, which
    is K1's hw::takes on q, k, v with do 16-byte aligned too: the rule
    ``takes_wgmma_bwd`` mirrors."""
    run = (CSRC / f"{lib}.cu").read_text()
    assert "hwb::takes(a.q, a.k, a.v, a.dout, a.d)" in run
    src = (CSRC / "flash_bwd_wgmma.cuh").read_text()
    assert ("return hw::takes(q, k, v, d) && reinterpret_cast<uintptr_t>(dout) % 16 == 0;"
            in src)
    fwd = (CSRC / "flash_fwd_wgmma.cuh").read_text()
    assert "return d > 0 && d <= 128 && d % 8 == 0 && aligned(q) && aligned(k) && aligned(v);" \
        in fwd


# ------------------------------------------------- the plain backward vs JAX ----
def _hash_keep(seed: int, state: dict):
    """A stand-in for JAX's ``_dropout_keep`` that draws the port's hash mask
    (csrc/dropout_hash.cuh) for the kernel's current tile: the q-row block is
    grid axis 1 and the key block axis 2, swapped in the dk/dv kernel
    (``state["dkv"]`` while it is traced)."""
    from jax.experimental import pallas as pl

    def fmix(h):
        h = h ^ (h >> 16)
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> 13)
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> 16)

    def keep(shape, dropout):
        row_axis, col_axis = (2, 1) if state["dkv"] else (1, 2)
        bh = pl.program_id(0).astype(jnp.uint32)
        rows = pl.program_id(row_axis) * shape[0] + jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        cols = pl.program_id(col_axis) * shape[1] + jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        row_key = fmix(fmix(np.uint32(seed) + bh * np.uint32(0x9E3779B9))
                       ^ (rows.astype(jnp.uint32) * np.uint32(0x85EBCA77)))
        bits = fmix(row_key ^ (cols.astype(jnp.uint32) * np.uint32(0xC2B2AE3D)))
        return jnp.where(bits >= np.uint32(fa.dropout_threshold(dropout)),
                         1.0 / (1.0 - dropout), 0.0)

    return keep


def _jax_backward(monkeypatch, q, k, v, dout, scale, dropout):
    """JAX's bf16 dq, dk, dv (interpret mode) from its own forward, with the
    port's mask where dropout > 0; and that forward's lse and out."""
    from buctd_tpu.ops import flash_attention as jax_fa

    if dropout > 0.0:
        state = {"dkv": False}
        dkv_kernel = jax_fa._dkv_kernel

        def traced_dkv(*args, **kwargs):
            state["dkv"] = True
            try:
                return dkv_kernel(*args, **kwargs)
            finally:
                state["dkv"] = False

        monkeypatch.setattr(jax_fa, "_dkv_kernel", traced_dkv)
        monkeypatch.setattr(jax_fa, "_dropout_keep", _hash_keep(SEED, state))
        monkeypatch.setattr(jax_fa.pltpu, "prng_seed", lambda *seeds: None)
    monkeypatch.delenv("BUCTD_FLASH_KVRES", raising=False)
    args = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v)]
    seed = jnp.zeros((1,), jnp.int32)

    def compiled(fn, *operands):
        return jax.jit(fn).lower(*operands).compile(XLA_OPTIONS)(*operands)

    out, lse = compiled(lambda a, b, c: jax_fa._flash_fwd_impl(a, b, c, seed, scale, dropout,
                                                               True), *args)
    grads = compiled(lambda a, b, c, l, o, g: jax_fa._flash_bwd_impl(
        a, b, c, seed, scale, dropout, True, l, o, g), *args, lse, out, jnp.asarray(dout.numpy()))
    assert all(g.dtype == jnp.bfloat16 for g in grads)
    return ([torch.from_numpy(np.asarray(g.astype(jnp.float32))) for g in grads],
            torch.from_numpy(np.array(lse)[:, :q.shape[1], 0].copy()),
            torch.from_numpy(np.array(out)))


def _half_step(x):
    """Half the spacing of bf16 values at each entry of bf16-valued x: the
    reach of its rounding interval."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 8)


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("bh,l,d", JAX_SHAPES)
def test_bf16_reference_matches_jax_vjp(monkeypatch, bh, l, d, dropout):
    q, k, v = _bf16(bh, l, d, seed=d), _bf16(bh, l, d, seed=d + 1), _bf16(bh, l, d, seed=d + 2)
    dout = _bf16(bh, l, d, seed=d + 3).float()
    scale = 1.0 / np.sqrt(d)
    want, lse, out = _jax_backward(monkeypatch, q, k, v, dout, scale, dropout)
    delta = (dout * out).sum(-1)
    got = fa.flash_attention_backward_reference(q, k, v, dout, lse, delta, scale, dropout,
                                                SEED)
    if dropout > 0.0:
        # the mask acted: the p = 0 gradients differ
        plain = fa.flash_attention_backward_reference(q, k, v, dout, lse, delta, scale)
        assert (plain[2] - got[2]).abs().max().item() > 0.1 * got[2].abs().max().item()
    # what rounding p * keep * c moves dv by, which JAX's interpret mode skips
    s, _ = fa._logits(q, k, scale)
    pk = torch.exp(s - lse[..., None])
    if dropout > 0.0:
        pk = pk * fa.dropout_multiplier(SEED, bh, l, l, dropout)
    pk_rounding = torch.matmul((fa._bf16(pk) - pk).transpose(1, 2), dout).abs()
    for g, w, extra in zip(got, want, (0.0, 0.0, pk_rounding)):
        assert torch.isfinite(g).all()
        miss = ((g - w).abs() - _half_step(w) - extra).clamp_min(0.0).max().item()
        assert miss <= K2_BF16_RTOL * w.abs().max().item(), (miss, w.abs().max().item())


def test_half_step_is_the_bf16_rounding_reach():
    x = torch.tensor([1.0, 1.5, -3.0, 1000.0, 2.0 ** -20])
    up = x + _half_step(x) * 0.99
    assert torch.equal(up.to(torch.bfloat16).float(), x)
    assert not torch.equal((x + _half_step(x) * 2.01).to(torch.bfloat16).float(), x)


@pytest.mark.parametrize("name", ["ring4", "one_wg", "no_overlap", "bk96", "bq32", "bq64",
                                  "bq16", "helper1"])
def test_bench_variants_apply_to_the_wgmma_source(name):
    """tools/bench_flash_bwd.py builds the wgmma kernels' variants by text
    substitution in csrc/flash_bwd_wgmma.cuh: each still applies and changes
    the source; the ones that change no arithmetic (the ring, the warpgroups,
    the overlap, the helpers) must then equal the shipped kernels bit for
    bit, the tile widths within K2_BF16_RTOL."""
    from buctd_tpu_torch.tools import bench_flash_bwd as bench

    assert set(bench.WGMMA_VARIANTS) == {"ring4", "one_wg", "no_overlap", "bk96", "bq32",
                                         "bq64", "bq16", "helper1"}
    texts = bench.variant_sources(name)
    assert list(texts) == ["flash_bwd_wgmma.cuh"]
    shipped = (CSRC / "flash_bwd_wgmma.cuh").read_text()
    assert texts["flash_bwd_wgmma.cuh"] != shipped
    for old, new in bench.WGMMA_VARIANTS[name]:
        assert old in shipped and new in texts["flash_bwd_wgmma.cuh"]
    assert (name in bench.SAME_BITS) == (name in ("ring4", "one_wg", "no_overlap", "helper1"))
