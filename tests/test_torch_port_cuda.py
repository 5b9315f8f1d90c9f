"""buctd_tpu_torch on the card: the CUDA kernel vs its plain version, the
wrapper's refusals, and the tiny estimator on CUDA vs on the CPU.

Every test is marked ``cuda`` and skips itself where torch.cuda.is_available()
is false.  The file imports no JAX, so it also runs on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

Tolerances: f32 kernel vs plain 2e-5 absolute and relative (both sum in f32,
in another order, over up to 700 keys; f32 K1 takes its products in 3xTF32,
within about 5e-7 of f32 at these shapes, while one tf32 pass lands near
1e-4 and misses); estimator card vs CPU 1e-3 px and 1e-3
in confidence (f32 convs with TF32 off, summed in another order).  bf16 K1
(the TMA + wgmma kernel where d is a multiple of 8 and the operands 16-byte
aligned, else the mma.sync kernel; either against the plain forward that rounds q' and
p * keep * c where it does): lse at 2e-5 absolute and relative (the f32 sum l
is never rounded), out within K1_BF16_RTOL x max |out|: f32 sums in another
order, and one-bf16-step flips of p * keep * c where exp2 and exp, or the
kernel's running row max and the plain version's final one, differ; and
within K1_BF16_TILED_RMS (relative rms) of ``forward_tile_rounded``, which
rounds p at the running max of the kernel's own key tiles, and whose
unrounded control must miss by more; the wgmma kernel's SASS holds HGMMA and
TMA loads (UTMALDG).  The
backward kernels (K2) vs the plain backward: f32 1e-4 absolute and relative
(dq, dk, dv sum products of a recomputed p over up to 700 keys or rows); bf16
(the TMA + wgmma pair where d is a multiple of 8 and q, k, v and the cast do
16-byte aligned, else the mma.sync pair; either against the plain backward
that rounds where they do) 2e-3 x max |grad|: f32 sums in another order, and
one-bf16-step flips of a rounded ds or p * keep * c where exp2 and exp differ
in the last bit; the wgmma pair's launches deterministic (two equal bit for
bit) and its SASS holding HGMMA and UTMALDG; f32 K2
takes its products in 3xTF32 (about 1e-6 from f32 here), while one tf32 pass
lands near 4e-4 and misses.  K1' and K2' take K1's and K2's gates against the
plain versions and equal K1/K2 bit for bit in both dtypes (the same
tensor-core kernels: the depth of the ring changes no arithmetic).  The warp (K4) vs its
plain version: 1e-4 on [0, 1) images (two tent taps against the dense sum);
its fused kernel vs the two-pass form it replaced bit for bit (the same tent
arithmetic, NaN where the two-pass form gives NaN), and a uint8 source with a
mask rectangle vs the f32 warp of images.float() * inside bit for bit and vs
the plain version of those images at 2e-3 (0..255 images).
The fused basic block (K5: f32 in 3xTF32 and bf16 on the tensor cores, and
the SIMT kernel of the A/B in both dtypes) vs its plain version: f32 atol =
rtol = 2e-5, which one tf32 pass misses, bf16 2^-6 (an f32 sum in another
order can round the intermediate or the output one bf16 step apart); at C =
384 the tensor-core kernels' error against float64 at most 2x the SIMT
kernel's; exp throughput (K6) rtol 1e-5 (expf/exp2f in f32, a few ulps); a
full-width preNet-W48 forward, fused or not, card vs CPU within 1e-4 of the
heatmaps' peak; a full-width TransPose-H forward (K1 at d = 112) no further
from the CPU's float64 forward than 2x the CPU's own f32 forward.  Under
bf16 autocast, every module's output dtype on the card equals the CPU's
exactly (the fuse layers' nn.Upsample, the control, must break that); a
matmul of TF32-rounded operands within 1e-4 of the peak of cuBLAS's own
TF32 product, which the exact product misses.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import flash_attention as fa
from test_torch_port_config import COAM_YAML, TINY_COAM, TINY_TRANSPOSE, TRANSPOSE_YAML, load_cfg

SHAPES = [(2, 256, 256, 48), (1, 300, 300, 112), (3, 640, 384, 96), (1, 128, 700, 64)]
# and two whose head dim is no multiple of 16, ragged in both L (d = 6: rows of
# 12 bytes, loaded through registers; d = 40: 16-byte cp.async, padded columns)
BWD_SHAPES = SHAPES + [(2, 100, 130, 40), (1, 70, 90, 6)]
# bf16 K1: ragged in both L, and d = 6 (12-byte rows: the register path), 40
# (padded columns), 48, 96, 112 and 128
K1_BF16_SHAPES = [(2, 100, 130, 6), (2, 130, 70, 40), (3, 200, 333, 48),
                  (2, 129, 257, 96), (1, 300, 300, 112), (1, 65, 700, 128)]
# every p of a key tile seen before its row's final max is rounded independently
# of the plain version's (a relative 2^-9 each): chip_smoke.py's K1_BF16_RTOL,
# which it measures at 1.02e-3 to 2.12e-3 of max |out| on an H100
K1_BF16_RTOL = 4e-3
# so the rounding itself is held to forward_tile_rounded: chip_smoke.py's
# K1_BF16_TILED_RMS (kernels 1.64e-5 to 4.05e-5 there, the unrounded control
# 1.338e-3 to 1.668e-3)
K1_BF16_TILED_RMS = 2e-4
BF16_GRAD_RTOL = 2e-3
# bf16 K1 on both of its kernels: the wgmma kernel takes every shape above
# whose d is a multiple of 8 (40, 48, 96, 112, 128), the mma.sync kernel d = 6;
# and a TransPose-H-wide one over several key tiles
WGMMA_SHAPES = K1_BF16_SHAPES + [(2, 1100, 1100, 112)]
# bf16 K2 on both of its pairs: the wgmma kernels at d = 48, 96 and 112 (and a
# TransPose-H-wide one ragged against every tile), the mma.sync ones at d = 6
# and 47
K2_BF16_SHAPES = [(2, 256, 256, 48), (3, 640, 384, 96), (1, 300, 300, 112),
                  (2, 1100, 1100, 112), (2, 100, 130, 6), (2, 90, 75, 47)]
# f32 K1 and K1' (3xTF32): ragged in both L; the dispatch sends d = 48, 96, 112
# and 128 to the TMA + wgmma kernel and d = 7 and 47 (rows of 188 bytes, no
# multiple of 16: the register load path) to the mma.sync kernel
K1_F32_SHAPES = [(2, 100, 130, 7), (2, 130, 200, 47), (3, 200, 333, 48),
                 (2, 129, 257, 96), (1, 300, 300, 112), (1, 65, 700, 128)]


def _assert_fwd_close(got, want, dtype):
    """out and lse of a forward kernel vs the plain forward (the gates above)."""
    (out, lse), (ref_out, ref_lse) = got, want
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=2e-5)
    else:
        err, top = (out - ref_out).abs().max().item(), ref_out.abs().max().item()
        assert err <= K1_BF16_RTOL * top, (err, top)


def _assert_grads_close(got, want, rtol=None):
    """Without rtol: atol = rtol = 1e-4; with it: within rtol x max |want|."""
    for g, w in zip(got, want):
        if rtol is None:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        else:
            err, top = (g - w).abs().max().item(), w.abs().max().item()
            assert err <= rtol * top, (err, top)


def _randomize(model):
    """N(0, 1/fan_in) weights and BN statistics away from the identity, as in
    chip_smoke.py: peaked heatmaps, so no argmax sits on a near-tie."""
    from buctd_tpu_torch.models.hrnet import random_init

    random_init(model)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(bh, lq, lk, d, dtype, device):
    rng = np.random.RandomState(0)
    return tuple(torch.from_numpy(rng.randn(bh, n, d).astype(np.float32)).to(device, dtype)
                 for n in (lq, lk, lk))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bh,lq,lk,d", SHAPES)
def test_kernel_matches_plain_version(cuda, bh, lq, lk, d, dtype):
    q, k, v = _qkv(bh, lq, lk, d, dtype, cuda)
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _assert_fwd_close((out, lse), fa.flash_attention_reference(q, k, v, d ** -0.5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("bh,lq,lk,d", K1_BF16_SHAPES)
def test_bf16_forward_kernel_matches_rounding_plain(cuda, bh, lq, lk, d, dropout):
    """K1's tensor-core kernel vs the plain forward that rounds where it does;
    its lse normalises the logits the backward recomputes, s' = q' k^T: rows
    of exp(s' - lse) sum to 1 within 1e-4 (s' summed in f32 in another order
    on both sides; the unrounded forward missed by 1.7e-3 to 4.6e-3)."""
    q, k, v = _qkv(bh, lq, lk, d, torch.bfloat16, cuda)
    scale, seed = d ** -0.5, 11
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, scale, dropout, seed)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _assert_fwd_close((out, lse), fa.flash_attention_reference(q, k, v, scale, dropout, seed),
                      torch.bfloat16)
    s, _ = fa._logits(q, k, scale)
    rows = torch.exp(s - lse[..., None]).sum(-1)
    assert (rows - 1).abs().max().item() <= 1e-4
    keep = fa.dropout_multiplier(seed, bh, lq, lk, dropout, cuda) if dropout > 0.0 else None
    tiled, control = fa.forward_tile_rounded(s, v, keep)
    rms = [((x - tiled).square().sum() / tiled.square().sum()).sqrt().item()
           for x in (out, control)]
    assert rms[0] <= K1_BF16_TILED_RMS < rms[1], rms


def _tile_rms(out, s, v, keep, bk):
    """Relative rms of out and of the unrounded control from
    forward_tile_rounded at key tile bk."""
    tiled, control = fa.forward_tile_rounded(s, v, keep, bk)
    return [((x - tiled).square().sum() / tiled.square().sum()).sqrt().item()
            for x in (out, control)]


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("bh,lq,lk,d", WGMMA_SHAPES)
def test_bf16_forward_dispatch_wgmma_and_mma(cuda, monkeypatch, bh, lq, lk, d, dropout):
    """bf16 K1 launches the wgmma kernel where takes_wgmma (counted on
    flash_attention.wgmma_launches), else the mma.sync kernel (mma_launches);
    either meets the bf16 gates against the plain forward (lse 2e-5, out
    K1_BF16_RTOL x max |out|) and K1_BF16_TILED_RMS against the rounding at
    its own key tile, whose unrounded control misses; K1' (the same kernels,
    a deeper ring) equals K1 bit for bit; the mma.sync kernel kept for the A/B
    (flash_attention_mma) meets the same gates at its tile."""
    monkeypatch.delenv("BUCTD_FLASH_KVRES", raising=False)
    q, k, v = _qkv(bh, lq, lk, d, torch.bfloat16, cuda)
    scale, seed = d ** -0.5, 13
    wgmma = fa.takes_wgmma(q, k, v)
    assert wgmma == (d % 8 == 0)
    counters = [fa.flash_attention.wgmma_launches, fa.flash_attention.mma_launches]
    out, lse = fa.flash_attention(q, k, v, scale, dropout, seed)
    torch.cuda.synchronize()
    assert [fa.flash_attention.wgmma_launches - counters[0],
            fa.flash_attention.mma_launches - counters[1]] == ([1, 0] if wgmma else [0, 1])
    want = fa.flash_attention_reference(q, k, v, scale, dropout, seed)
    _assert_fwd_close((out, lse), want, torch.bfloat16)
    s, _ = fa._logits(q, k, scale)
    keep = fa.dropout_multiplier(seed, bh, lq, lk, dropout, cuda) if dropout > 0.0 else None
    rms = _tile_rms(out, s, v, keep, fa.fwd_key_tile(d, wgmma))
    assert rms[0] <= K1_BF16_TILED_RMS < rms[1], rms
    kv_before = fa.flash_attention_kvres.wgmma_launches
    kv = fa.flash_attention_kvres(q, k, v, scale, dropout, seed)
    assert torch.equal(kv[0], out) and torch.equal(kv[1], lse)
    assert fa.flash_attention_kvres.wgmma_launches - kv_before == int(wgmma)
    mma = fa.flash_attention_mma(q, k, v, scale, dropout, seed)
    torch.cuda.synchronize()
    _assert_fwd_close(mma, want, torch.bfloat16)
    rms = _tile_rms(mma[0], s, v, keep, fa.fwd_key_tile(d, wgmma=False))
    assert rms[0] <= K1_BF16_TILED_RMS < rms[1], rms


@pytest.mark.cuda
def test_bf16_forward_kernels_run_hgmma_and_tma(cuda):
    """In K1's and K1''s libraries every instantiation of the wgmma kernel (8
    head-dim cases x dropout or not) holds wgmma (HGMMA) and TMA tensor loads
    (UTMALDG) in its SASS, and the mma.sync kernel holds HMMA."""
    from buctd_tpu_torch import _build

    for lib in ("flash_fwd", "flash_fwd_kvres"):
        _build.build([lib])
        for op, name, n in (("HGMMA", "flash_fwd_wgmma_kernel", 16),
                            ("UTMALDG", "flash_fwd_wgmma_kernel", 16),
                            ("HMMA", "flash_fwd_tc_kernel", 8)):
            got = {f: c for f, c in _build.sass_op_counts(lib, op).items() if name in f}
            assert len(got) == n and min(got.values()) > 0, (lib, op, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("bh,lq,lk,d", K1_F32_SHAPES)
def test_f32_forward_kernels_match_plain(cuda, monkeypatch, bh, lq, lk, d, dropout):
    """f32 K1 (3xTF32 on the tensor cores: the wgmma kernel where
    takes_wgmma_f32, counted on f32_wgmma_launches, else the mma.sync kernel,
    f32_mma_launches) and K1' vs the plain f32 forward at 2e-5 (out and lse),
    K1' bit for bit equal to K1 (the same kernel with a deeper ring), the
    mma.sync kernel kept for the A/B (flash_attention_mma) within the same
    gate, and the one-pass control misses the gate (the d = 7 case, seven
    terms a logit, is left out of that)."""
    monkeypatch.delenv("BUCTD_FLASH_KVRES", raising=False)
    q, k, v = _qkv(bh, lq, lk, d, torch.float32, cuda)
    scale, seed = d ** -0.5, 11
    wgmma = fa.takes_wgmma_f32(q, k, v)
    assert wgmma == (d % 8 == 0)
    names = ("launches", "f32_wgmma_launches", "f32_mma_launches")
    wrappers = (fa.flash_attention, fa.flash_attention_kvres)
    before = [getattr(f, n) for f in wrappers for n in names]
    got = fa.flash_attention(q, k, v, scale, dropout, seed)
    kvres = fa.flash_attention_kvres(q, k, v, scale, dropout, seed)
    torch.cuda.synchronize()
    assert [getattr(f, n) - b for (f, n), b in
            zip([(f, n) for f in wrappers for n in names], before)] == \
        [1, int(wgmma), int(not wgmma)] * 2
    want = fa.flash_attention_reference(q, k, v, scale, dropout, seed)
    _assert_fwd_close(got, want, torch.float32)
    for a, b in zip(kvres, got):
        assert torch.equal(a, b)
    mma = fa.flash_attention_mma(q, k, v, scale, dropout, seed)
    torch.cuda.synchronize()
    _assert_fwd_close(mma, want, torch.float32)
    keep = fa.dropout_multiplier(seed, bh, lq, lk, dropout, cuda) if dropout > 0.0 else None
    one_pass, _ = fa.forward_tf32(q, k, v, scale, 1, keep)
    if d > 7:
        with pytest.raises(AssertionError):
            torch.testing.assert_close(one_pass, got[0], atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 112])
@pytest.mark.parametrize("offset", [0.0, 3.0], ids=["v", "v+3"])
def test_f32_forward_long_rows_as_accurate_as_simt(cuda, offset, d):
    """At 6912 keys, with and without a common component in v (as fc_v's
    bias gives), f32 K1's out (the wgmma kernel at CoAM-W48's d = 48 and
    TransPose-H's 112) is no further from the plain f32 forward than twice
    the SIMT forward's: each tile's p v enters o with an f32 fma, not
    through the tensor cores' accumulator, whose error grows with L_k."""
    q, k, v = _qkv(2, 6912, 6912, d, torch.float32, cuda)
    v = v + offset
    scale = d ** -0.5
    want, _ = fa.flash_attention_reference(q, k, v, scale)
    got, _ = fa.flash_attention(q, k, v, scale)
    simt, _ = fa.flash_attention_simt(q, k, v, scale)
    err, simt_err = ((x - want).abs().max().item() for x in (got, simt))
    assert err <= 2 * simt_err, (err, simt_err)


@pytest.mark.cuda
def test_f32_forward_kernels_run_tf32_hmma(cuda):
    """The f32 forward kernels show their tensor-core instructions in their
    SASS (cuobjdump), in K1's and K1''s libraries: TF32 HMMA in the mma.sync
    kernel (8 head-dim cases), TF32 wgmma (HGMMA) and TMA loads (UTMALDG) in
    every instantiation of the wgmma kernel (8 head-dim cases x dropout or
    not) and no HMMA there; the SIMT forward kept beside K1 none."""
    from buctd_tpu_torch import _build

    for lib in ("flash_fwd", "flash_fwd_kvres"):
        _build.build([lib])
        tf32 = {f: n for f, n in _build.hmma_counts(lib, "TF32").items()
                if "flash_fwd_tf32_kernel" in f}
        simt = {f: n for f, n in _build.hmma_counts(lib).items() if "flash_fwd_kernel" in f}
        assert len(tf32) == 8 and min(tf32.values()) > 0, tf32   # 8 head-dim cases
        assert sum(simt.values()) == 0 and (lib == "flash_fwd") == bool(simt), simt
        name = "flash_fwd_tf32_wgmma_kernel"
        for op, kind in (("HGMMA", "TF32"), ("UTMALDG", "")):
            got = {f: c for f, c in _build.sass_op_counts(lib, op, kind).items() if name in f}
            assert len(got) == 16 and min(got.values()) > 0, (lib, op, got)
        hmma = {f: c for f, c in _build.hmma_counts(lib).items() if name in f}
        assert len(hmma) == 16 and sum(hmma.values()) == 0, hmma


@pytest.mark.cuda
def test_f32_forward_unaligned_base_takes_the_mma_kernel(cuda):
    """An f32 view 8 bytes into its storage (no 16-byte base, so no TMA)
    runs the mma.sync kernel at d = 48 (counted on f32_mma_launches) and
    meets the f32 gate; the aligned copy runs the wgmma kernel, within the
    same gate of it."""
    q, k, v = _qkv(2, 130, 200, 48, torch.float32, cuda)
    shifted = torch.empty(q.numel() + 2, device=cuda)[2:].view_as(q)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 == 8 and not fa.takes_wgmma_f32(shifted, k, v)
    before = [fa.flash_attention.f32_wgmma_launches, fa.flash_attention.f32_mma_launches]
    got = fa.flash_attention(shifted, k, v, 0.2)
    aligned = fa.flash_attention(q, k, v, 0.2)
    torch.cuda.synchronize()
    assert [fa.flash_attention.f32_wgmma_launches - before[0],
            fa.flash_attention.f32_mma_launches - before[1]] == [1, 1]
    want = fa.flash_attention_reference(q, k, v, 0.2)
    _assert_fwd_close(got, want, torch.float32)
    _assert_fwd_close(aligned, want, torch.float32)
    for a, b in zip(got, aligned):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_f32_serving_profile_names_no_simt_forward(cuda):
    """A profiled f32 predict of the tiny estimator (its attention at d = 8
    and 16) runs K1's f32 wgmma kernel and no SIMT or mma.sync forward
    (chip_smoke.py checks a full-width validate step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from buctd_tpu_torch.serving import PoseEstimator

    cfg = load_cfg("torch", opts=TINY_COAM)
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (200, 300, 3)).astype(np.uint8)
    conds = rng.uniform(60, 180, (2, 14, 2)).astype(np.float32)
    torch.manual_seed(1)
    est = PoseEstimator(cfg, refine_iters=1)
    est.predict(img, conds, float("-inf"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        est.predict(img, conds, float("-inf"))
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert any("flash_fwd_tf32_wgmma_kernel" in n for n in names), names
    assert not any("flash_fwd_kernel" in n or "flash_fwd_tf32_kernel" in n for n in names), names


@pytest.mark.cuda
def test_wrapper_raises_on_cuda_instead_of_falling_back(cuda):
    q, k, v = _qkv(2, 64, 64, 32, torch.float32, cuda)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 0.1)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half(), 0.1)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v, 0.1)
    assert fa.flash_attention.launches == before


@pytest.mark.cuda
def test_tiny_estimator_on_cuda_matches_cpu(cuda):
    from buctd_tpu_torch.serving import PoseEstimator

    cfg = load_cfg("torch", opts=TINY_COAM)
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (200, 300, 3)).astype(np.uint8)
    conds = rng.uniform(60, 180, (3, 14, 2)).astype(np.float32)
    torch.manual_seed(0)
    est = PoseEstimator(cfg, refine_iters=3)
    _randomize(est.model)
    est_cpu = PoseEstimator(cfg, refine_iters=3, device="cpu")
    est_cpu.model.load_state_dict({k: t.cpu() for k, t in est.model.state_dict().items()})
    before = fa.flash_attention.launches
    got = est.predict(img, conds, float("-inf"))
    # one launch per round: branch 0 runs 32*24 = 768 tokens (>= 512^2 pairs);
    # branch 1's 192 tokens take the batched matmul; the first call of a
    # bucket runs two eager warm-ups, the graph's capture (which launches
    # nothing) and a replay (graphs.py)
    assert fa.flash_attention.launches == before + 3 * 3
    want = est_cpu.predict(img, conds, float("-inf"))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bh,lq,lk,d", BWD_SHAPES)
def test_forward_and_backward_kernels_match_plain(cuda, bh, lq, lk, d, dtype, dropout):
    q, k, v = _qkv(bh, lq, lk, d, dtype, cuda)
    scale, seed = d ** -0.5, 99
    out, lse = fa.flash_attention(q, k, v, scale, dropout, seed)
    _assert_fwd_close((out, lse), fa.flash_attention_reference(q, k, v, scale, dropout, seed),
                      dtype)
    dout = torch.randn(bh, lq, d, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    delta = (dout * out).sum(-1)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, dropout, seed)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, dropout, seed)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    want = fa.flash_attention_backward_reference(q, k, v, dout, lse, delta, scale,
                                                 dropout, seed)
    _assert_grads_close((dq, dk, dv), want,
                        BF16_GRAD_RTOL if dtype == torch.bfloat16 else None)


def _k2_by_kernel():
    return [getattr(getattr(fa, name), f"{k}_launches") for name in
            ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_kvres", "flash_bwd_dkv_kvres")
            for k in ("wgmma", "mma")]


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("bh,lq,lk,d", K2_BF16_SHAPES)
def test_bf16_backward_dispatch_wgmma_and_mma(cuda, monkeypatch, bh, lq, lk, d, dropout):
    """bf16 K2 launches the wgmma pair where takes_wgmma_bwd (counted on
    wgmma_launches), else the mma.sync pair (mma_launches); either meets the
    bf16 gate against the plain backward; a second launch equals the first
    bit for bit (no atomics); K2' (the same kernels, a deeper ring) equals K2
    bit for bit; the mma.sync pair kept for the A/B (flash_bwd_dq_mma,
    flash_bwd_dkv_mma) meets the same gate."""
    monkeypatch.delenv("BUCTD_FLASH_KVRES", raising=False)
    q, k, v = _qkv(bh, lq, lk, d, torch.bfloat16, cuda)
    scale, seed = d ** -0.5, 21
    out, lse = fa.flash_attention(q, k, v, scale, dropout, seed)
    dout = torch.randn(bh, lq, d, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    args = (q, k, v, dout, lse, (dout * out).sum(-1), scale, dropout, seed)
    wgmma = fa.takes_wgmma_bwd(q, k, v, dout.to(torch.bfloat16))
    assert wgmma == (d % 8 == 0)
    before = _k2_by_kernel()
    got = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    kv = (fa.flash_bwd_dq_kvres(*args), *fa.flash_bwd_dkv_kvres(*args))
    torch.cuda.synchronize()
    on = [1, 0] if wgmma else [0, 1]
    assert [a - b for a, b in zip(_k2_by_kernel(), before)] == on * 4
    want = fa.flash_attention_backward_reference(*args)
    _assert_grads_close(got, want, BF16_GRAD_RTOL)
    again = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    for a, b, c in zip(got, again, kv):
        assert torch.equal(a, b) and torch.equal(a, c)
    mma = (fa.flash_bwd_dq_mma(*args), *fa.flash_bwd_dkv_mma(*args))
    torch.cuda.synchronize()
    _assert_grads_close(mma, want, BF16_GRAD_RTOL)


@pytest.mark.cuda
def test_bf16_backward_kernels_run_hgmma_and_tma(cuda):
    """In K2's and K2''s libraries every instantiation of the wgmma pair (8
    head-dim cases x dropout or not, each kernel) holds wgmma (HGMMA) and TMA
    tensor loads (UTMALDG) in its SASS, and the mma.sync pair holds HMMA."""
    from buctd_tpu_torch import _build

    wgmma = ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel")
    mma = ("flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")
    for lib in ("flash_bwd", "flash_bwd_kvres"):
        _build.build([lib])
        for op, names, n in (("HGMMA", wgmma, 32), ("UTMALDG", wgmma, 32), ("HMMA", mma, 16)):
            got = {f: c for f, c in _build.sass_op_counts(lib, op).items()
                   if any(name in f for name in names)}
            assert len(got) == n and min(got.values()) > 0, (lib, op, got)


def _k2_f32_by_kernel():
    return [getattr(getattr(fa, name), f"{k}_launches") for name in
            ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_kvres", "flash_bwd_dkv_kvres")
            for k in ("f32_wgmma", "f32_mma")]


# f32 K2's shapes: the model paths' head dims and d = 128 and 40, ragged
# against the wgmma plans' tiles and own rows; d = 47, which no TMA load takes
K2_F32_SHAPES = [(2, 300, 260, 48), (1, 200, 170, 96), (2, 150, 130, 112), (1, 100, 90, 128),
                 (1, 120, 100, 40), (1, 130, 90, 47)]


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("bh,lq,lk,d", K2_F32_SHAPES)
def test_f32_backward_dispatch_wgmma_and_mma(cuda, monkeypatch, bh, lq, lk, d, dropout):
    """f32 K2 launches the TMA + wgmma pair where takes_wgmma_bwd_f32
    (counted on f32_wgmma_launches), else the mma.sync pair
    (f32_mma_launches); either meets the f32 gate (1e-4) against the plain
    backward; a second launch equals the first bit for bit (no atomics); K2'
    (the same kernels, a deeper ring) equals K2 bit for bit; the mma.sync
    pair kept for the A/B (flash_bwd_dq_mma, flash_bwd_dkv_mma) meets the
    same gate."""
    monkeypatch.delenv("BUCTD_FLASH_KVRES", raising=False)
    q, k, v = _qkv(bh, lq, lk, d, torch.float32, cuda)
    scale, seed = d ** -0.5, 23
    out, lse = fa.flash_attention(q, k, v, scale, dropout, seed)
    dout = torch.randn(bh, lq, d, device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    args = (q, k, v, dout, lse, (dout * out).sum(-1), scale, dropout, seed)
    wgmma = fa.takes_wgmma_bwd_f32(q, k, v, dout)
    assert wgmma == (d % 8 == 0)
    before = _k2_f32_by_kernel()
    got = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    kv = (fa.flash_bwd_dq_kvres(*args), *fa.flash_bwd_dkv_kvres(*args))
    torch.cuda.synchronize()
    on = [1, 0] if wgmma else [0, 1]
    assert [a - b for a, b in zip(_k2_f32_by_kernel(), before)] == on * 4
    want = fa.flash_attention_backward_reference(*args)
    _assert_grads_close(got, want)
    again = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    for a, b, c in zip(got, again, kv):
        assert torch.equal(a, b) and torch.equal(a, c)
    mma = (fa.flash_bwd_dq_mma(*args), *fa.flash_bwd_dkv_mma(*args))
    torch.cuda.synchronize()
    _assert_grads_close(mma, want)


@pytest.mark.cuda
@pytest.mark.parametrize("operand", [0, 3], ids=["q", "dout"])
def test_f32_backward_unaligned_base_takes_the_mma_pair(cuda, operand):
    """An f32 q or do 8 bytes into its storage (no 16-byte base, so no TMA)
    sends f32 K2 at d = 48 to the mma.sync pair (f32_mma_launches), within
    the f32 gate; the aligned operands run the wgmma pair, within the same
    gate of it."""
    q, k, v = _qkv(2, 130, 200, 48, torch.float32, cuda)
    out, lse = fa.flash_attention(q, k, v, 0.2)
    dout = torch.randn(2, 130, 48, device=cuda, generator=torch.Generator(cuda).manual_seed(6))
    ops = [q, k, v, dout]
    shifted = torch.empty(ops[operand].numel() + 2, device=cuda)[2:].view_as(ops[operand])
    shifted.copy_(ops[operand])
    ops[operand] = shifted
    assert shifted.data_ptr() % 16 == 8 and not fa.takes_wgmma_bwd_f32(*ops)
    delta = (dout * out).sum(-1)
    before = _k2_f32_by_kernel()[:4]
    got = (fa.flash_bwd_dq(*ops, lse, delta, 0.2), *fa.flash_bwd_dkv(*ops, lse, delta, 0.2))
    aligned = (fa.flash_bwd_dq(q, k, v, dout, lse, delta, 0.2),
               *fa.flash_bwd_dkv(q, k, v, dout, lse, delta, 0.2))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_k2_f32_by_kernel()[:4], before)] == [1, 1, 1, 1]
    want = fa.flash_attention_backward_reference(q, k, v, dout, lse, delta, 0.2)
    _assert_grads_close(got, want)
    _assert_grads_close(aligned, want)


@pytest.mark.cuda
def test_f32_backward_wgmma_pair_runs_tf32_hgmma_and_tma(cuda):
    """In K2's and K2''s libraries every instantiation of the f32 wgmma pair
    (8 head-dim cases x dropout or not, each kernel) holds tf32 wgmma (HGMMA
    ... TF32) and TMA tensor loads (UTMALDG) in its SASS, and no mma.sync
    (HMMA)."""
    from buctd_tpu_torch import _build

    names = ("flash_bwd_dq_tf32_wgmma_kernel", "flash_bwd_dkv_tf32_wgmma_kernel")
    for lib in ("flash_bwd", "flash_bwd_kvres"):
        _build.build([lib])
        for op, kind in (("HGMMA", "TF32"), ("UTMALDG", ""), ("HMMA", "")):
            got = {f: c for f, c in _build.sass_op_counts(lib, op, kind).items()
                   if any(name in f for name in names)}
            assert len(got) == 32, (lib, op, got)
            assert (min(got.values()) > 0) == (op != "HMMA"), (lib, op, got)
            if op == "HMMA":
                assert sum(got.values()) == 0, (lib, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("bh,lq,lk,d", [(2, 256, 256, 48), (3, 640, 384, 96)])
def test_f32_backward_one_pass_control_misses(cuda, bh, lq, lk, d, dropout):
    """f32 K2 meets the 1e-4 gate against the plain backward where its
    arithmetic in one tf32 pass (``backward_tf32(passes=1)``) misses it, and
    the SIMT kernels of the A/B meet it too."""
    q, k, v = _qkv(bh, lq, lk, d, torch.float32, cuda)
    scale, seed = d ** -0.5, 3
    out, lse = fa.flash_attention(q, k, v, scale, dropout, seed)
    dout = torch.randn(bh, lq, d, device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    delta = (dout * out).sum(-1)
    want = fa.flash_attention_backward_reference(q, k, v, dout, lse, delta, scale, dropout,
                                                 seed)
    args = (q, k, v, dout, lse, delta, scale, dropout, seed)
    before = (fa.flash_bwd_dq_simt.launches, fa.flash_bwd_dkv_simt.launches)
    simt = (fa.flash_bwd_dq_simt(*args), *fa.flash_bwd_dkv_simt(*args))
    assert (fa.flash_bwd_dq_simt.launches, fa.flash_bwd_dkv_simt.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_grads_close((fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args)), want)
    _assert_grads_close(simt, want)
    keep = fa.dropout_multiplier(seed, bh, lq, lk, dropout, cuda) if dropout > 0.0 else None
    one_pass = fa.backward_tf32(q, k, v, dout, lse, delta, scale, 1, keep)
    with pytest.raises(AssertionError):
        _assert_grads_close(one_pass, want)


def _grads64(q, k, v, dout, scale):
    """dq, dk, dv of softmax(q k^T scale) v by autograd in float64."""
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    out = torch.softmax(q @ k.transpose(1, 2) * scale, dim=-1) @ v
    return torch.autograd.grad(out, (q, k, v), dout.double())


@pytest.mark.cuda
def test_f32_backward_long_rows_as_accurate_as_simt(cuda):
    """At 6912 keys and rows, f32 K2's dq, dk and dv are no further from
    float64 than twice the SIMT kernels' (max |err| / max |grad|): each
    looped tile's products enter the sums with an f32 add."""
    q, k, v = _qkv(2, 6912, 6912, 48, torch.float32, cuda)
    scale = 48 ** -0.5
    out, lse = fa.flash_attention(q, k, v, scale)
    dout = torch.randn(2, 6912, 48, device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    delta = (dout * out).sum(-1)
    args = (q, k, v, dout, lse, delta, scale)
    want = _grads64(q, k, v, dout, scale)
    errs = []
    for got, simt, w in zip((fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args)),
                            (fa.flash_bwd_dq_simt(*args), *fa.flash_bwd_dkv_simt(*args)),
                            want):
        top = w.abs().max().item()
        errs.append(((got.double() - w).abs().max().item() / top,
                     (simt.double() - w).abs().max().item() / top))
    assert all(e <= 2 * s for e, s in errs), errs


@pytest.mark.cuda
def test_f32_backward_kernels_run_tf32_hmma(cuda):
    """K2's and K2''s f32 kernels show TF32 HMMA in their SASS, 8 head-dim
    cases each; the SIMT kernels kept in K2's library for the A/B none, and
    K2''s library has none."""
    from buctd_tpu_torch import _build

    for lib in ("flash_bwd", "flash_bwd_kvres"):
        _build.build([lib])
        tf32 = {f: n for f, n in _build.hmma_counts(lib, "TF32").items() if "_tf32_kernel" in f}
        simt = {f: n for f, n in _build.hmma_counts(lib).items()
                if "flash_bwd_dq_kernel" in f or "flash_bwd_dkv_kernel" in f}
        assert len(tf32) == 16 and min(tf32.values()) > 0, tf32
        assert sum(simt.values()) == 0 and (lib == "flash_bwd") == bool(simt), simt


@pytest.mark.cuda
def test_train_function_on_cuda_matches_cpu(cuda):
    q, k, v = _qkv(2, 300, 200, 48, torch.float32, cuda)
    dout = torch.randn(2, 300, 48, generator=torch.Generator().manual_seed(3))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention_train(*leaves, 0.2, 0.1, 7)
        out.backward(dout.to(dev))
        grads.append([out.detach().cpu()] + [x.grad.cpu() for x in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_warp_kernel_matches_plain(cuda):
    from buctd_tpu_torch.geometry import make_affine
    from buctd_tpu_torch.ops import warp as tw

    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.rand(4, 160, 140, 3).astype(np.float32)).to(cuda)
    t = make_affine(torch.tensor([[70.0, 80.0], [60.0, 90.0], [75.0, 70.0], [70.0, 85.0]]),
                    torch.tensor([[0.6, 0.7], [0.5, 0.6], [0.7, 0.8], [0.55, 0.7]]),
                    torch.tensor([0.0, 30.0, -60.0, 90.0]), (96, 128), inv=True).to(cuda)
    before = tw.warp_resample.launches
    got = tw.warp_affine_general(imgs, t, (128, 96))
    torch.cuda.synchronize()
    assert tw.warp_resample.launches == before + 1       # one fused launch a call
    want = tw.warp_affine_reference(imgs, t, (128, 96))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _same_bits(got, want):
    """Equal bit for bit, NaN in the same places (CUDA's NaN is canonical)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("C", [1, 3])
def test_fused_warp_matches_two_pass_bit_for_bit(cuda, C, nan):
    """tests/warp_cases.py: both decompositions, |d| 0.2-8 (the band walked
    in chunks), the guarded d = 1e-6, random affines, sizes no multiple of
    the tile; a NaN pixel in every image where it says so."""
    import warp_cases
    from buctd_tpu_torch.ops import warp as tw

    cases = warp_cases.cases()
    t = torch.from_numpy(np.stack([m for _, m in cases])).to(cuda)
    imgs = torch.from_numpy(warp_cases.images(len(cases), C, seed=C)).to(cuda)
    if nan:
        imgs[:, 26, 30, 0] = float("nan")
    before = tw.warp_resample_two_pass.launches
    want = tw.warp_resample_two_pass(imgs, t, warp_cases.OUT_HW)
    got = tw.warp_resample(imgs, t, warp_cases.OUT_HW)
    torch.cuda.synchronize()
    assert tw.warp_resample_two_pass.launches == before + 2
    _same_bits(got, want)
    assert torch.isnan(got).any() == nan
    if not nan:
        plain = tw.warp_affine_reference(imgs, t, warp_cases.OUT_HW)
        torch.testing.assert_close(got, plain, atol=2e-3, rtol=0)   # 0..255: chip_smoke's WARP_ATOL


@pytest.mark.cuda
def test_fused_warp_uint8_mask_matches_masked_f32(cuda):
    import warp_cases
    from buctd_tpu_torch.ops import warp as tw

    cases = warp_cases.cases()
    n = len(cases)
    t = torch.from_numpy(np.stack([m for _, m in cases])).to(cuda)
    u8 = torch.from_numpy(warp_cases.images(n, 3, seed=4, dtype=np.uint8)).to(cuda)
    box = torch.from_numpy(warp_cases.mask_boxes(n, seed=4)).to(cuda)
    got = tw.warp_affine_general(u8, t, warp_cases.OUT_HW, mask_box=box)
    masked = u8.float() * tw.mask_inside(box, *warp_cases.SRC_HW)[..., None]
    _same_bits(got, tw.warp_resample(masked, t, warp_cases.OUT_HW))
    _same_bits(got, tw.warp_resample_two_pass(masked, t, warp_cases.OUT_HW))
    plain = tw.warp_affine_reference(masked, t, warp_cases.OUT_HW)
    torch.testing.assert_close(got, plain, atol=2e-3, rtol=0)   # 0..255: chip_smoke's WARP_ATOL
    whole = torch.tensor([[0.0, 0.0, warp_cases.SRC_HW[1], warp_cases.SRC_HW[0]]],
                         device=cuda).expand(n, 4).contiguous()   # every pixel inside
    _same_bits(tw.warp_resample(u8, t, warp_cases.OUT_HW, whole),
               tw.warp_resample(u8.float(), t, warp_cases.OUT_HW))


@pytest.mark.cuda
def test_warp_wrapper_refuses_other_dtypes(cuda):
    from buctd_tpu_torch.ops import warp as tw

    t = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], device=cuda)
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError):
            tw.warp_affine_general(torch.zeros(1, 8, 8, 3, dtype=dtype, device=cuda), t,
                                   (4, 4))
    with pytest.raises(TypeError):                      # the two-pass form: f32 only
        tw.warp_resample_two_pass(torch.zeros(1, 8, 8, 3, dtype=torch.uint8, device=cuda),
                                  t, (4, 4))
    box = torch.tensor([[0.0, 0.0, 8.0, 8.0]], device=cuda)
    with pytest.raises(TypeError):                      # uint8 takes its mask box
        tw.warp_resample(torch.zeros(1, 8, 8, 3, dtype=torch.uint8, device=cuda), t, (4, 4))
    with pytest.raises(TypeError):                      # f32 takes none
        tw.warp_resample(torch.zeros(1, 8, 8, 3, device=cuda), t, (4, 4), box)


# K1'/K2' (the kv-resident kernels) take K2's shapes and an odd head dim: for
# them the ones whose head dim is no multiple of 16 exercise the rings' padded
# columns, f32 copies of 16, 8 and 4 bytes, and in bf16 the register path
# (d = 7: 14-byte rows, refused before the bf16 kernels ran on the tensor cores)
@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bh,lq,lk,d", BWD_SHAPES + [(2, 90, 75, 7)])
def test_kvres_kernels_match_plain_and_k1_k2(cuda, monkeypatch, bh, lq, lk, d, dtype,
                                             dropout):
    """K1' and K2' vs the plain versions (K1's and K2's gates) and vs K1/K2 on
    the same inputs: bit for bit in both dtypes (K1's and K2's kernels with a
    deeper ring)."""
    monkeypatch.delenv("BUCTD_FLASH_KVRES", raising=False)
    q, k, v = _qkv(bh, lq, lk, d, dtype, cuda)
    scale, seed = d ** -0.5, 5
    before = [f.launches for f in (fa.flash_attention_kvres, fa.flash_bwd_dq_kvres,
                                   fa.flash_bwd_dkv_kvres)]
    out, lse = fa.flash_attention_kvres(q, k, v, scale, dropout, seed)
    dout = torch.randn(bh, lq, d, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    delta = (dout * out).sum(-1)
    dq = fa.flash_bwd_dq_kvres(q, k, v, dout, lse, delta, scale, dropout, seed)
    dk, dv = fa.flash_bwd_dkv_kvres(q, k, v, dout, lse, delta, scale, dropout, seed)
    torch.cuda.synchronize()
    assert [f.launches for f in (fa.flash_attention_kvres, fa.flash_bwd_dq_kvres,
                                 fa.flash_bwd_dkv_kvres)] == [b + 1 for b in before]
    _assert_fwd_close((out, lse), fa.flash_attention_reference(q, k, v, scale, dropout, seed),
                      dtype)
    want = fa.flash_attention_backward_reference(q, k, v, dout, lse, delta, scale, dropout,
                                                 seed)
    bf16 = dtype == torch.bfloat16
    _assert_grads_close((dq, dk, dv), want, BF16_GRAD_RTOL if bf16 else None)
    k1 = fa.flash_attention(q, k, v, scale, dropout, seed)
    k2 = (fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, dropout, seed),
          *fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, dropout, seed))
    for got, old in zip((out, lse, dq, dk, dv), (*k1, *k2)):
        assert torch.equal(got, old)


@pytest.mark.cuda
def test_kvres_switch_routes_cuda_tensors(cuda, monkeypatch):
    """BUCTD_FLASH_KVRES=1: flash_attention and the training backward launch
    K1' and K2' only, f32 and bf16, and bf16 rows of 14 bytes among them."""
    monkeypatch.setenv("BUCTD_FLASH_KVRES", "1")
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                fa.flash_attention_kvres, fa.flash_bwd_dq_kvres, fa.flash_bwd_dkv_kvres)
    for dtype, d in ((torch.float32, 48), (torch.bfloat16, 48), (torch.bfloat16, 7)):
        q, k, v = (x.requires_grad_() for x in _qkv(2, 300, 200, d, dtype, cuda))
        before = [f.launches for f in counters]
        out = fa.flash_attention_train(q, k, v, 0.2, 0.1, 7)
        out.sum().backward()
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counters, before)] == [0, 0, 0, 1, 1, 1]
        assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


# K5 (fused basic block): f32 and bf16, W not a multiple of 8, C = 384, and a
# C no chunk divides; tolerances as chip_smoke.py's (K5_ATOL)
K5_SHAPES = [(2, 12, 9, 16), (2, 24, 18, 192), (1, 12, 9, 384), (3, 13, 11, 40)]
K5_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
# the tensor-core kernels (fused_basic_block: f32 in 3xTF32, bf16) and, for
# the A/B, the SIMT kernel in both dtypes (fused_basic_block_simt)
K5_KERNELS = [(torch.float32, "fused_basic_block"), (torch.bfloat16, "fused_basic_block"),
              (torch.bfloat16, "fused_basic_block_simt"),
              (torch.float32, "fused_basic_block_simt")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernel", K5_KERNELS,
                         ids=["f32", "bf16", "bf16-simt", "f32-simt"])
@pytest.mark.parametrize("b,h,w,c", K5_SHAPES)
def test_fused_block_kernel_matches_plain(cuda, b, h, w, c, dtype, kernel):
    from buctd_tpu_torch.ops import fused_block as fb
    from buctd_tpu_torch.tools import bench_block_variants as bv

    args = bv.random_block(torch.Generator(cuda).manual_seed(c), b, h, w, c, dtype=dtype)
    fn = getattr(fb, kernel)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and got.dtype == dtype
    want = fb.fused_basic_block_plain(*args)
    tol = K5_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_block_long_k_as_accurate_as_simt(cuda, dtype):
    """K5 at C = 384 (K = 3456 terms a conv) against a float64 chain on the
    same operands (the intermediate rounded where the kernels round it): the
    tensor-core kernel's max and rms error at most 2x the SIMT kernel's (f32:
    3xTF32; bf16: and its share of outputs off the chain rounded to bf16;
    chip_smoke.py's K5_LONG_K_RATIO)."""
    from buctd_tpu_torch.ops import fused_block as fb
    from buctd_tpu_torch.tools import bench_block_variants as bv

    args = bv.random_block(torch.Generator(cuda).manual_seed(384), 8, 12, 9, 384, dtype=dtype)
    want = bv.reference64(*args)
    tc = bv.accuracy(fb.fused_basic_block(*args), want)
    simt = bv.accuracy(fb.fused_basic_block_simt(*args), want)
    if dtype == torch.float32:      # no rounded chain to count outputs off
        tc, simt = tc[:2], simt[:2]
    assert all(t <= 2.0 * s for t, s in zip(tc, simt)), (tc, simt)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", [(2, 24, 18, 48), (2, 12, 9, 384)])
def test_fused_block_f32_one_pass_control_misses(cuda, b, h, w, c):
    """f32 K5 meets the 2e-5 gate against the plain version where its
    arithmetic in one tf32 pass (``fused_block_tf32(passes=1)``) misses it;
    the three-pass emulation meets it."""
    from buctd_tpu_torch.ops import fused_block as fb
    from buctd_tpu_torch.tools import bench_block_variants as bv

    args = bv.random_block(torch.Generator(cuda).manual_seed(c + 1), b, h, w, c,
                           dtype=torch.float32)
    want = fb.fused_basic_block_plain(*args)
    torch.testing.assert_close(fb.fused_basic_block(*args), want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(fb.fused_block_tf32(*args), want, atol=2e-5, rtol=2e-5)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(fb.fused_block_tf32(*args, passes=1), want, atol=2e-5,
                                   rtol=2e-5)


def _assert_nonfinite_alike(got, want):
    """got is not finite exactly where want is not, and want has such
    entries: a NaN operand reached the output as it reaches the plain
    version's."""
    for g, w in zip(got, want):
        bad = ~torch.isfinite(w)
        assert bad.any() and torch.equal(~torch.isfinite(g), bad), (
            bad.sum().item(), (~torch.isfinite(g)).sum().item())


@pytest.mark.cuda
@pytest.mark.parametrize("kvres", [False, True], ids=["k1_k2", "kvres"])
@pytest.mark.parametrize("bh,lq,lk,d", [(2, 128, 128, 48), (1, 100, 130, 96)])
def test_f32_flash_kernels_take_nan_as_plain(cuda, bh, lq, lk, d, kvres):
    """A NaN in q reaches f32 K1's out and lse (its wgmma kernel, where the
    dispatch sends these shapes, and its mma.sync kernel) and f32 K2's dq, dk
    and dv (and K1''s and K2''s) where it reaches the plain versions': the
    split's lo carries a NaN operand (dropout 0: a dropped entry is 0 by
    selection in the kernels and NaN times 0 in the plain version)."""
    q, k, v = _qkv(bh, lq, lk, d, torch.float32, cuda)
    q[-1, lq // 2, d // 3] = float("nan")
    scale = d ** -0.5
    fwd, dq_fn, dkv_fn = ((fa.flash_attention_kvres, fa.flash_bwd_dq_kvres,
                           fa.flash_bwd_dkv_kvres) if kvres else
                          (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv))
    out, lse = fa.flash_attention_reference(q, k, v, scale)
    assert fa.takes_wgmma_f32(q, k, v)
    _assert_nonfinite_alike(fwd(q, k, v, scale), (out, lse))
    _assert_nonfinite_alike(fa.flash_attention_mma(q, k, v, scale), (out, lse))
    dout = torch.randn(bh, lq, d, device=cuda, generator=torch.Generator(cuda).manual_seed(6))
    delta = (dout * out).sum(-1)
    args = (q, k, v, dout, lse, delta, scale)
    _assert_nonfinite_alike((dq_fn(*args), *dkv_fn(*args)),
                            fa.flash_attention_backward_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernel", K5_KERNELS,
                         ids=["f32", "bf16", "bf16-simt", "f32-simt"])
@pytest.mark.parametrize("b,h,w,c", [(2, 24, 18, 48), (2, 12, 9, 384)])
def test_fused_block_takes_nan_as_plain(cuda, b, h, w, c, dtype, kernel):
    """A NaN in x reaches K5's output where it reaches the plain version's
    (every channel of the 5x5 pixels around it): the split's lo carries it
    and relu keeps it."""
    from buctd_tpu_torch.ops import fused_block as fb
    from buctd_tpu_torch.tools import bench_block_variants as bv

    args = bv.random_block(torch.Generator(cuda).manual_seed(c + 2), b, h, w, c, dtype=dtype)
    args[0][1, h // 2, 0, c // 2] = float("nan")
    _assert_nonfinite_alike([getattr(fb, kernel)(*args)], [fb.fused_basic_block_plain(*args)])


@pytest.mark.cuda
def test_fused_block_tensor_core_kernels_run_hmma(cuda):
    """Every tile plan's fused_block_tc_kernel shows HMMA in its SASS and
    every f32 plan's fused_block_tf32_kernel TF32 HMMA, the SIMT kernels (f32
    and bf16, for the A/B) none; either dtype wider than 384 channels raises
    before a launch."""
    from buctd_tpu_torch import _build
    from buctd_tpu_torch.ops import fused_block as fb

    _build.build(["fused_block"])
    hmma = _build.hmma_counts("fused_block")
    tc = {f: n for f, n in hmma.items() if "fused_block_tc_kernel" in f}
    tf32 = {f: n for f, n in _build.hmma_counts("fused_block", "TF32").items()
            if "fused_block_tf32_kernel" in f}
    simt = {f: n for f, n in hmma.items() if "fused_block_kernel" in f}
    assert len(tc) == len(fb.TC_PLANS) and min(tc.values()) > 0, tc
    assert len(tf32) == len(fb.TF32_PLANS) and min(tf32.values()) > 0, tf32
    assert len(simt) == 8 and sum(simt.values()) == 0, simt
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros(1, 4, 4, 400, device=cuda, dtype=dtype)
        w, b = torch.zeros(3, 3, 400, 400, device=cuda, dtype=x.dtype), x[0, 0, 0]
        before = fb.fused_basic_block.launches
        with pytest.raises(ValueError):
            fb.fused_basic_block(x, w, w, b, b)
        assert fb.fused_basic_block.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("inner", [1, 2, 3, 128])
def test_exp_kernel_matches_plain(cuda, inner):
    """1-3 steps, where the input and the step count still show, and the full
    chain, on inputs over [-100, 100]."""
    from buctd_tpu_torch.ops import exp_throughput as ex

    gen = torch.Generator(cuda).manual_seed(inner)
    x = torch.rand(64, 1000, device=cuda, generator=gen) * 200 - 100
    for variant in ex.VARIANTS:
        before = ex.exp_chain.launches
        got = ex.exp_chain(x, variant, inner)
        torch.cuda.synchronize()
        assert ex.exp_chain.launches == before + 1
        torch.testing.assert_close(got, ex.exp_chain_plain(x, variant, inner), atol=0,
                                   rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("knob", ["off", "auto"])
def test_prenet_forward_on_cuda_matches_cpu(cuda, knob):
    """A full-width preNet-W48 forward (crowdpose 384x288), fused or not, on
    the card vs the CPU: within 1e-4 of the heatmaps' peak (f32, TF32 off)."""
    import copy

    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.models.fuse import maybe_fuse_prenet
    from test_torch_port_config import REPO

    yaml = REPO / "experiments" / "crowdpose" / "buctd" / "prenet_w48_384x288.yaml"
    cfg = load_cfg("torch", yaml, ["TPU.FUSED_PRENET", knob])
    torch.manual_seed(0)
    model = get_model(cfg)
    _randomize(model)
    model = maybe_fuse_prenet(cfg, model)
    assert model.fused_prenet == (knob == "auto")
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 6, 384, 288).astype(np.float32))
    with torch.inference_mode():
        got = model(x.to(cuda)).cpu()
        want = copy.deepcopy(model).cpu()(x)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_transpose_forward_on_cuda_matches_cpu(cuda):
    """A full-width TransPose-H forward (coco 384x288, 6 encoder layers of one
    d = 112 head over 6912 tokens), f32 with TF32 off, on the card and on the
    CPU, each against the CPU's float64 forward: the card's no further than
    2x the CPU's.  The first encoder layer takes the trunk's unnormalised
    tokens (|x| ~ 650 under random weights: logits ~1e4), so f32 itself lies
    ~1e-4 of the peak from float64 there, and two f32 forwards ~1e-3 apart
    (chip_smoke.py's FORWARD_F64_RATIO).  The card's forward launches K1 once
    a layer."""
    import copy

    from buctd_tpu_torch.models import get_model
    from test_torch_port_config import REPO

    yaml = REPO / "experiments" / "coco" / "buctd" / "transpose_h_384x288.yaml"
    cfg = load_cfg("torch", yaml)
    torch.manual_seed(0)
    model = get_model(cfg)
    _randomize(model)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 6, 384, 288).astype(np.float32))
    fa.flash_attention.launches = 0
    with torch.inference_mode():
        got = model(x.to(cuda)).cpu()
        assert fa.flash_attention.launches == 6
        cpu_model = copy.deepcopy(model).cpu()
        want = cpu_model(x)
        exact = cpu_model.double()(x.double())
    assert got.shape == (2, 17, 96, 72)
    card, cpu = ((t.double() - exact).abs().max().item() for t in (got, want))
    assert card <= 2.0 * cpu, (card, cpu)


def _coco_scenario():
    """tests/test_pose_synthesis.py's COCO scenario (17 visible joints, one
    overlapping neighbour), without its JAX import."""
    rng = np.random.RandomState(7)
    joints = np.zeros((17, 3))
    joints[:, 0] = rng.uniform(100, 200, 17)
    joints[:, 1] = rng.uniform(100, 300, 17)
    joints[:, 2] = 2
    near = joints[None].copy()
    near[0, :, 0] += 60
    return joints, joints.copy(), near, 150 * 250


def _mode_rates(samples, joints, area, sigmas):
    """good / jitter / far / zero rates by distance from GT (ks85, ks50)."""
    var = (sigmas * 2) ** 2
    ks50, ks85 = (np.sqrt(-2 * area * var * np.log(p)) for p in (0.50, 0.85))
    d = np.linalg.norm(samples[..., :2] - joints[None, :, :2], axis=-1)
    zero = samples[..., 2] == 0
    return np.array([((d <= ks85) & ~zero).mean(), ((d > ks85) & (d <= ks50) & ~zero).mean(),
                     ((d > ks50) & ~zero).mean(), zero.mean()])


@pytest.mark.cuda
def test_card_sampler_rates_match_the_host_sampler(cuda):
    """The batched sampler on the card against the port's host sampler: the
    four mode rates within 0.05 (the JAX package's device-vs-host tolerance),
    the far rate above 0.01; finite (B, J, 3) at CrowdPose's training shapes
    (batch 32, 14 joints, 8 neighbours)."""
    import types

    from buctd_tpu_torch.data.pose_synthesis import COCO_SIGMAS, synthesize_pose
    from buctd_tpu_torch.data.pose_synthesis_device import make_synthesize_fn

    def cfg(dataset, J):
        return types.SimpleNamespace(MODEL=types.SimpleNamespace(NUM_JOINTS=J),
                                     DATASET=types.SimpleNamespace(DATASET=dataset))

    joints, est, near, area = _coco_scenario()
    n = 600
    fn = make_synthesize_fn(cfg("coco", 17), P_max=4, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    card = fn(gen, np.repeat(joints[None], n, 0), np.repeat(est[None], n, 0), [near] * n,
              np.full(n, float(area))).cpu().numpy()
    host_rng = np.random.RandomState(5)
    host = np.stack([synthesize_pose(cfg("coco", 17), joints, est, near, area, 0, rng=host_rng)
                     for _ in range(150)])
    got, want = (_mode_rates(s, joints, area, COCO_SIGMAS) for s in (card, host))
    np.testing.assert_allclose(got, want, atol=0.05)
    assert got[2] > 0.01

    rng = np.random.RandomState(1)
    cp = make_synthesize_fn(cfg("crowdpose", 14), P_max=8, device=cuda)
    j = np.concatenate([rng.uniform(50, 400, (32, 14, 2)), np.full((32, 14, 1), 2.0)], -1)
    out = cp(gen, j, j, [j[(i + 1) % 32][None].repeat(8, 0) for i in range(32)],
             np.full(32, 40000.0))
    assert out.shape == (32, 14, 3) and out.is_cuda and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("model_name", ["coam_modules", "transpose_h"])
def test_remat_gradients_on_the_card(cuda, model_name):
    """TPU.REMAT's gradients on the card equal those without it, attention
    dropout on through K1 and K2 (the flash engine): within 1e-5 of the max
    gradient (cuDNN's backward convs may sum in another order between runs);
    a recompute that drew another dropout seed would move them by O(1)."""
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.train.state import TrainStep, make_lr_schedule, make_optimizer

    if model_name == "transpose_h":
        yaml, opts, J, k1_per_forward = TRANSPOSE_YAML, list(TINY_TRANSPOSE), 17, 2
    else:
        yaml, opts, J, k1_per_forward = COAM_YAML, list(TINY_COAM), 14, 3
    rng = np.random.RandomState(4)
    batch = {"input": torch.from_numpy(rng.randn(2, 6, 128, 96).astype(np.float32)).to(cuda),
             "target": torch.from_numpy((rng.rand(2, J, 32, 24) > 0.99).astype(np.float32)).to(cuda),
             "target_weight": torch.ones(2, J, device=cuda)}
    grads, launches = [], []
    for remat in (False, True):
        cfg = load_cfg("torch", yaml, opts + ["TPU.COMPUTE_DTYPE", "float32",
                                              "TPU.ATTENTION_ENGINE", "flash",
                                              "TPU.REMAT", str(remat)])
        torch.manual_seed(0)
        model = get_model(cfg, device=cuda)
        _randomize(model)
        optimizer = make_optimizer(cfg, model)
        step = TrainStep(cfg, model, optimizer, make_lr_schedule(cfg, optimizer, 1),
                         torch.Generator().manual_seed(5))
        before = fa.flash_attention.launches
        torch.manual_seed(1)
        step(batch)
        torch.cuda.synchronize()
        launches.append(fa.flash_attention.launches - before)
        grads.append({n: p.grad.float().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    top = max(float(g.abs().max()) for g in grads[0].values())
    for name, g in grads[0].items():
        err = float((grads[1][name] - g).abs().max())
        assert err <= 1e-5 * top, (name, err, top)
    # the whole-forward recompute (TransPose-H) runs K1 again; CoAM's units
    # leave the attention outside
    assert launches[0] == k1_per_forward
    assert launches[1] == (2 if model_name == "transpose_h" else 1) * k1_per_forward


@pytest.mark.cuda
def test_bf16_estimator_runs_the_tensor_core_forward(cuda, monkeypatch):
    """A tiny bf16 PoseEstimator (TPU.EVAL_DTYPE bfloat16) on the card:
    finite poses, K1 launched once a round (in the first call's two warm-ups and
    its replay) through its tensor-core kernel
    (flash_fwd_wgmma_kernel in the profile, no SIMT and no 3xTF32 forward), its
    warp on TF32 operands and an f32 estimator's warp exact in the same
    process, the process's flags as they were after both."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from buctd_tpu_torch.core import refine
    from buctd_tpu_torch.serving import PoseEstimator

    seen = []
    real_warp = refine.warp_affine_aligned

    def warp(*args, tf32, **kw):
        seen.append((tf32, torch.backends.cuda.matmul.allow_tf32))
        return real_warp(*args, tf32=tf32, **kw)

    monkeypatch.setattr(refine, "warp_affine_aligned", warp)
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (200, 300, 3)).astype(np.uint8)
    conds = rng.uniform(60, 180, (2, 14, 2)).astype(np.float32)
    torch.manual_seed(2)
    est = PoseEstimator(load_cfg("torch", opts=TINY_COAM + ["TPU.EVAL_DTYPE", "bfloat16"]),
                        refine_iters=2)
    _randomize(est.model)
    f32 = PoseEstimator(load_cfg("torch", opts=TINY_COAM), refine_iters=1)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    before = fa.flash_attention.launches
    out = est.predict(img, conds, float("-inf"))
    # a round each, in the bucket's two eager warm-ups and its first replay
    assert fa.flash_attention.launches == before + 2 * 3
    assert out.shape == (2, 14, 3) and np.isfinite(out).all()
    f32.predict(img, conds, float("-inf"))
    assert seen == [(True, False)] * (2 * 3) + [(False, False)] * 3
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        est.predict(img, conds, float("-inf"))
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert any("flash_fwd_wgmma_kernel" in n for n in names), names
    assert not any("flash_fwd_kernel" in n or "flash_fwd_tf32" in n for n in names), names


@pytest.mark.cuda
def test_bf16_forward_at_a_serving_shape_holds_against_tile_rounding(cuda):
    """bf16 K1 at dropout 0 at CoAM-W48's branch-1 serving shape (the 16
    crops of a predict_batch, 1728 tokens, d = 96): lse at 2e-5, out within
    K1_BF16_RTOL x max |out| of the plain forward, within K1_BF16_TILED_RMS of
    forward_tile_rounded, whose unrounded control misses by more."""
    bh, lq, d = 16, 1728, 96
    q, k, v = _qkv(bh, lq, lq, d, torch.bfloat16, cuda)
    scale = d ** -0.5
    out, lse = fa.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    _assert_fwd_close((out, lse), fa.flash_attention_reference(q, k, v, scale), torch.bfloat16)
    s, _ = fa._logits(q, k, scale)
    tiled, control = fa.forward_tile_rounded(s, v, None)
    rms = [((x - tiled).square().sum() / tiled.square().sum()).sqrt().item()
           for x in (out, control)]
    assert rms[0] <= K1_BF16_TILED_RMS < rms[1], rms


def _module_dtypes(model, x, device_type: str) -> dict:
    """name -> output dtype of every module of ``model`` whose output is a
    tensor, in one forward of ``x`` under ``device_type``'s bf16 autocast."""
    from buctd_tpu_torch.models import autocast

    dtypes = {}

    def record(name):
        def hook(module, args, out):
            if torch.is_tensor(out):
                dtypes[name] = out.dtype
        return hook

    handles = [m.register_forward_hook(record(name)) for name, m in model.named_modules()]
    try:
        with torch.inference_mode(), autocast(device_type, torch.bfloat16):
            model(x)
    finally:
        for handle in handles:
            handle.remove()
    return dtypes


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["coam", "transpose_h"])
def test_cuda_autocast_rounds_where_cpu_autocast_does(cuda, name):
    """A tiny CoAM and a tiny TransPose-H under CUDA and under CPU bf16
    autocast: every module's output dtype the same on both devices (the
    CPU's are JAX's, tests/test_torch_port_eval_bf16.py).  The control puts
    torch's own nn.Upsample back into the fuse layers: CUDA autocast runs
    upsample_nearest2d in f32, so the fuse sums there come out f32 on the
    card only, and the dtypes must differ."""
    import copy

    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.models.hrnet import Upsample

    yaml, opts = ((COAM_YAML, TINY_COAM) if name == "coam"
                  else (TRANSPOSE_YAML, TINY_TRANSPOSE))
    torch.manual_seed(5)
    model = get_model(load_cfg("torch", yaml, opts), device="cpu")
    _randomize(model)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 6, 128, 96).astype(np.float32))
    want = _module_dtypes(model, x, "cpu")
    card = copy.deepcopy(model).to(cuda)
    got = _module_dtypes(card, x.to(cuda), "cuda")
    assert torch.bfloat16 in want.values() and got == want, \
        {k: (got.get(k), want[k]) for k in want if got.get(k) != want[k]}
    ups = [m for m in card.modules() if isinstance(m, Upsample)]
    assert ups
    for m in ups:
        m.__class__ = torch.nn.Upsample
    control = _module_dtypes(card, x.to(cuda), "cuda")
    assert control != want


@pytest.mark.cuda
def test_tf32_operands_compute_cublas_tf32(cuda):
    """A matmul of ``ops/tf32.py::tf32_operand``'s operands, with cuBLAS's
    TF32 off, against cuBLAS's own TF32 matmul of the operands as they are,
    at a shape where cuBLAS takes the tensor cores (64 x 200 x 96): within
    1e-4 of the peak (cuBLAS rounds a tie to even, ``tf32_round`` away from
    zero, and the sums run in another order; measured 5.5e-5 on an H100),
    while the exact product lies further (measured 2.7e-4).  cuBLAS picks
    TF32 by shape (at the colored render's 14 joints it keeps f32); the bf16
    path rounds its warp's and render's operands at every shape."""
    from buctd_tpu_torch.ops.tf32 import tf32_operand

    rng = np.random.RandomState(7)
    a = torch.from_numpy(rng.randn(64, 200).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(200, 96).astype(np.float32)).to(cuda)
    op = tf32_operand(True)
    emulated, exact = op(a) @ op(b), a @ b
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cublas = a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    peak = cublas.abs().max().item()
    gaps = [(x - cublas).abs().max().item() / peak for x in (emulated, exact)]
    assert gaps[0] <= 1e-4 < gaps[1], gaps


RESNET_TINY = ["MODEL.NAME", "pose_resnet", "MODEL.EXTRA.NUM_LAYERS", "18",
               "MODEL.IMAGE_SIZE", "[48, 64]", "MODEL.HEATMAP_SIZE", "[12, 16]",
               "MODEL.EXTRA.NUM_DECONV_FILTERS", "[16, 16, 16]"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pose_resnet_forward_on_cuda_matches_cpu(cuda, dtype):
    """A tiny pose_resnet-18 with the preNet (models/resnet.py: torch's
    ConvTranspose2d deconvolutions) on the card vs the CPU.  f32: within
    1e-4 of the heatmaps' peak (TF32 off).  bf16 autocast: every module's
    output dtype the same on both devices (the deconvolutions bf16), and the
    card's heatmaps no further from the CPU's bf16 ones than twice the CPU's
    bf16 from its own f32."""
    import copy

    from buctd_tpu_torch.models import autocast, get_model
    from test_torch_port_config import REPO

    yaml = REPO / "experiments" / "crowdpose" / "buctd" / "prenet_w48_384x288.yaml"
    torch.manual_seed(7)
    model = get_model(load_cfg("torch", yaml, RESNET_TINY), device="cpu")
    _randomize(model)
    card = copy.deepcopy(model).to(cuda)
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 6, 64, 48).astype(np.float32))
    with torch.inference_mode():
        want32 = model(x)
        if dtype == "float32":
            got = card(x.to(cuda)).cpu()
            assert (got - want32).abs().max() <= 1e-4 * want32.abs().max()
            return
        with autocast("cpu", torch.bfloat16):
            want = model(x).float()
        with autocast(cuda, torch.bfloat16):
            got = card(x.to(cuda)).float().cpu()
    assert _module_dtypes(card, x.to(cuda), cuda.type) == _module_dtypes(model, x, "cpu")
    assert (got - want).abs().max() <= 2 * (want - want32).abs().max()


@pytest.mark.cuda
def test_lambda_step_on_cuda_matches_cpu(cuda):
    """The legacy lambda step (core/function.py::make_validate_lambda_step:
    the whole input mirrored, the lambda head live) of a tiny preNet HRNet on
    the card vs the CPU: predictions within 1e-3 px, maxvals within 1e-4 of
    their peak, the loss within 1e-4 relative."""
    import copy

    from buctd_tpu_torch.core.function import make_validate_lambda_step
    from buctd_tpu_torch.models import get_model
    from test_torch_port_config import REPO

    yaml = REPO / "experiments" / "crowdpose" / "buctd" / "prenet_w48_384x288.yaml"
    cfg = load_cfg("torch", yaml, TINY_COAM)
    torch.manual_seed(9)
    model = get_model(cfg, device="cpu", lambda_head=True)
    _randomize(model)
    rng = np.random.RandomState(10)
    batch = {"input": torch.from_numpy(rng.randn(3, 6, 128, 96).astype(np.float32)),
             "target": torch.from_numpy((rng.rand(3, 14, 32, 24) > 0.99).astype(np.float32)),
             "target_weight": torch.ones(3, 14),
             "center": rng.uniform(80, 200, (3, 2)).astype(np.float32),
             "scale": rng.uniform(0.5, 1.2, (3, 2)).astype(np.float32)}
    lam = torch.tensor([[0.3, 0.7]]).expand(3, 2)
    pairs = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10, 11]]
    want = make_validate_lambda_step(cfg, model, pairs)(batch, lam)
    card = copy.deepcopy(model).to(cuda)
    on_card = {k: (v.to(cuda) if torch.is_tensor(v) else v) for k, v in batch.items()}
    got = [t.cpu() for t in make_validate_lambda_step(cfg, card, pairs)(on_card, lam)]
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-3)
    assert (got[1] - want[1]).abs().max() <= 1e-4 * want[1].abs().max()
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_gpu_nms_equals_cpu_nms(cuda):
    """ops/native.py on the card's machine: the host library builds there
    with its C++ compiler, and the bitmask scan keeps what the greedy scan
    and the numpy NMS keep on 2000 boxes with distinct scores."""
    from buctd_tpu_torch.ops import native
    from buctd_tpu_torch.ops.nms import nms

    del cuda
    rng = np.random.RandomState(11)
    xy = rng.uniform(0, 1000, (2000, 2))
    dets = np.c_[xy, xy + rng.uniform(10, 150, (2000, 2)),
                 rng.permutation(2000) / 2000.0].astype(np.float32)
    for thresh in (0.3, 0.5, 0.7):
        kept = native.cpu_nms(dets, thresh)
        assert native.gpu_nms(dets, thresh) == kept == nms(dets, thresh)
        assert 0 < len(kept) < 2000


def _tiny_crowdpose(root, n_imgs=2, people=2, joints=14, seed=0):
    """A CrowdPose-format set of random 240x320 images, written without JAX
    (the card tests import none); returns the annotation file."""
    import json

    import cv2

    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n_imgs):
        name = f"im{i}.png"
        cv2.imwrite(str(root / name), rng.randint(0, 255, (240, 320, 3), np.uint8))
        images.append({"id": i + 1, "file_name": name, "width": 320, "height": 240,
                       "crowdIndex": 0.5})
        for p in range(people):
            pts = np.stack([rng.uniform(20 + 140 * p, 120 + 140 * p, joints),
                            rng.uniform(30, 190, joints)], 1)
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1,
                         "iscrowd": 0, "num_keypoints": joints,
                         "keypoints": [float(c) for x, y in pts for c in (x, y, 2)],
                         "bbox": [20.0 + 140 * p, 30.0, 110.0, 170.0], "area": 18700.0})
    path = root / "ann.json"
    path.write_text(json.dumps({"images": images, "annotations": anns, "categories": [
        {"id": 1, "name": "person", "keypoints": [f"k{j}" for j in range(joints)],
         "skeleton": []}]}))
    return str(path)


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_host_loader_on_the_card_matches_the_cpu(cuda, tmp_path, train):
    """The host cv2 Loader (TPU.DEVICE_PIPELINE False): the same seed gives the
    same uint8 crops on both devices; the normalised RGB within 1e-5 (the
    same f32 arithmetic), the condition render within 1e-3 (0..255, sums in
    another order) and the targets within 1e-6 (exp on each device)."""
    import random

    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.pipeline import Loader

    ann = _tiny_crowdpose(tmp_path)
    key = "TRAIN" if train else "TEST"
    cfg = load_cfg("torch", COAM_YAML, [
        "MODEL.IMAGE_SIZE", "[96, 128]", "MODEL.HEATMAP_SIZE", "[24, 32]",
        f"DATASET.{key}_IMAGE_DIR", str(tmp_path), f"DATASET.{key}_ANNOTATION_FILE", ann,
        "TEST.USE_GT_BBOX", "True"])
    got = {}
    for dev in ("cpu", "cuda"):
        np.random.seed(7)
        random.seed(7)
        loader = Loader(get_dataset(cfg, is_train=train), cfg, batch_size=4, num_workers=1,
                        device=dev)
        got[dev] = next(iter(loader))
        loader.close()
    host, card = got["cpu"], got["cuda"]
    assert card["input"].device.type == "cuda" and card["input"].shape == (4, 6, 128, 96)
    np.testing.assert_array_equal(card["joints"], host["joints"])
    torch.testing.assert_close(card["input"][:, :3].cpu(), host["input"][:, :3],
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(card["input"][:, 3:].cpu(), host["input"][:, 3:],
                               atol=1e-3, rtol=0)
    torch.testing.assert_close(card["target"].cpu(), host["target"], atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_matmul_warp_engine_on_the_card(cuda):
    """TPU.WARP_ENGINE matmul on the card: against its CPU run and K4's plain
    version within 1e-4 on [0, 1) images (tests/test_torch_port_warp_matmul.py's
    limit; f32 with TF32 off, sums in another order), launching no K4."""
    from buctd_tpu_torch.geometry import make_affine
    from buctd_tpu_torch.ops import warp as tw

    rng = np.random.RandomState(0)
    rots = torch.tensor([0.0, 30.0, -30.0, 60.0, -60.0, 90.0, -90.0])
    imgs = torch.from_numpy(rng.rand(len(rots), 160, 140, 3).astype(np.float32))
    t = make_affine(torch.from_numpy(rng.uniform(60, 80, (len(rots), 2)).astype(np.float32)),
                    torch.from_numpy(rng.uniform(0.5, 0.8, (len(rots), 2)).astype(np.float32)),
                    rots, (96, 128), inv=True)
    before = tw.warp_resample.launches
    got = tw.warp_affine_general(imgs.to(cuda), t.to(cuda), (128, 96), "matmul")
    torch.cuda.synchronize()
    assert tw.warp_resample.launches == before and got.device.type == "cuda"
    cpu = tw.warp_affine_general(imgs, t, (128, 96), "matmul")
    torch.testing.assert_close(got.cpu(), cpu, atol=1e-4, rtol=0)
    plain = tw.warp_affine_reference(imgs.to(cuda), t.to(cuda), (128, 96))
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_replay_equals_eager_refine(cuda, dtype):
    """The tiny estimator's admitted buckets are CUDA graphs (serving.py,
    graphs.py): precompiled at start-up, replayed by predict and
    predict_batch bit for bit equal to ``est.refine`` run eagerly on the same
    padded inputs (the same kernels on the same inputs), each replay
    counting the K1 launches its capture recorded; a call past the budget
    pads up into an admitted graph."""
    from buctd_tpu_torch.buckets import pad_image, pad_rows, to_host
    from buctd_tpu_torch.serving import PoseEstimator

    cfg = load_cfg("torch", opts=TINY_COAM + ["TPU.EVAL_DTYPE", dtype])
    torch.manual_seed(3)
    est = PoseEstimator(cfg, refine_iters=2, max_compiles=2,
                        precompile=[(256, 256, 4), (2, 256, 256, 4)])
    _randomize(est.model)   # in place: the captured graphs read the new weights
    assert sorted(est._graphs.keys()) == [(2, 256, 256, 4), (256, 256, 4)]
    rng = np.random.RandomState(5)
    imgs = [rng.randint(0, 256, (200, 240, 3)).astype(np.uint8) for _ in range(2)]
    conds = [np.concatenate([rng.uniform(40, 180, (3, 14, 2)), np.ones((3, 14, 1))],
                            -1).astype(np.float32) for _ in range(2)]

    def eager(*padded):
        preds, maxvals = est.refine(*(torch.from_numpy(x).to(cuda) for x in padded[:2]),
                                    img_wh=torch.from_numpy(padded[2]).to(cuda))
        return to_host(preds, maxvals)

    before = fa.flash_attention.launches
    got = est.predict(imgs[0], conds[0], float("-inf"))
    got_batch = est.predict_batch(imgs, conds, float("-inf"))
    padded_up = est.predict(imgs[1][:150], conds[1][:2], float("-inf"))   # (256, 256, 2)
    # three replays of two rounds, K1 once a round
    assert fa.flash_attention.launches == before + 3 * 2
    assert est._compiled == {(256, 256, 4), (2, 256, 256, 4)}
    np.testing.assert_array_equal(got, eager(*pad_image(imgs[0], conds[0], 256, 256, 4))[:3])
    want = eager(*pad_rows(list(zip(imgs, conds)), 2, 256, 256, 4))
    for row in range(2):
        np.testing.assert_array_equal(got_batch[row], want[row][:3])
    np.testing.assert_array_equal(
        padded_up, eager(*pad_image(imgs[1][:150], conds[1][:2], 256, 256, 4))[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exported_artifact_on_cuda_matches_live(cuda, dtype, tmp_path):
    """The tiny estimator exported on the card (serving_export.py) and loaded
    there: its programs, replayed as CUDA graphs, launch K1 (the flash
    operator's CUDA kernel) and give the live estimator's poses within
    chip_smoke.py's EXPORT_ATOL, bit for bit expected; a CPU load refuses
    the CUDA artifact."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from buctd_tpu_torch.serving import PoseEstimator
    from buctd_tpu_torch.serving_export import ExportedPoseEstimator

    cfg = load_cfg("torch", opts=TINY_COAM + ["TPU.EVAL_DTYPE", dtype,
                                              "TPU.ATTENTION_ENGINE", "flash"])
    torch.manual_seed(4)
    est = PoseEstimator(cfg, refine_iters=2)
    _randomize(est.model)
    manifest = est.export([(256, 256, 4), (2, 256, 256, 4)], str(tmp_path))
    assert manifest["platforms"] == ["cuda"] and manifest["eval_dtype"] == dtype
    art = ExportedPoseEstimator(str(tmp_path))
    rng = np.random.RandomState(6)
    imgs = [rng.randint(0, 256, (200, 240, 3)).astype(np.uint8) for _ in range(2)]
    conds = [rng.uniform(40, 180, (3, 14, 2)).astype(np.float32) for _ in range(2)]
    got = [art.predict(imgs[0], conds[0], float("-inf")),
           *art.predict_batch(imgs, conds, float("-inf"))]
    want = [est.predict(imgs[0], conds[0], float("-inf")),
            *est.predict_batch(imgs, conds, float("-inf"))]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        art.predict(imgs[0], conds[0], float("-inf"))
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernel = "flash_fwd_tf32_wgmma_kernel" if dtype == "float32" else "flash_fwd_wgmma_kernel"
    assert any(kernel in n for n in names), names
    with pytest.raises(ValueError, match="exported for"):
        ExportedPoseEstimator(str(tmp_path), device="cpu")


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_card(cuda):
    """K1, K2 and K4 on tensors of the second card while the first is
    current: each wrapper launches under its tensor's device (a launch on
    the current card would read another card's pointers), and the results
    equal the plain versions on that card.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: only there can a tensor's card differ from the "
                    "current one (ROADMAP Queue 2, the multi-card leads)")
    from buctd_tpu_torch.ops import warp as tw

    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.requires_grad_(True) for t in _qkv(2, 256, 256, 48, dtype, other))
        out, lse = fa.flash_attention(q, k, v, 48 ** -0.5)
        assert out.device == other and torch.cuda.current_device() == 0
        _assert_fwd_close((out, lse), fa.flash_attention_reference(q, k, v, 48 ** -0.5), dtype)
    q, k, v = (t.detach().requires_grad_(True) for t in _qkv(2, 256, 256, 48,
                                                             torch.float32, other))
    do = torch.randn(2, 256, 48, device=other)
    grads = torch.autograd.grad(fa.flash_attention_train(q, k, v, 48 ** -0.5, 0.0, 0), (q, k, v),
                                do)
    ref = torch.autograd.grad(fa.flash_attention_reference(q, k, v, 48 ** -0.5)[0], (q, k, v), do)
    _assert_grads_close(grads, ref)
    images = torch.rand(2, 64, 80, 3, device=other)
    trans = torch.tensor([[[1.2, 0.1, 3.0], [-0.1, 1.1, 2.0]]] * 2, device=other)
    before = tw.warp_resample.launches
    torch.testing.assert_close(tw.warp_affine_general(images, trans, (40, 30)),
                               tw.warp_affine_reference(images, trans, (40, 30)),
                               atol=1e-4, rtol=0)
    assert tw.warp_resample.launches == before + 1


@pytest.mark.cuda
def test_mesh_estimator_with_two_replicas_on_one_card(cuda, tmp_path):
    """``PoseEstimator(mesh=)`` with two replicas on the one card: each its
    own graph pool, predict_batch equal to the one-device estimator's."""
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.parallel import make_mesh
    from buctd_tpu_torch.serving import PoseEstimator

    cfg = load_cfg("torch", opts=TINY_COAM + ["TPU.ATTENTION_ENGINE", "flash"])
    torch.manual_seed(4)
    model = get_model(cfg)
    _randomize(model)
    torch.save(model.state_dict(), tmp_path / "model.pth")
    single = PoseEstimator(cfg, checkpoint=str(tmp_path / "model.pth"), refine_iters=2)
    est = PoseEstimator(cfg, checkpoint=str(tmp_path / "model.pth"), refine_iters=2,
                        mesh=make_mesh(devices=[cuda, cuda]))
    rng = np.random.RandomState(7)
    imgs = [rng.randint(0, 256, (200, 240, 3)).astype(np.uint8) for _ in range(4)]
    conds = [rng.uniform(40, 180, (3, 14, 2)).astype(np.float32) for _ in range(4)]
    for g, w in zip(est.predict_batch(imgs, conds, float("-inf")),
                    single.predict_batch(imgs, conds, float("-inf"))):
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)
    assert est._replicas[0][1] is not est._replicas[1][1]
    assert est._replicas[1][1].keys() == [(2, 256, 256, 4)]      # 4 rows, 2 a replica
