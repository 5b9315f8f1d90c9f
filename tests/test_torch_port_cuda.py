"""buctd_tpu_torch on the card: the CUDA kernel vs its plain version, the
wrapper's refusals, and the tiny estimator on CUDA vs on the CPU.

Every test is marked ``cuda`` and skips itself where torch.cuda.is_available()
is false.  The file imports no JAX, so it also runs on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

Tolerances: kernel vs plain 2e-5 absolute and relative (both sum in f32, in
another order, over up to 700 keys); estimator card vs CPU 1e-3 px and 1e-3 in
confidence (f32 convs with TF32 off, summed in another order).  The backward
kernels (K2) vs the plain backward: 1e-4 absolute and relative (dq, dk, dv sum
products of a recomputed p over up to 700 keys or rows).  The warp (K4) vs its
plain version: 1e-4 on [0, 1) images (two tent taps against the dense sum).
The fused basic block (K5) vs its plain version: f32 atol = rtol = 2e-5, bf16
2^-6 (an f32 sum in another order can round the intermediate or the output
one bf16 step apart); exp throughput (K6) rtol 1e-5 (expf/exp2f in f32, a few ulps); a
full-width preNet-W48 forward, fused or not, card vs CPU within 1e-4 of the
heatmaps' peak.
"""

import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import flash_attention as fa
from test_torch_port_config import TINY_COAM, load_cfg

SHAPES = [(2, 256, 256, 48), (1, 300, 300, 112), (3, 640, 384, 96), (1, 128, 700, 64)]


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
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, d ** -0.5)
    torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)


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
    # branch 1's 192 tokens take the batched matmul
    assert fa.flash_attention.launches == before + 3
    want = est_cpu.predict(img, conds, float("-inf"))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bh,lq,lk,d", SHAPES)
def test_forward_and_backward_kernels_match_plain(cuda, bh, lq, lk, d, dtype, dropout):
    q, k, v = _qkv(bh, lq, lk, d, dtype, cuda)
    scale, seed = d ** -0.5, 99
    out, lse = fa.flash_attention(q, k, v, scale, dropout, seed)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, scale, dropout, seed)
    torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
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
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


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
    assert tw.warp_resample.launches == before + 2
    want = tw.warp_affine_reference(imgs, t, (128, 96))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# K1'/K2' (the kv-resident kernels): the test shapes, and two whose head dim is
# no multiple of 16 (the rings' padded columns; copies of 16, 8 and 4 bytes)
KVRES_SHAPES = SHAPES + [(2, 100, 130, 40), (1, 70, 90, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bh,lq,lk,d", KVRES_SHAPES)
def test_kvres_kernels_match_plain_and_k1_k2(cuda, monkeypatch, bh, lq, lk, d, dtype,
                                             dropout):
    """K1' and K2' vs the plain versions (the same tolerances as K1/K2) and vs
    K1/K2 on the same inputs."""
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
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, scale, dropout, seed)
    torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
    want = fa.flash_attention_backward_reference(q, k, v, dout, lse, delta, scale,
                                                 dropout, seed)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    k1_out, k1_lse = fa.flash_attention(q, k, v, scale, dropout, seed)
    torch.testing.assert_close(out, k1_out, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, k1_lse, atol=2e-5, rtol=2e-5)
    k2 = (fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, dropout, seed),
          *fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, dropout, seed))
    for got, ref in zip((dq, dk, dv), k2):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kvres_switch_routes_cuda_tensors(cuda, monkeypatch):
    """BUCTD_FLASH_KVRES=1: flash_attention and the training backward launch
    K1' and K2' only; unaligned rows raise instead of taking K1."""
    monkeypatch.setenv("BUCTD_FLASH_KVRES", "1")
    q, k, v = (x.requires_grad_() for x in _qkv(2, 300, 200, 48, torch.float32, cuda))
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                fa.flash_attention_kvres, fa.flash_bwd_dq_kvres, fa.flash_bwd_dkv_kvres)
    before = [f.launches for f in counters]
    out = fa.flash_attention_train(q, k, v, 0.2, 0.1, 7)
    out.sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [0, 0, 0, 1, 1, 1]
    odd = _qkv(1, 16, 16, 7, torch.bfloat16, cuda)   # 14-byte rows
    with pytest.raises(ValueError, match="4-byte"):
        fa.flash_attention(*odd, 0.3)
    assert fa.flash_attention.launches == before[0]


# K5 (fused basic block): f32 and bf16, W not a multiple of 8, C = 384, and a
# C no chunk divides; tolerances as chip_smoke.py's (K5_ATOL)
K5_SHAPES = [(2, 12, 9, 16), (2, 24, 18, 192), (1, 12, 9, 384), (3, 13, 11, 40)]
K5_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,c", K5_SHAPES)
def test_fused_block_kernel_matches_plain(cuda, b, h, w, c, dtype):
    from buctd_tpu_torch.ops import fused_block as fb

    gen = torch.Generator(cuda).manual_seed(c)
    x = torch.randn(b, h, w, c, device=cuda, generator=gen)
    ws = [torch.randn(3, 3, c, c, device=cuda, generator=gen) / (3 * c ** 0.5) for _ in range(2)]
    bs = [torch.randn(c, device=cuda, generator=gen) * 0.1 for _ in range(2)]
    args = [t.to(dtype) for t in (x, *ws, *bs)]
    before = fb.fused_basic_block.launches
    got = fb.fused_basic_block(*args)
    torch.cuda.synchronize()
    assert fb.fused_basic_block.launches == before + 1 and got.dtype == dtype
    want = fb.fused_basic_block_plain(*args)
    tol = K5_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


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
