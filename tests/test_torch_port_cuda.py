"""buctd_tpu_torch on the card: the CUDA kernel vs its plain version, the
wrapper's refusals, and the tiny estimator on CUDA vs on the CPU.

Every test is marked ``cuda`` and skips itself where torch.cuda.is_available()
is false.  The file imports no JAX, so it also runs on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

Tolerances: kernel vs plain 2e-5 absolute and relative (both sum in f32, in
another order, over up to 700 keys); estimator card vs CPU 1e-3 px and 1e-3 in
confidence (f32 convs with TF32 off, summed in another order).
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
    from torch import nn

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.1)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)


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
