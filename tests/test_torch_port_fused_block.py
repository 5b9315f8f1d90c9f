"""buctd_tpu_torch fused basic block (K5) on the CPU: the plain version
against the JAX Pallas kernel in interpret mode (as tests/test_pallas_block.py
runs it) at that file's three shapes and in bf16, and fold_bn plus the plain
block against the port's eval BasicBlock with random BN statistics.

Tolerances: f32 atol 5e-5, rtol 1e-4 (tests/test_pallas_block.py's: two 3x3
convs summed in another order).  bf16: equal up to one bf16 step of the
output, 2^-7 relative (products of bf16 values are exact in f32 on both
sides; an f32 sum in another order can round the intermediate or the output
one step apart).  The module check: 1e-5 of the output's max (a float64 fold
cast to f32 against the unfolded f32 BatchNorm).  The CUDA kernel is held
against the plain version on the card by tests/test_torch_port_cuda.py and
chip_smoke.py.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import fused_block as fb


def _operands(b, h, w, c, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, w, c), rng.randn(3, 3, c, c) * 0.1, rng.randn(3, 3, c, c) * 0.1,
            rng.randn(c) * 0.1, rng.randn(c) * 0.1]


@pytest.mark.parametrize("b,h,w,c,dtype", [
    (3, 12, 9, 16, "float32"),    # width not a multiple of 8
    (4, 8, 8, 8, "float32"),
    (2, 6, 16, 4, "float32"),
    (3, 12, 9, 16, "bfloat16"),
])
def test_plain_block_matches_pallas_kernel(b, h, w, c, dtype):
    from buctd_tpu.ops.pallas_block import fused_basic_block as jax_block

    ops = _operands(b, h, w, c)
    want = np.asarray(jax_block(*[jnp.asarray(a, getattr(jnp, dtype)) for a in ops],
                                interpret=True).astype(jnp.float32))
    tdtype = getattr(torch, dtype)
    before = fb.fused_basic_block.launches
    got = fb.fused_basic_block(*[torch.from_numpy(a.astype(np.float32)).to(tdtype)
                                 for a in ops])
    assert fb.fused_basic_block.launches == before          # CPU calls do not count
    assert got.dtype == tdtype and got.shape == (b, h, w, c)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -7, rtol=2 ** -7)


def test_fold_bn_and_plain_block_match_eval_basic_block():
    from buctd_tpu_torch.models.fuse import fold_bn
    from buctd_tpu_torch.models.hrnet import BasicBlock

    torch.manual_seed(0)
    block = BasicBlock(12, 12).eval()
    with torch.no_grad():
        for bn in (block.bn1, block.bn2):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0.0, 0.1)
            bn.running_mean.normal_(0.0, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    x = torch.randn(2, 12, 10, 7)                            # NCHW
    with torch.no_grad():
        want = block(x)
        w1, b1 = fold_bn(block.conv1, block.bn1)
        w2, b2 = fold_bn(block.conv2, block.bn2)
        hwio = [w.permute(2, 3, 1, 0) for w in (w1, w2)]     # OIHW -> HWIO
        got = fb.fused_basic_block(x.permute(0, 2, 3, 1), hwio[0], hwio[1], b1, b2)
    got = got.permute(0, 3, 1, 2)
    assert torch.abs(got - want).max() <= 1e-5 * torch.abs(want).max()


def test_wrapper_refusals():
    x = torch.zeros(1, 4, 4, 8)
    w, b = torch.zeros(3, 3, 8, 8), torch.zeros(8)
    with pytest.raises(ValueError):
        fb.fused_basic_block(x, w[:, :, :4], w, b, b)
    with pytest.raises(TypeError):
        fb.fused_basic_block(x.double(), w.double(), w.double(), b.double(), b.double())
    with pytest.raises(TypeError):
        fb.fused_basic_block(x, w.bfloat16(), w, b, b)
