"""buctd_tpu_torch under BUCTD_FLASH_KVRES vs the JAX kv-resident kernels.

With the switch on, buctd_tpu routes every flash call to ``_fwd_kernel_kvres``
(K1') and ``_dq_kernel_kvres`` / ``_dkv_kernel_kvres`` (K2'); here they run in
interpret mode, as tests/test_flash_attention.py:68-94 runs them, at its three
shapes.  The port's dispatch under the same switch gives CPU tensors the plain
versions (K1' and K2' compute K1's and K2's functions), so this holds the
plain versions, forward and through ``flash_attention_train``'s backward,
against the JAX kernels: forward atol = rtol = 2e-5 (f32 sums over at most
700 keys), gradients atol 5e-4, rtol 1e-3 (the tolerance of the JAX test).
The CUDA kernels are held against the plain versions and against K1/K2 (bit
for bit: K1' and K2' are K1's and K2's kernels with a deeper ring) by
tests/test_torch_port_cuda.py (marked ``cuda``) and chip_smoke.py.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import flash_attention as fa


@pytest.mark.parametrize("bh,lq,lk,d", [
    (2, 256, 256, 48),      # aligned
    (1, 300, 384, 112),     # padded q tail, cross lengths
    (1, 128, 700, 64),      # padded kv tail (masked sub-tile)
])
def test_kvres_dispatch_matches_jax_kvres_kernels(monkeypatch, bh, lq, lk, d):
    from buctd_tpu.ops.flash_attention import flash_attention as jax_flash

    monkeypatch.setenv("BUCTD_FLASH_KVRES", "1")
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(bh, n, d).astype(np.float32) for n in (lq, lk, lk))
    g = rng.randn(bh, lq, d).astype(np.float32)
    scale = 1.0 / np.sqrt(d)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention_train(tq, tk, tv, scale)
    (out * torch.from_numpy(g)).sum().backward()
    out_plain, _ = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), scale)

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, 0, scale, 0.0, True) * g)

    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, scale, 0.0, True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out_plain.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    want_g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want_g, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4, rtol=1e-3,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("value,on", [(None, False), ("0", False), ("1", True),
                                      ("yes", True), ("", True)])
def test_kvres_switch_follows_the_jax_rule(monkeypatch, value, on):
    """Unset or "0" is off; any other value, even an empty one, is on
    (buctd_tpu/ops/flash_attention.py:474, :684).  CPU tensors take the plain
    versions either way and count no launch."""
    if value is None:
        monkeypatch.delenv("BUCTD_FLASH_KVRES", raising=False)
    else:
        monkeypatch.setenv("BUCTD_FLASH_KVRES", value)
    assert fa.kvres_enabled() is on
    q = torch.from_numpy(np.random.RandomState(0).randn(1, 16, 8).astype(np.float32))
    before = (fa.flash_attention.launches, fa.flash_attention_kvres.launches)
    fa.flash_attention(q, q, q, 0.3)
    assert (fa.flash_attention.launches, fa.flash_attention_kvres.launches) == before


def test_kvres_wrappers_refuse_cpu_tensors():
    """The K1'/K2' wrappers are the CUDA kernels: CPU tensors raise (the
    dispatch gives them the plain versions instead)."""
    q = torch.zeros(1, 16, 8)
    lse = torch.zeros(1, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attention_kvres(q, q, q, 0.3)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_bwd_dq_kvres(q, q, q, q, lse, lse, 0.3)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_bwd_dkv_kvres(q, q, q, q, lse, lse, 0.3)


def test_copy_guard_refuses_rows_not_4_byte_aligned():
    """The f32 K2 and K2' kernels (the same 3xTF32 kernels) read their
    operands' rows in 4-byte units, by 16-byte cp.async copies where the rows
    allow and else through registers; their wrappers refuse rows whose bytes
    or start are not a multiple of 4 (the bf16 ones read such rows through
    registers and skip the guard)."""
    fa._check_copyable(torch.zeros(1, 16, 7), torch.zeros(1, 16, 2, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="4-byte"):
        fa._check_copyable(torch.zeros(1, 16, 7, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="4-byte"):
        fa._check_copyable(torch.zeros(1, 16, 8, dtype=torch.bfloat16)[..., 1:7])
