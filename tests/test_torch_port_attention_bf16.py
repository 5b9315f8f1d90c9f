"""buctd_tpu_torch attention modules under bf16 autocast vs JAX's bf16 modules.

JAX takes the attention logits and att @ v in f32 from bf16 operands
(``preferred_element_type=jnp.float32``, buctd_tpu/models/attention.py:85,
:192-197); the port computes both products with autocast off on the operands
widened to f32 (exact products, f32 sums).  Before that, autocast ran them in
bf16 and rounded the logits: the ``pre_fix`` fixture restores that computation (autocast
left on around the products) so each test shows that its tolerance tells the
two apart.

Tolerance, both tests: 1e-2 x the largest |output|.  With the same bf16
inputs the logits agree to f32 sums in another order, and each module's bf16
output linear rounds as JAX's does (the product to bf16, then the bf16 bias
added: models/hrnet.py::Linear), so outputs land at most a step or two
(2^-8 relative each) apart (measured <= 6.0e-3 of the max on the channel
module's inputs, <= 1.4e-3 on the model's calls).  The pre-fix computation
misses by 3.8e-2 to 2.0e-1 on the module's inputs and by 1.2e-1 on the
model's worst call.

* The CoAM channel attention module (``SimplifiedScaledDotProductAttention``)
  at three token widths, on queries and keys that share a component (channels
  of one feature map correlate), so that many logits are large and close.
* The tiny CoAM forward: every attention call of the model's forward under
  autocast (the channel and position attention modules of stage2_att at each
  of its three branches, on the activations the model gives them, with a condition render
  of 0..255 values as the data pipeline makes it), each held against JAX's
  module built with dtype=bfloat16 and the same weights on the same bf16
  inputs.  The whole model's heatmaps cannot tell this fix:
  tests/test_torch_port_bf16_trunk.py holds them against JAX's bf16 model,
  module by module and whole.  Every module of the trunk and the CoAM block
  rounds as JAX's does on the same inputs, and the whole model's remaining
  gap (1.5e-2 to 4.8e-2 of the max in eval) is sub-step differences
  compounded through the trunk and amplified by the CoAM attention, as far as
  the port's bf16 model is from its own f32 model.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch.models import attention
from test_torch_port_config import TINY_COAM, jax_variables, load_cfg, port_model

RTOL = 1e-2


@pytest.fixture
def pre_fix(monkeypatch):
    """Switch the port back to its pre-fix computation: autocast stays on
    around the attention products."""
    def apply():
        monkeypatch.setattr(attention, "_no_autocast", lambda x: contextlib.nullcontext())
    return apply


def _autocast():
    return torch.autocast("cpu", dtype=torch.bfloat16)


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("b,n,hw", [(2, 8, 768), (2, 16, 192), (1, 48, 6912)])
def test_channel_attention_matches_jax_bf16(pre_fix, b, n, hw):
    from buctd_tpu.models.attention import SimplifiedScaledDotProductAttention as JaxSSDPA

    rng = np.random.RandomState(hw)
    shared = rng.randn(1, 1, hw)
    q, k, v = (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16) for x in (
        shared + 0.3 * rng.randn(b, n, hw), shared + 0.3 * rng.randn(b, n, hw),
        rng.randn(b, n, hw)))
    w = (rng.randn(hw, hw) / np.sqrt(hw)).astype(np.float32)
    bias = (0.1 * rng.randn(hw)).astype(np.float32)
    want = np.asarray(JaxSSDPA(d_model=hw, h=1, dtype=jnp.bfloat16).apply(
        {"params": {"fc_o": {"kernel": w, "bias": bias}}}, _jax(q), _jax(k), _jax(v))
        .astype(jnp.float32))
    module = attention.SimplifiedScaledDotProductAttention(hw, 1).eval()
    with torch.no_grad():
        module.fc_o.weight.copy_(torch.from_numpy(w.T))
        module.fc_o.bias.copy_(torch.from_numpy(bias))

    def run():
        with torch.no_grad(), _autocast():
            return module(q, k, v).float().numpy()

    assert _rel(run(), want) <= RTOL
    pre_fix()
    assert _rel(run(), want) > 2 * RTOL


def _jax_params(variables, name):
    """The JAX params of the port module ``name`` (stage2_att.att_layers.0.pa
    -> _trunk / stage2_att / att_layers.0 / pa)."""
    node, parts = variables["params"]["_trunk"], name.split(".")
    while parts:
        key = parts.pop(0)
        if key == "att_layers":
            key = f"att_layers.{parts.pop(0)}"
        node = node[key]
    return node


def test_tiny_coam_attention_calls_match_jax_bf16(pre_fix):
    from buctd_tpu.models import attention as jax_attention

    cfg = load_cfg("jax", opts=TINY_COAM)
    _, variables = jax_variables(cfg, seed=1)
    port = port_model(load_cfg("torch", opts=TINY_COAM), variables)
    calls = []
    for name, m in port.named_modules():
        if isinstance(m, (attention.ScaledDotProductAttention,
                          attention.SimplifiedScaledDotProductAttention)):
            m.register_forward_hook(lambda mod, args, out, name=name: calls.append(
                (name, mod, args, out.float().numpy())))
    img_w, img_h = cfg.MODEL.IMAGE_SIZE
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(2, 3, img_h, img_w),
                        rng.uniform(0, 255, (2, 3, img_h, img_w))], 1).astype(np.float32)

    def run():
        calls.clear()
        with torch.inference_mode(), _autocast():
            heatmaps = port(torch.from_numpy(x))
        assert heatmaps.shape == (2, 14, 32, 24) and torch.isfinite(heatmaps).all()
        worst = 0.0
        for name, mod, args, got in calls:
            assert all(a.dtype == torch.bfloat16 for a in args), name
            if isinstance(mod, attention.SimplifiedScaledDotProductAttention):
                jm = jax_attention.SimplifiedScaledDotProductAttention(
                    d_model=mod.d_model, h=mod.h, dtype=jnp.bfloat16)
            else:
                jm = jax_attention.ScaledDotProductAttention(
                    in_dim_k=mod.fc_o.out_features, d_k=mod.d_k, d_v=mod.d_v, h=mod.h,
                    dtype=jnp.bfloat16)
            want = jm.apply({"params": _jax_params(variables, name)},
                            *(_jax(a) for a in args))
            worst = max(worst, _rel(got, np.asarray(want.astype(jnp.float32))))
        assert len(calls) == 6   # channel and position attention at 3 branches
        return worst

    assert run() <= RTOL
    pre_fix()
    assert run() > 2 * RTOL
