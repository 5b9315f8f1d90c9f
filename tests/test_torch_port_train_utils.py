"""buctd_tpu_torch's training utilities vs buctd_tpu's, on the CPU.

* ``GaussianSmoothing`` and ``gaussian_kernel1d`` against JAX's on the same
  inputs: the kernel to 1e-7 (the same float64 formula, cast to f32), the
  smoothed maps to 1e-6 (the same f32 taps, summed in the same order);
* ``MetricWriter``: the same jsonl rows as JAX's writer (tag, value, step;
  per-tag step counters from 0, an explicit step kept), and ``create_logger``
  the same output layout (``{OUTPUT_DIR}/{dataset}/{model}/{cfg_name}``, the
  timestamped log file, the tensorboard directory under ``LOG_DIR``);
* ``trace_context`` writes a Chrome trace on the CPU, under
  ``BUCTD_PROFILE_DIR`` or its ``log_dir``, with ``annotate``'s span in it,
  and nothing without either; ``StepTimer`` calls its fence;
* ``utils/summary.py``: the parameter count equals JAX's for the tiny CoAM,
  and its FLOPs equal an analytic count of the tiny model's convolutions,
  linears and attention products (2 * MACs each, from forward hooks);
  ``mfu_string`` rates against the H100's bf16 peak.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import json
import logging
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_config import COAM_YAML, TINY_COAM, jax_variables, load_cfg


@pytest.mark.parametrize("ksize,sigma", [(11, 6.0), (5, 1.0), (7, 2.5)])
def test_gaussian_smoothing_matches_jax(ksize, sigma):
    from buctd_tpu.utils.gaussian import GaussianSmoothing as JaxSmoothing
    from buctd_tpu.utils.gaussian import gaussian_kernel1d as jax_kernel
    from buctd_tpu_torch.utils.gaussian import GaussianSmoothing, gaussian_kernel1d

    np.testing.assert_allclose(gaussian_kernel1d(ksize, sigma), jax_kernel(ksize, sigma),
                               atol=1e-7, rtol=0)
    x = np.random.RandomState(ksize).rand(2, 32, 24, 5).astype(np.float32)
    got = GaussianSmoothing(5, ksize, sigma)(torch.from_numpy(x))
    want = np.asarray(JaxSmoothing(5, ksize, sigma)(jnp.asarray(x)))
    assert got.shape == (2, 32, 24, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        GaussianSmoothing(5, ksize, sigma, dim=3)


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_metric_writer_matches_jax(tmp_path):
    from buctd_tpu.utils.logging_utils import MetricWriter as JaxWriter
    from buctd_tpu_torch.utils.logging_utils import MetricWriter

    calls = [("train_loss", 0.5, None), ("train_acc", 0.25, None), ("train_loss", 0.4, None),
             ("valid_AP", 0.125, 7), ("train_loss", np.float32(0.3), None)]
    for name, cls in (("ours", MetricWriter), ("jax", JaxWriter)):
        (tmp_path / name).mkdir()
        w = cls(str(tmp_path / name))
        for tag, value, step in calls:
            w.add_scalar(tag, value, step)
        w.close()
    got, want = _rows(tmp_path / "ours" / "metrics.jsonl"), _rows(tmp_path / "jax" / "metrics.jsonl")
    assert [sorted(r) for r in got] == [["step", "tag", "ts", "value"]] * len(calls)
    assert [{k: r[k] for k in ("tag", "value", "step")} for r in got] == \
        [{k: r[k] for k in ("tag", "value", "step")} for r in want]
    assert [r["step"] for r in got if r["tag"] == "train_loss"] == [0, 1, 2]
    assert all(isinstance(r["ts"], float) for r in got)


def test_create_logger_layout_matches_jax(tmp_path):
    from buctd_tpu.utils.logging_utils import create_logger as jax_create_logger
    from buctd_tpu_torch.utils.logging_utils import create_logger

    root = logging.getLogger()
    before = list(root.handlers)
    opts = ["OUTPUT_DIR", str(tmp_path / "out"), "LOG_DIR", str(tmp_path / "log")]
    try:
        _, out, tb = create_logger(load_cfg("torch", COAM_YAML, opts), str(COAM_YAML), "train")
        _, jout, jtb = jax_create_logger(load_cfg("jax", COAM_YAML, opts), str(COAM_YAML),
                                         "train")
        assert out == jout == str(tmp_path / "out" / "crowdpose" / "pose_hrnet_coam"
                                  / "coam_w48_384x288")
        assert tb.rsplit("_", 1)[0] == jtb.rsplit("_", 1)[0]
        logs = sorted(p.name for p in (tmp_path / "out" / "crowdpose" / "pose_hrnet_coam"
                                       / "coam_w48_384x288").glob("*.log"))
        assert logs and all(n.startswith("coam_w48_384x288_") and n.endswith("_train.log")
                            for n in logs)
        # a second call replaces the first one's handlers
        ours = [h for h in root.handlers if getattr(h, "_buctd_logger", False)]
        create_logger(load_cfg("torch", COAM_YAML, opts), str(COAM_YAML), "valid")
        again = [h for h in root.handlers if getattr(h, "_buctd_logger", False)]
        assert len(again) == len(ours) == 2 and not set(again) & set(ours)
    finally:
        for h in [h for h in root.handlers if h not in before]:
            root.removeHandler(h)
            h.close()


def test_trace_context_writes_a_chrome_trace(tmp_path, monkeypatch):
    from buctd_tpu_torch.utils.profiler import StepTimer, annotate, trace_context

    monkeypatch.delenv("BUCTD_PROFILE_DIR", raising=False)
    with trace_context() as prof:
        assert prof is None
    for where in ("env", "arg"):
        out = tmp_path / where
        if where == "env":
            monkeypatch.setenv("BUCTD_PROFILE_DIR", str(out))
        with trace_context(None if where == "env" else str(out)) as prof:
            assert prof is not None
            with annotate("buctd_span"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        traces = list(out.glob("trace_*.json"))
        assert len(traces) == 1
        events = json.loads(traces[0].read_text())["traceEvents"]
        assert any(e.get("name") == "buctd_span" for e in events)
    fenced = []
    timer = StepTimer()
    timer.start()
    assert timer.stop(lambda: fenced.append(1)) >= 0 and fenced == [1]
    assert timer.mean == timer.times[0]


def _analytic_flops(model, x) -> float:
    """2 * MACs of every convolution and linear, and 4 * B*h*nq*nk*d of
    every attention module's two products, from forward hooks."""
    from buctd_tpu_torch.models.attention import (ScaledDotProductAttention,
                                                  SimplifiedScaledDotProductAttention)

    total = [0.0]

    def conv(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
        total[0] += 2.0 * out.numel() * k

    def linear(m, inp, out):
        total[0] += 2.0 * out.numel() * m.in_features

    def attention(m, inp, out):
        q, k = inp[0], inp[1]
        if isinstance(m, ScaledDotProductAttention):
            d = m.h * m.d_k              # q k^T over d_k, att v over d_v (= d_k here)
        else:
            d = m.d_model
        total[0] += 4.0 * q.shape[0] * q.shape[1] * k.shape[1] * d

    hooks = []
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(linear))
        elif isinstance(m, (ScaledDotProductAttention, SimplifiedScaledDotProductAttention)):
            hooks.append(m.register_forward_hook(attention))
    try:
        with torch.inference_mode():
            model.eval()(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def test_model_summary_counts_params_as_jax_and_flops_analytically():
    import jax

    from buctd_tpu_torch.utils import summary
    from test_torch_port_config import port_model

    cfg, jcfg = load_cfg("torch", opts=TINY_COAM), load_cfg("jax", opts=TINY_COAM)
    _, variables = jax_variables(jcfg, seed=1)
    model = port_model(cfg, variables)
    model.train()
    shape = (1, 6, 128, 96)
    s = summary.model_summary(model, shape)
    assert model.training                                   # restored
    assert s["params"] == sum(x.size for x in jax.tree.leaves(variables["params"]))
    assert s["flash_calls"] == 0                            # the CPU takes no kernel
    want = _analytic_flops(model, torch.zeros(shape))
    assert want > 0 and s["flops"] == pytest.approx(want, rel=1e-9)
    assert f"Total parameters: {s['params']:,}" in s["text"]
    assert f"Forward FLOPs: {s['flops'] / 1e9:.2f} GFLOPs" in summary.get_model_summary(model,
                                                                                        shape)
    # K1's products: 4 * BH * Lq * Lk * d per recorded CUDA call
    assert summary.H100_BF16_PEAK == 989e12
    mfu = summary.mfu_string(lambda x: x @ x, (torch.ones(64, 64),), 1e-6)
    flops = 2 * 64 ** 3
    assert mfu == (f"  {flops / 1e12:.2f} TF -> MFU "
                   f"{flops / 1e-6 / 989e12 * 100:.1f}%")
    assert math.isclose(summary.compiled_flops(lambda x: x @ x, torch.ones(8, 8)), 2 * 8 ** 3)
