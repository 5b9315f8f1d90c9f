"""buctd_tpu_torch pose_resnet (models/resnet.py) vs buctd_tpu's, on the CPU
at tiny widths: ResNet-18 (BASIC) and ResNet-50 (BOTTLENECK) with the preNet
yaml's 14 joints, 64x48 inputs and 16-channel deconvolutions.

Weights are N(0, 1/fan_in) with BN statistics away from the identity
(test_torch_port_config.jax_variables), carried across by convert.from_flax.
Tolerances: heatmaps (values O(1-10)) within 1e-5 of their max in f32 (f32
convs summed in another order: measured 2e-6); the fused preNet
(``FusedPreNet(first_kernel=7)``) against JAX's fused model at the same
gate; a train-mode forward's heatmaps and BN running statistics within 1e-4
of their max against JAX's in float64 (flax's f32 batch variance,
E[x^2] - E[x]^2, cancels at the deep 2x2 maps: at ResNet-50 the port's f32
heatmaps lay 3.5e-4 of the max from JAX's f32 ones); ``Deconv`` alone at
1e-5 of its max.

bf16: JAX's bf16 PoseResNet cannot run (its ``Deconv``, resnet.py:49 there,
hands ``lax.conv_general_dilated`` a bf16 input and its f32 kernel and
raises; the test asserts it still does).  The port's deconvolutions run in
bf16 under autocast, which is JAX's Deconv with its kernel in the input's
dtype, as flax's own bf16 convs promote it.  With that one repair patched in
here (the JAX package stays as it is), every module of the port's autocast
forward returns JAX's dtype, and the heatmaps lie within
test_torch_port_bf16_trunk.py's whole-model tolerance in bf16 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from test_torch_port_bf16_trunk import MODEL_TOL_STEPS
from test_torch_port_config import REPO, jax_variables, load_cfg, port_model

PRENET_YAML = REPO / "experiments" / "crowdpose" / "buctd" / "prenet_w48_384x288.yaml"
FWD_RTOL = 1e-5
TRAIN_RTOL = 1e-4
STEP = 2.0 ** -8


def tiny(layers: int, prenet: bool = True, *extra):
    return ["MODEL.NAME", "pose_resnet", "MODEL.EXTRA.NUM_LAYERS", str(layers),
            "MODEL.IMAGE_SIZE", "[48, 64]", "MODEL.HEATMAP_SIZE", "[12, 16]",
            "MODEL.EXTRA.NUM_DECONV_FILTERS", "[16, 16, 16]",
            "MODEL.EXTRA.USE_PRE_NET", str(prenet), *extra]


def _input(seed=0, n=2):
    return np.random.RandomState(seed).randn(n, 64, 48, 6).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).detach().numpy()


def _pair(layers, prenet=True, seed=1, *extra):
    opts = tiny(layers, prenet, *extra)
    jcfg, tcfg = load_cfg("jax", PRENET_YAML, opts), load_cfg("torch", PRENET_YAML, opts)
    model, variables = jax_variables(jcfg, seed=seed)
    return jcfg, tcfg, model, variables, port_model(tcfg, variables)


CASES = [(18, True), (50, True), (18, False), (50, False)]


@pytest.mark.parametrize("layers,prenet", CASES,
                         ids=[f"r{n}_{'prenet' if p else 'plain'}" for n, p in CASES])
def test_eval_forward_matches_jax(layers, prenet):
    _, _, model, variables, port = _pair(layers, prenet)
    x = _input()
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == want.shape == (2, 16, 16, 14)   # 48 wide: 24, 12, 6, 3, 2 -> x8
    peak = np.abs(want).max()
    assert peak > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_RTOL * peak)


@pytest.mark.parametrize("layers", [18, 50])
def test_fused_prenet_matches_jax(layers):
    """The preNet folded into FusedPreNet(first_kernel=7) on both sides:
    the fused weights bit for bit (the same float64 fold cast to f32), the
    fused forward against JAX's fused forward and against the unfused one."""
    from buctd_tpu.models.fuse import maybe_fuse_prenet as jax_fuse
    from buctd_tpu_torch.models.fuse import maybe_fuse_prenet

    jcfg, tcfg, model, variables, port = _pair(layers, True, 1, "TPU.FUSED_PRENET", "auto")
    jmodel, jvars = jax_fuse(jcfg, model, variables)
    fused = maybe_fuse_prenet(tcfg, port)
    assert fused.fused_prenet and fused.prenet_fused.a.kernel_size == (7, 7)
    assert not any(k.startswith(("rgb_preNet", "cond_preNet")) for k in fused.state_dict())
    for name, leaf in (("a", "kernel"), ("b", "kernel"), ("a", "bias"), ("b", "bias")):
        want = np.asarray(jvars["params"]["_prenet_fused"][name][leaf])
        got = getattr(fused.prenet_fused, name)
        got = (got.weight.permute(2, 3, 1, 0) if leaf == "kernel" else got.bias).detach().numpy()
        np.testing.assert_array_equal(got, want)
    x = _input(seed=3)
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got, unfused = _nhwc(fused(_nchw(x))), _nhwc(port(_nchw(x)))
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_RTOL * peak)
    np.testing.assert_allclose(got, unfused, rtol=0, atol=FWD_RTOL * peak)
    with pytest.raises(RuntimeError, match="eval-only"):
        fused.train()(_nchw(x))


@pytest.mark.parametrize("layers", [18, 50])
def test_train_forward_and_bn_statistics_match_jax(layers):
    _, _, model, variables, port = _pair(layers, True, 2)
    x = _input(seed=4, n=3)
    jax.config.update("jax_enable_x64", True)     # flax's f32 E[x^2]-E[x]^2 cancels
    try:
        f64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want, updates = model.apply(f64, jnp.asarray(x, jnp.float64), train=True,
                                    mutable=["batch_stats"])
        want = np.asarray(want, np.float32)
        updates = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), updates)
    finally:
        jax.config.update("jax_enable_x64", False)
    port.train()
    got = _nhwc(port(_nchw(x)))
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TRAIN_RTOL * peak)
    from buctd_tpu_torch.convert import from_flax

    stats = from_flax({"batch_stats": updates["batch_stats"]})
    sd = port.state_dict()
    assert len(stats) > 40
    for key, value in stats.items():
        if key.endswith("num_batches_tracked"):
            assert int(sd[key]) == 1, key
            continue
        ref = value.numpy()
        np.testing.assert_allclose(sd[key].numpy(), ref, rtol=0,
                                   atol=TRAIN_RTOL * max(np.abs(ref).max(), 1.0), err_msg=key)


@pytest.mark.parametrize("kernel", [4, 3, 2])
def test_deconv_matches_jax(kernel):
    """Deconv alone: JAX's dilated-conv form vs torch's ConvTranspose2d on
    the converter's weights, with and without the bias."""
    from buctd_tpu.models.resnet import Deconv as JaxDeconv
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.models.resnet import Deconv

    rng = np.random.RandomState(kernel)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    for bias in (False, True):
        padding, output_padding = {4: (1, 0), 3: (1, 1), 2: (0, 0)}[kernel]
        jd = JaxDeconv(features=8, kernel=kernel, padding=padding,
                       output_padding=output_padding, use_bias=bias)
        params = {"kernel": (rng.randn(kernel, kernel, 8, 6) / 5).astype(np.float32)}
        if bias:
            params["bias"] = (0.1 * rng.randn(8)).astype(np.float32)
        want = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
        d = Deconv(6, 8, kernel, bias)
        d.load_state_dict(from_flax({"params": params}), strict=True)
        with torch.inference_mode():
            got = _nhwc(d(_nchw(x)))
        assert got.shape == want.shape == (2, 10, 14, 8)
        np.testing.assert_allclose(got, want, rtol=0, atol=FWD_RTOL * np.abs(want).max())


def test_state_dict_round_trips_through_jax_converter():
    from buctd_tpu.convert import torch_to_flax

    jcfg = load_cfg("jax", PRENET_YAML, tiny(50))
    _, template = jax_variables(jcfg, seed=0)
    *_, variables, port = _pair(50, True, 5)
    back = torch_to_flax(port.state_dict(), template, strict=True)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_back) == len(flat_want) == 300      # ResNet-50 with the preNet
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path],
                                      err_msg=jax.tree_util.keystr(path))


def _bf16_deconv():
    """JAX's Deconv with its kernel in the input's dtype: what flax's bf16
    convs do with their operands (promote both to the module's dtype)."""
    from buctd_tpu.models import resnet as jax_resnet

    class Bf16Deconv(jax_resnet.Deconv):
        @nn.compact
        def __call__(self, x):
            C = x.shape[-1]
            k, p, op = self.kernel, self.padding, self.output_padding
            w = self.param("kernel", jax_resnet.KERNEL_INIT, (k, k, self.features, C))
            w_conv = jnp.flip(w.astype(x.dtype).transpose(0, 1, 3, 2), axis=(0, 1))
            pad = (k - 1 - p, k - 1 - p + op)
            out = jax.lax.conv_general_dilated(
                x, w_conv, window_strides=(1, 1), padding=(pad, pad), lhs_dilation=(2, 2),
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
            if self.use_bias:
                out = out + self.param("bias", nn.initializers.zeros,
                                       (self.features,)).astype(x.dtype)
            return out

    return Bf16Deconv


@pytest.mark.parametrize("prenet", [True, False], ids=["prenet", "plain"])
def test_bf16_autocast_rounds_where_jax_rounds(monkeypatch, prenet):
    from test_torch_port_eval_bf16 import _flax_dtypes, _port_dtypes

    from buctd_tpu.models import get_model
    from buctd_tpu.models import resnet as jax_resnet
    from buctd_tpu_torch.models import autocast

    jcfg, _, _, variables, port = _pair(18, prenet, 6)
    x = _input(seed=7)
    with pytest.raises(TypeError, match="same dtypes"):     # JAX's own bf16 model
        get_model(jcfg, dtype=jnp.bfloat16).apply(variables, jnp.asarray(x), train=False)
    monkeypatch.setattr(jax_resnet, "Deconv", _bf16_deconv())
    jmodel = get_model(jcfg, dtype=jnp.bfloat16)
    want, state = jmodel.apply(variables, jnp.asarray(x), train=False,
                               capture_intermediates=True, mutable=["intermediates"])
    jax_dtypes = _flax_dtypes(state["intermediates"])
    dtypes, handles = _port_dtypes(port)
    try:
        with torch.inference_mode(), autocast("cpu", torch.bfloat16):
            got = port(_nchw(x))
    finally:
        for handle in handles:
            handle.remove()
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    shared = {n: (dtypes[n], getattr(torch, jnp.dtype(d).name))
              for n, d in jax_dtypes.items() if n in dtypes}
    assert len(shared) >= 0.8 * len(jax_dtypes), sorted(set(jax_dtypes) - set(shared))
    assert {n: p for n, (p, j) in shared.items() if p != j} == {}
    assert all(shared[f"deconv_layers.{i}"][0] == torch.bfloat16 for i in (0, 3, 6))
    want = np.asarray(want, np.float32)
    steps = np.abs(_nhwc(got) - want).max() / np.abs(want).max() / STEP
    assert steps <= MODEL_TOL_STEPS[False], steps
