"""buctd_tpu_torch's bf16 autocast model vs JAX's bf16 model, module by module.

Each port module runs under ``torch.autocast("cpu", dtype=torch.bfloat16)``
and JAX's module is built with ``dtype=jnp.bfloat16``, with the same weights
(``convert.from_flax``) and the same inputs: the port's own activations of
the tiny CoAM model's autocast eval forward, made from a numpy seed (bf16
where the model hands a module bf16, the f32 image and condition where it
hands it those).  The gap unit is one bf16 step of the output, 2^-8 x max
|JAX's output|.

What the modules show (``python tests/test_torch_port_bf16_trunk.py``
prints every number):

* convs without bias, BatchNorm in eval mode, the Bottleneck and BasicBlock
  blocks, the transitions, the HRModules with their fuse layers (nearest
  upsample and sums), the stem and layer1: within TOL_STEPS = 2 steps of JAX
  (measured 0 to 0.7): f32 sums in another order round a few outputs one step
  apart.  flax's BatchNorm and torch's both normalise in f32 and round once.
* BatchNorm in train mode: 0.61-0.65 steps from flax, with 3-5 outputs in
  10^4 one step apart; when the JAX side normalises with float64 batch
  statistics in place of its own, 0.001-0.15 steps and about a tenth as many
  apart: flax's E[x^2] - E[x]^2 in f32 makes nine tenths of the train-mode
  gap, and the rest is f32 sums in another order.
* The biased layers rounded at another point: flax's ``nn.Conv`` and
  ``nn.Dense`` round the product to bf16 and then add the bf16 bias (two
  roundings); torch's autocast conv and linear took the bias inside the
  product (one).  The final 1x1 conv landed 1.6 steps away with 29% of its
  outputs one step apart, and in the CoAM block, whose condition convs feed
  an attention with logits of O(100) (condition values up to 255), one step
  in the query became 7 to 30 steps at the output.  Repaired in
  models/hrnet.py (``Conv2d``, ``Linear``: under autocast the bias is added
  after the product, in its dtype); now 0 steps and no output apart.  The
  ``pre_fix`` fixture restores torch's one rounding, and those tests miss.
* The whole model compounds sub-step differences through ~40 layers, and the
  CoAM attention amplifies what reaches it about 5-15x: the gap grows from
  under 0.5 steps after the stem to 1.5 after layer1, 2-3 after stage2, 10-34
  after the CoAM block, and ends 4-12 steps (eval) from JAX's heatmaps, as far
  as the port's own bf16 model is from its f32 model.  So the whole-model
  tests hold the heatmaps at twice the gap measured at seed 1
  (MODEL_TOL_STEPS), and the per-module tests are the proof.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import copy
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from buctd_tpu_torch.models import hrnet
from buctd_tpu_torch.ops.warp import resize_bilinear_nchw
from test_torch_port_config import TINY_COAM, jax_variables, load_cfg, port_model

BF16 = jnp.bfloat16
STEP = 2.0 ** -8
TOL_STEPS = 2.0
# train-mode BN: with float64 statistics on the JAX side, the share of outputs
# apart from the port's falls at least this many times (measured 9-11x)
F64_STATS_FALL = 5.0
# the repaired layers: share of outputs apart from JAX's (measured 0 repaired;
# torch's one rounding puts 10-30% of them one step apart)
MISMATCH = 0.01
# the tiny model's heatmaps, eval and train mode: twice the gap measured at
# seed 1 (12.2 and 43.8 steps: 4.8e-2 and 0.171 of the max)
MODEL_TOL_STEPS = {False: 25.0, True: 88.0}


@pytest.fixture
def pre_fix(monkeypatch):
    """Switch the port back to torch's one rounding of a biased conv or
    linear under autocast."""
    def apply():
        monkeypatch.setattr(hrnet.Conv2d, "forward", nn.Conv2d.forward)
        monkeypatch.setattr(hrnet.Linear, "forward", nn.Linear.forward)
    return apply


def _autocast():
    return torch.autocast("cpu", dtype=torch.bfloat16)


def _jax(t):
    """NCHW (or token-major) torch -> JAX layout, bf16 kept bf16, f32 kept f32."""
    a = t.float().numpy()
    if a.ndim == 4:
        a = a.transpose(0, 2, 3, 1)
    return jnp.asarray(a).astype(BF16 if t.dtype == torch.bfloat16 else jnp.float32)


def _torch(a):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    return torch.from_numpy(a.transpose(0, 3, 1, 2) if a.ndim == 4 else a)


def _steps(got, want) -> float:
    """max |got - want| in bf16 steps of max |want|."""
    want = _torch(want) if not torch.is_tensor(want) else want
    return ((got.float() - want).abs().max() / want.abs().max()).item() / STEP


def _apart(got, want) -> float:
    """Share of outputs that differ from JAX's."""
    return (got.float() != _torch(want)).float().mean().item()


@functools.lru_cache(maxsize=None)
def _setup():
    """Tiny CoAM config, JAX variables (seed 1), the port model with them,
    the seeded input, and the port's autocast activations."""
    cfg = load_cfg("jax", opts=TINY_COAM)
    _, variables = jax_variables(cfg, seed=1)
    port = port_model(load_cfg("torch", opts=TINY_COAM), variables)
    img_w, img_h = cfg.MODEL.IMAGE_SIZE
    rng = np.random.RandomState(0)
    x = torch.from_numpy(np.concatenate([rng.randn(2, 3, img_h, img_w),
                                         rng.uniform(0, 255, (2, 3, img_h, img_w))], 1)
                         .astype(np.float32))
    return cfg, variables, port, x, _activations(port, x)


def _activations(port, x) -> dict:
    """The port's autocast eval forward step by step: each module's input."""
    a = {"conv1": x[:, :3], "cond": x[:, 3:]}
    with torch.no_grad(), _autocast():
        y = F.relu(port.bn1(port.conv1(x[:, :3])))
        a["conv2"] = y
        y = F.relu(port.bn2(port.conv2(y)))
        for k in range(4):
            a[f"layer1.{k}"] = y
            y = port.layer1[k](y)
        ys = [y]
        for si in range(3):
            a[f"transition{si + 1}"] = ys
            ys = hrnet._apply_transition(getattr(port, f"transition{si + 1}"), ys)
            if si in port._att_stages:
                a[f"stage{si + 1}_att"] = ys
                ys = getattr(port, f"stage{si + 1}_att")(ys, x[:, 3:])
            a[f"stage{si + 2}"] = ys
            ys = getattr(port, f"stage{si + 2}")(ys)
        a["final_layer"] = ys[0]
    return a


def _vars(name, sub=None):
    """{'params', 'batch_stats'} of the trunk's JAX module ``name`` (or of its
    child ``sub``)."""
    _, variables, *_ = _setup()
    out = {}
    for coll in ("params", "batch_stats"):
        node = variables[coll]["_trunk"].get(name)
        if node is not None and sub is not None:
            node = node.get(sub)
        if node is not None:
            out[coll] = node
    return out


def _run_port(fn, *inputs):
    with torch.no_grad(), _autocast():
        return fn(*inputs)


# -------------------------------------------------------- conv + BatchNorm ----
def _conv_bn_case(name):
    """(port fn, JAX fn, input) of a conv + BN pair of the trunk, BN in eval
    mode (running statistics)."""
    from buctd_tpu.models import hrnet as jh

    _, _, port, _, a = _setup()

    def jax_pair(conv_vars, bn_vars, cout, kernel, stride, pad=None, up=1):
        def run(x):
            y = jh.conv(cout, kernel, stride, pad=pad, dtype=BF16).apply(conv_vars, x)
            y = jh.batch_norm(dtype=BF16).apply(bn_vars, y, use_running_average=True)
            return jh.upsample_nearest(y, up) if up > 1 else y
        return run

    if name == "stem conv1 + bn1":
        return (lambda x: port.bn1(port.conv1(x)),
                jax_pair(_vars("conv1"), _vars("bn1"), 64, 3, 2), a["conv1"])
    if name == "stem conv2 + bn2":
        return (lambda x: port.bn2(port.conv2(x)),
                jax_pair(_vars("conv2"), _vars("bn2"), 64, 3, 2), a["conv2"])
    if name == "transition2.2 (stride-2 conv + bn)":
        seq = port.transition2[2][0]
        return (lambda x: seq[1](seq[0](x)),
                jax_pair(_vars("_transition2", "transition2.2.0.0"),
                         _vars("_transition2", "transition2.2.0.1"), 32, 3, 2),
                a["transition2"][-1])
    if name == "stage2 fuse 0.1 (1x1 conv + bn + upsample)":
        with torch.no_grad(), _autocast():
            y1 = port.stage2[0].branches[1](a["stage2"][1])
        return (port.stage2[0].fuse_layers[0][1],
                jax_pair(_vars("stage2.0", "fuse_layers.0.1.0"),
                         _vars("stage2.0", "fuse_layers.0.1.1"), 8, 1, 1, pad=0, up=2), y1)
    raise KeyError(name)


CONV_BN = ["stem conv1 + bn1", "stem conv2 + bn2", "transition2.2 (stride-2 conv + bn)",
           "stage2 fuse 0.1 (1x1 conv + bn + upsample)"]


@pytest.mark.parametrize("name", CONV_BN)
def test_conv_bn_eval_matches_jax_bf16(name):
    port_fn, jax_fn, x = _conv_bn_case(name)
    assert _steps(_run_port(port_fn, x), jax_fn(_jax(x))) <= TOL_STEPS


def _bn_train_gaps(name):
    """Train-mode BN of the stem (batch statistics) on the stem conv's
    output: (steps, share of outputs apart) from flax's BN, and the same from
    flax's normalisation with float64 statistics of the same input in place
    of its own."""
    from buctd_tpu.models import hrnet as jh

    _, _, port, _, a = _setup()
    conv, bn = {"bn1": (port.conv1, port.bn1), "bn2": (port.conv2, port.bn2)}[name]
    x = a["conv1" if name == "bn1" else "conv2"]
    c = _run_port(conv, x)
    got = _run_port(copy.deepcopy(bn).train(), c)
    jbn, variables = jh.batch_norm(dtype=BF16), _vars(name)
    want, _ = jbn.apply(variables, _jax(c), use_running_average=False, mutable=["batch_stats"])
    c64 = c.double()
    stats = {"mean": jnp.asarray(c64.mean((0, 2, 3)).numpy(), jnp.float32),
             "var": jnp.asarray(c64.var((0, 2, 3), unbiased=False).numpy(), jnp.float32)}
    want64 = jbn.apply({"params": variables["params"], "batch_stats": stats}, _jax(c),
                       use_running_average=True)
    return (_steps(got, want), _apart(got, want)), (_steps(got, want64), _apart(got, want64))


@pytest.mark.parametrize("name", ["bn1", "bn2"])
def test_bn_train_gap_is_the_variance_formula(name):
    """In train mode the port's BN is within TOL_STEPS of flax's; with
    float64 statistics on the JAX side the outputs apart fall F64_STATS_FALL
    times or more: flax's f32 E[x^2] - E[x]^2 makes most of the gap, the
    rounding agrees."""
    (flax_steps, flax_apart), (f64_steps, f64_apart) = _bn_train_gaps(name)
    assert max(flax_steps, f64_steps) <= TOL_STEPS, (flax_steps, f64_steps)
    assert f64_apart * F64_STATS_FALL <= flax_apart, (flax_apart, f64_apart)


# ----------------------------------------------- blocks, modules, transitions ----
def _module_case(name):
    """(port fn, JAX fn, input) of a block, HRModule, transition or the stem."""
    from buctd_tpu.models import hrnet as jh

    cfg, _, port, _, a = _setup()
    spec = port.spec
    if name.startswith("layer1."):
        k = int(name[-1])
        jm = jh.Bottleneck(planes=64, has_downsample=k == 0, dtype=BF16)
        return port.layer1[k], lambda x: jm.apply(_vars(name), x), a[name]
    if name.startswith("stage") and ".branches." in name:
        stage, i = name.split(".")[0], int(name.split(".")[-1])
        st = getattr(spec, stage)
        jm = jh.BasicBlock(planes=st.num_channels[i], dtype=BF16)
        return (getattr(port, stage)[0].branches[i][0],
                lambda x: jm.apply(_vars(f"{stage}.0", f"branches.{i}.0"), x), a[stage][i])
    if name.startswith("stage"):
        si = int(name[5]) - 2
        st = spec.stages[si]
        jm = jh.HRModule(spec=st, in_channels=st.out_channels, multi_scale_output=si < 2,
                         dtype=BF16)
        return (lambda *xs: getattr(port, name)[0](list(xs)),
                lambda *xs: jm.apply(_vars(f"{name}.0"), list(xs)), a[name])
    if name.startswith("transition"):
        si = int(name[-1]) - 1
        pre = (256,) if si == 0 else spec.stages[si - 1].out_channels
        jm = jh.Transition(pre_channels=pre, cur_channels=spec.stages[si].out_channels,
                           name_prefix=name, dtype=BF16)
        return (lambda *ys: hrnet._apply_transition(getattr(port, name), list(ys)),
                lambda *ys: jm.apply(_vars(f"_{name}"), list(ys)), a[name])
    if name == "stem":
        def jax_stem(x):
            for i in (1, 2):
                x = jh.conv(64, 3, 2, dtype=BF16).apply(_vars(f"conv{i}"), x)
                x = jh.batch_norm(dtype=BF16).apply(_vars(f"bn{i}"), x,
                                                    use_running_average=True)
                x = jnp.maximum(x, 0)
            return x

        def port_stem(x):
            return F.relu(port.bn2(port.conv2(F.relu(port.bn1(port.conv1(x))))))
        return port_stem, jax_stem, a["conv1"]
    raise KeyError(name)


MODULES = ["stem", "layer1.0", "layer1.1", "layer1.2", "layer1.3", "transition1",
           "stage2.branches.0", "stage2.branches.1", "stage2", "transition2",
           "stage3.branches.2", "stage3", "transition3", "stage4.branches.3", "stage4"]


def _module_steps(name) -> float:
    port_fn, jax_fn, x = _module_case(name)
    xs = list(x) if isinstance(x, list) else [x]
    got, want = _run_port(port_fn, *xs), jax_fn(*(_jax(t) for t in xs))
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    return max(_steps(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", MODULES)
def test_trunk_modules_match_jax_bf16(name):
    """Blocks (Bottleneck with and without downsample, BasicBlock), the
    HRModules with their fuse layers, the transitions and the stem, each on
    the port's own bf16 input: within TOL_STEPS of JAX's bf16 module."""
    assert _module_steps(name) <= TOL_STEPS


# ---------------------------------------------- the repaired biased layers ----
def _biased_case(name):
    """(port module, JAX fn, input) of a biased layer: the final 1x1 conv,
    and the first CoAM layer's convs and output linear."""
    from flax import linen as fnn

    from buctd_tpu.models import coam as jc
    from buctd_tpu.models.attention import dense

    _, variables, port, _, a = _setup()
    if name == "final_layer":
        jm = fnn.Conv(port.final_layer.out_channels, (1, 1), padding=((0, 0), (0, 0)),
                      use_bias=True, dtype=BF16)
        return (port.final_layer,
                lambda x: jm.apply({"params": variables["params"]["final_layer"]}, x),
                a["final_layer"])
    da = port.stage2_att.att_layers[0]
    params = variables["params"]["_trunk"]["stage2_att"]["att_layers.0"]
    x = a["stage2_att"][0]
    with torch.no_grad(), _autocast():
        cond = resize_bilinear_nchw(a["cond"], x.shape[-2:])
    pam, cam = "position_attention_module", "channel_attention_module"
    if name == "position cnn_cond":
        return (da.position_attention_module.cnn_cond,
                lambda c: jc.conv3x3(3, None, BF16).apply({"params": params[pam]["cnn_cond"]},
                                                          c.astype(BF16)), cond)
    if name == "channel cnn":
        return (da.channel_attention_module.cnn,
                lambda y: jc.conv3x3(x.shape[1], None, BF16).apply(
                    {"params": params[cam]["cnn"]}, y), x)
    if name == "position fc_o":
        # its input, the f32 attention output, as the block's forward gives it
        fc_o, seen = da.position_attention_module.pa.fc_o, []
        hook = fc_o.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
        _run_port(lambda *t: port.stage2_att(list(t), a["cond"]), *a["stage2_att"])
        hook.remove()
        return (fc_o, lambda t: dense(x.shape[1], None, BF16).apply(
            {"params": params[pam]["pa"]["fc_o"]}, t), seen[0])
    raise KeyError(name)


@pytest.mark.parametrize("name", ["final_layer", "position cnn_cond", "channel cnn",
                                  "position fc_o"])
def test_biased_layers_round_as_jax(pre_fix, name):
    """The product rounded, then the bf16 bias added: within TOL_STEPS of
    JAX's layer with at most MISMATCH of the outputs apart; torch's single
    rounding (pre_fix) puts more of them apart."""
    module, jax_fn, x = _biased_case(name)
    got, want = _run_port(module, x), jax_fn(_jax(x))
    assert _steps(got, want) <= TOL_STEPS and _apart(got, want) <= MISMATCH
    pre_fix()
    assert _apart(_run_port(module, x), want) > MISMATCH


def _coam_steps() -> float:
    """The CoAM block (a DAModule a branch: channel and position attention on
    the condition resized to the branch) on the port's own inputs: its bf16
    branch features and the f32 condition render."""
    from buctd_tpu.models import coam as jc

    _, variables, port, _, a = _setup()
    ys = a["stage2_att"]
    got = _run_port(lambda *t: port.stage2_att(list(t), a["cond"]), *ys)
    jm = jc.CoAMBlock(channel_list=tuple(y.shape[1] for y in ys), d_cond=3, dtype=BF16)
    want = jm.apply({"params": variables["params"]["_trunk"]["stage2_att"]},
                    [_jax(y) for y in ys], _jax(a["cond"]))
    return max(_steps(g, w) for g, w in zip(got, want))


def test_coam_block_matches_jax_bf16(pre_fix):
    """The CoAM block within TOL_STEPS of JAX's bf16 block; with torch's one
    rounding of its convs and linears (pre_fix) the sharp attention carries
    the one-step differences of its query to many steps at the output."""
    assert _coam_steps() <= TOL_STEPS
    pre_fix()
    assert _coam_steps() > 2 * TOL_STEPS


# ------------------------------------------------------------ the model ----
STAGES = {"stem": "bn2", "layer1": "layer1.3", "stage2": "stage2.0",
          "stage2_att": "stage2_att", "stage3": "stage3.0", "stage4": "stage4.0"}


def _model_gaps(train: bool, seed: int = 1) -> dict:
    """The tiny model's autocast forward (port) and JAX's bf16 model on the
    same seeded input, each end to end: the gap after each stage and at the
    heatmaps, in steps.  Attention dropout is off on both sides (p = 0 in the
    port; JAX's attention modules called with train=False), so train mode
    differs from eval only in BatchNorm's batch statistics."""
    from flax import linen as fnn

    from buctd_tpu.models import attention as ja
    from buctd_tpu.models import get_model

    cfg = load_cfg("jax", opts=TINY_COAM)
    _, variables = jax_variables(cfg, seed=seed)
    port = port_model(load_cfg("torch", opts=TINY_COAM), variables).train(train)
    for m in port.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    img_w, img_h = cfg.MODEL.IMAGE_SIZE
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randn(2, 3, img_h, img_w),
                        rng.uniform(0, 255, (2, 3, img_h, img_w))], 1).astype(np.float32)
    got = {}
    for key, name in STAGES.items():
        mod = port.get_submodule(name.split(".")[0] if key != "layer1" else "layer1")
        mod.register_forward_hook(lambda m, args, out, key=key: got.__setitem__(
            key, list(out) if isinstance(out, (list, tuple)) else [out]))
    with torch.no_grad(), _autocast():
        heatmaps = port(torch.from_numpy(x))

    def no_dropout(next_fun, args, kwargs, context):
        if (context.method_name == "__call__" and isinstance(
                context.module, (ja.ScaledDotProductAttention,
                                 ja.SimplifiedScaledDotProductAttention))):
            kwargs = {**kwargs, "train": False}
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(no_dropout):
        out, state = get_model(cfg, dtype=BF16).apply(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=train,
            mutable=["batch_stats", "intermediates"], capture_intermediates=True)
    inter = state["intermediates"]["_trunk"]
    gaps = {}
    for key, name in STAGES.items():
        want = inter[name]["__call__"][0]
        want = list(want) if isinstance(want, (list, tuple)) else [want]
        gaps[key] = max(_steps(g, w) for g, w in zip(got[key], want))
    gaps["heatmaps"] = _steps(heatmaps, out)
    return gaps


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_tiny_coam_autocast_forward_matches_jax_bf16(train):
    """The whole tiny CoAM model under autocast against JAX's bf16 model:
    the stem within TOL_STEPS in eval, the heatmaps within MODEL_TOL_STEPS
    (see the module docstring: compounding, amplified by the CoAM
    attention)."""
    gaps = _model_gaps(train)
    assert gaps["heatmaps"] <= MODEL_TOL_STEPS[train], gaps
    if not train:
        assert gaps["stem"] <= TOL_STEPS, gaps


def main():
    """Print every gap the tests hold, in bf16 steps of the output's max."""
    for name in CONV_BN:
        port_fn, jax_fn, x = _conv_bn_case(name)
        print(f"eval {name}: {_steps(_run_port(port_fn, x), jax_fn(_jax(x))):.3f}")
    for name in ("bn1", "bn2"):
        (flax_steps, flax_apart), (f64_steps, f64_apart) = _bn_train_gaps(name)
        print(f"train {name}: {flax_steps:.3f} steps, {100 * flax_apart:.4f}% of outputs "
              f"apart from flax's statistics; {f64_steps:.3f} steps, {100 * f64_apart:.4f}% "
              f"with float64 statistics")
    for name in MODULES:
        print(f"eval {name}: {_module_steps(name):.3f}")
    for fixed in (True, False):
        if not fixed:
            hrnet.Conv2d.forward, hrnet.Linear.forward = nn.Conv2d.forward, nn.Linear.forward
        for name in ("final_layer", "position cnn_cond", "channel cnn", "position fc_o"):
            module, jax_fn, x = _biased_case(name)
            got, want = _run_port(module, x), jax_fn(_jax(x))
            print(f"{'repaired' if fixed else 'pre-fix '} {name}: {_steps(got, want):.3f} "
                  f"steps, {100 * _apart(got, want):.2f}% of outputs apart")
        print(f"{'repaired' if fixed else 'pre-fix '} CoAM block: {_coam_steps():.3f}")
    hrnet.Conv2d.forward, hrnet.Linear.forward = _FIXED
    for seed in (1, 2, 3):
        for train in (False, True):
            gaps = _model_gaps(train, seed)
            print(f"model seed {seed} {'train' if train else 'eval '}: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in gaps.items()))


_FIXED = (hrnet.Conv2d.forward, hrnet.Linear.forward)

if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
