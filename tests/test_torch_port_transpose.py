"""buctd_tpu_torch's BUCTD-TransPose-H vs buctd_tpu's, on the CPU at tiny size.

Both packages carry the same weights (N(0, 1/fan_in), test_torch_port_config.
jax_variables, crossed with ``convert.from_flax``) and take the same numpy
inputs.  Tolerances:

* the sine position table: bit for bit (the same f32 numpy arithmetic);
* f32 heatmaps (values up to ~5): 1e-4 absolute, as the CoAM model's (f32
  convs and attention summed in another order; measured ~4e-6).  The JAX
  side's flash engine runs its Pallas K1 in interpret mode
  (BUCTD_ATTENTION_ENGINE=flash), the port's the plain flash forward;
* the state_dict through buctd_tpu's converter: exact;
* bf16 autocast against JAX's bf16 modules, in bf16 steps of the output's
  max (2^-8 x max |JAX's output|): LayerNorm (bf16 out, as flax's), the
  self-attention and the encoder layer within TOL_STEPS = 2 on the batched
  matmul path (f32 sums in another order round a few outputs one step apart;
  measured 0 to 0.72) and FLASH_TOL_STEPS = 4 on the flash path (measured
  1.49 to 2.67: the port's plain flash forward rounds p at its row's final
  max, JAX's Pallas kernel at its running tile max, the known limit of the
  plain version that ROADMAP's F1 records; on the card K1 rounds as the
  Pallas kernel does); the whole tiny model within MODEL_TOL_STEPS, twice
  the gap measured at seed 1 (sub-step differences compound through the trunk
  and the encoder, and in train mode flax's BatchNorm variance E[x^2] -
  E[x]^2 in f32 adds most of it, as tests/test_torch_port_bf16_trunk.py
  shows for the trunk); ``python tests/test_torch_port_transpose.py`` prints
  every gap.  The division of q by sqrt(head dim) takes the divisor rounded
  to bf16, as JAX's weak-typed Python float is: the unrounded divisor
  (f32(sqrt(112)) against bf16's 10.5625) puts a third of q one step apart;
* one train step at dropout 0 (COMPUTE_DTYPE float32: no autocast), the
  port's TrainStep on the model in float64 against JAX's value_and_grad in
  float64: loss rtol 1e-5 (TrainStep takes the loss of out.float()), each
  gradient within 1e-5 x its tensor's max, BN running statistics 1e-6.  Both
  run in float64 because this tiny model's f32 gradients are ill-conditioned
  at batch 2: the port's own f32 gradients of the stem and layer1 lie up to
  5.5e-3 of their max from its float64 ones (BatchNorm's backward over batch
  statistics cancels), while its float64 gradients lie within 4e-7 of JAX's;
* PoseEstimator and the validate step as test_torch_port_serving.py and
  test_torch_port_eval.py hold the CoAM model: 1e-3 px, 1e-3 in confidence,
  heatmaps 1e-5 x their peak; every prediction is compared, and nine in ten
  of the heatmaps they come from must be decisive (top-two gap and the
  neighbour differences at the argmax above 5e-4, where heatmaps 1e-4 apart
  move a difference by 2e-4).
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_config import (TINY_TRANSPOSE, TRANSPOSE_YAML, jax_variables,
                                    load_cfg, port_model)

# the yaml's d = 112 (d_model 96 + 16), one head, on 64x32 images (128 tokens)
D112 = TINY_TRANSPOSE[4:] + ["MODEL.IMAGE_SIZE", "[32, 64]", "MODEL.HEATMAP_SIZE", "[8, 16]",
                             "MODEL.DIM_MODEL", "96", "MODEL.DIM_FEEDFORWARD", "64"]
F32 = ["TPU.COMPUTE_DTYPE", "float32"]
J = 17
BF16 = jnp.bfloat16
STEP = 2.0 ** -8
TOL_STEPS = 2.0
FLASH_TOL_STEPS = 4.0
# the whole tiny model, eval and train mode: twice the gap measured at seed 1
# (3.68 and 40.31 steps)
MODEL_TOL_STEPS = {False: 7.5, True: 81.0}
MARGIN = 5e-4


def _cfgs(opts):
    return (load_cfg("jax", TRANSPOSE_YAML, opts), load_cfg("torch", TRANSPOSE_YAML, opts))


def _input(cfg, n=2, seed=0):
    img_w, img_h = cfg.MODEL.IMAGE_SIZE
    rng = np.random.RandomState(seed)
    return rng.randn(n, img_h, img_w, 6).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _jax_forward(model, variables, x):
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))                                    # NHWC


def _port_forward(port, x):
    with torch.inference_mode():
        return port(_nchw(x)).permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------- position ----
@pytest.mark.parametrize("h,w,d", [(96, 72, 112), (8, 6, 32), (5, 7, 20)])
def test_sine_table_matches_jax_bit_for_bit(h, w, d):
    from buctd_tpu.models.transpose import make_sine_position_embedding as jax_table
    from buctd_tpu_torch.models.transpose import make_sine_position_embedding

    got = make_sine_position_embedding(h, w, d)
    assert got.shape == (h * w, d) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_table(h, w, d))


# -------------------------------------------------------------- forward ----
FORWARD_CASES = ([("auto", heads, pos) for heads in (1, 2)
                  for pos in ("sine", "learnable", "none")]
                 + [("flash", heads, "sine") for heads in (1, 2)])


@pytest.mark.parametrize("engine,heads,pos", FORWARD_CASES,
                         ids=[f"{e}-h{h}-{p}" for e, h, p in FORWARD_CASES])
def test_tiny_transpose_forward_matches_jax(monkeypatch, engine, heads, pos):
    """The port against buctd_tpu's TransPoseH on the same weights: engine
    auto (both sides' batched-matmul attention on the CPU) and flash (JAX's
    Pallas K1 in interpret mode, the port's plain flash forward)."""
    if engine == "flash":
        monkeypatch.setenv("BUCTD_ATTENTION_ENGINE", "flash")
    opts = TINY_TRANSPOSE + ["MODEL.N_HEAD", str(heads), "MODEL.POS_EMBEDDING", pos,
                             "TPU.ATTENTION_ENGINE", engine]
    jcfg, tcfg = _cfgs(opts)
    model, variables = jax_variables(jcfg, seed=1)
    port = port_model(tcfg, variables)
    assert ("pos_embedding" in port.state_dict()) == (pos != "none")
    x = _input(jcfg)
    want, got = _jax_forward(model, variables, x), _port_forward(port, x)
    assert got.shape == (2, 32, 24, J)
    assert np.abs(want).max() > 0.1              # peaked weights: O(1) maps
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_d112_forward_matches_jax():
    """The yaml's encoder width, d = 112 in one head, on a small image."""
    jcfg, tcfg = _cfgs(D112)
    model, variables = jax_variables(jcfg, seed=2)
    port = port_model(tcfg, variables)
    assert port.global_encoder.layers[0].self_attn.in_proj_weight.shape == (336, 112)
    x = _input(jcfg, seed=3)
    got = _port_forward(port, x)
    assert got.shape == (2, 16, 8, J)
    np.testing.assert_allclose(got, _jax_forward(model, variables, x), atol=1e-4, rtol=0)


# ------------------------------------------------------------- weights ----
def test_state_dict_round_trips_through_jax_converter():
    """torch_to_flax(port.state_dict(), template, strict=True, transpose_h's
    options) rebuilds the JAX variables exactly; the port's state_dict is the
    reference's layout (in_proj_weight, a frozen (L, 1, d) sine
    pos_embedding) and loads strict into a fresh model, its table included."""
    from buctd_tpu.convert import torch_to_flax
    from buctd_tpu.models import converter_options
    from buctd_tpu_torch.models import get_model

    jcfg, tcfg = _cfgs(TINY_TRANSPOSE)
    _, template = jax_variables(jcfg, seed=0)
    _, variables = jax_variables(jcfg, seed=2)
    port = port_model(tcfg, variables)
    sd = port.state_dict()
    assert sd["global_encoder.layers.1.self_attn.in_proj_weight"].shape == (96, 32)
    assert sd["global_encoder.layers.1.self_attn.in_proj_bias"].shape == (96,)
    assert sd["pos_embedding"].shape == (768, 1, 32)
    assert not port.pos_embedding.requires_grad
    back = torch_to_flax(sd, template, strict=True, **converter_options("transpose_h"))
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_back) == len(flat_want) > 100
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path],
                                      err_msg=jax.tree_util.keystr(path))

    fresh = get_model(tcfg, device="cpu")
    moved = dict(sd, pos_embedding=sd["pos_embedding"] + 1.0)   # a checkpoint's own table
    fresh.load_state_dict(moved, strict=True)
    for key, t in fresh.state_dict().items():
        torch.testing.assert_close(t, moved[key], rtol=0, atol=0, msg=key)
    with pytest.raises(RuntimeError, match="in_proj_weight"):
        fresh.load_state_dict({k: v for k, v in sd.items() if "in_proj_weight" not in k})


def test_get_model_builds_transpose_on_the_card_by_default():
    """get_model builds transpose_h on CUDA unless the CPU is asked for; the
    reference init leaves the sine table alone and gives LayerNorm 1 and 0."""
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.models.transpose import TransPoseH, make_sine_position_embedding

    _, tcfg = _cfgs(TINY_TRANSPOSE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model(tcfg)
    model = get_model(tcfg, device="cpu")
    assert isinstance(model, TransPoseH) and not model.training
    np.testing.assert_array_equal(model.pos_embedding[:, 0].numpy(),
                                  make_sine_position_embedding(32, 24, 32))
    layer = model.global_encoder.layers[0]
    assert (layer.norm1.weight == 1).all() and (layer.norm2.bias == 0).all()
    assert (layer.self_attn.in_proj_bias == 0).all()
    assert 0.0005 < layer.self_attn.in_proj_weight.std().item() < 0.002   # N(0, 0.001)


# ----------------------------------------------------------------- bf16 ----
def _steps(got, want) -> float:
    """max |got - want| in bf16 steps of max |want| (JAX's output)."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max() / STEP)


@functools.lru_cache(maxsize=None)
def _bf16_setup(seed=1):
    """Tiny config, JAX variables, the port model with them, bf16 tokens and
    the f32 sine table of the first encoder layer's width."""
    from buctd_tpu_torch.models.transpose import make_sine_position_embedding

    jcfg, tcfg = _cfgs(TINY_TRANSPOSE)
    model, variables = jax_variables(jcfg, seed=seed)
    port = port_model(tcfg, variables)
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.randn(2, 768, 32).astype(np.float32)).to(torch.bfloat16)
    pos = torch.from_numpy(make_sine_position_embedding(32, 24, 32))[None]
    return jcfg, model, variables, port, src, pos


def _layer_vars(variables, i=0, sub=None):
    node = variables["params"][f"global_encoder.layers.{i}"]
    return {"params": node if sub is None else node[sub]}


def _module_gap(name, engine="auto", seed=1):
    """(gap in steps, port output) of one encoder sub-module under CPU bf16
    autocast against JAX's bf16 module on the same inputs."""
    from flax import linen as fnn

    from buctd_tpu.models import transpose as jt

    _, _, variables, port, src, pos = _bf16_setup(seed)
    layer = port.global_encoder.layers[0]
    layer.self_attn.engine = engine
    try:
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
            if name == "norm1":
                got = layer.norm1(src)
            elif name == "self_attn":
                q = src + pos
                got = layer.self_attn(q, q, src)
            elif name == "encoder layer":
                got = layer(src, pos)
            else:
                raise KeyError(name)
    finally:
        layer.self_attn.engine = "auto"
    s, p = jnp.asarray(src.float().numpy()).astype(BF16), jnp.asarray(pos.numpy())
    if name == "norm1":
        want = fnn.LayerNorm(epsilon=1e-5, dtype=BF16).apply(
            _layer_vars(variables, sub="norm1"), s)
    elif name == "self_attn":
        want = jt.MultiheadSelfAttention(d_model=32, n_head=1, dtype=BF16).apply(
            _layer_vars(variables, sub="self_attn"), s + p, s + p, s)
    else:
        want = jt.TransformerEncoderLayer(d_model=32, n_head=1, dim_feedforward=32,
                                          dtype=BF16).apply(_layer_vars(variables), s, p)
    return _steps(got, want), got, want


MODULES = [("norm1", "auto"), ("self_attn", "auto"), ("self_attn", "flash"),
           ("encoder layer", "auto"), ("encoder layer", "flash")]


@pytest.mark.parametrize("name,engine", MODULES, ids=[f"{n}-{e}" for n, e in MODULES])
def test_encoder_modules_match_jax_bf16(monkeypatch, name, engine):
    if engine == "flash":
        monkeypatch.setenv("BUCTD_ATTENTION_ENGINE", "flash")
    gap, got, want = _module_gap(name, engine)
    assert got.dtype == torch.bfloat16 and want.dtype == BF16
    assert gap <= (FLASH_TOL_STEPS if engine == "flash" else TOL_STEPS), gap


def test_layer_norm_rounds_its_output_under_autocast():
    """The port's LayerNorm returns the autocast dtype whatever autocast's own
    rule for layer_norm on the device, as flax's bf16 LayerNorm does: an f32
    input (which CPU autocast hands torch's LayerNorm back as f32) comes out
    bf16, within TOL_STEPS of flax's."""
    from flax import linen as fnn

    _, _, variables, port, src, _ = _bf16_setup()
    norm = port.global_encoder.layers[0].norm1
    x = src.float() * 3.0 + 1.0
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got, plain = norm(x), torch.nn.LayerNorm.forward(norm, x)
    assert got.dtype == torch.bfloat16 and plain.dtype == torch.float32
    want = fnn.LayerNorm(epsilon=1e-5, dtype=BF16).apply(
        _layer_vars(variables, sub="norm1"), jnp.asarray(x.numpy()))
    assert want.dtype == BF16 and _steps(got, want) <= TOL_STEPS


def test_q_scale_rounds_as_jax_weak_type():
    """q / sqrt(hd) under autocast: bf16 q divided by the bf16-rounded
    divisor, as JAX divides a bf16 array by a Python float; the f32 divisor
    lands a third of the outputs one step away."""
    import math

    rng = np.random.RandomState(0)
    x = rng.randn(4096).astype(np.float32)
    want = np.asarray((jnp.asarray(x).astype(BF16) / float(np.sqrt(112))).astype(jnp.float32))
    q = torch.from_numpy(x).to(torch.bfloat16)
    got = q / float(torch.tensor(math.sqrt(112)).to(q.dtype))        # the port's
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert ((q / math.sqrt(112)).float().numpy() != want).mean() > 0.2


def _model_gap(train: bool, seed=1) -> float:
    """The whole tiny model under CPU bf16 autocast (eval, or train-mode BN at
    dropout 0) against JAX's bf16 model, in steps."""
    from buctd_tpu.models import get_model as jax_get_model

    jcfg, _, variables, port, _, _ = _bf16_setup(seed)
    jmodel = jax_get_model(jcfg, dtype=BF16)
    x = _input(jcfg, seed=seed)
    if train:
        out, _ = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
    else:
        out = jmodel.apply(variables, jnp.asarray(x), train=False)
    model = port_model(load_cfg("torch", TRANSPOSE_YAML, TINY_TRANSPOSE), variables)
    model.train(train)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        if hasattr(m, "in_proj_weight"):
            m.dropout = 0.0
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = model(_nchw(x)).permute(0, 2, 3, 1)
    return _steps(got, out)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_tiny_transpose_autocast_forward_matches_jax_bf16(monkeypatch, train):
    import buctd_tpu.models.attention as jatt

    # dropout off on the JAX side (train mode), for this test only
    orig = jatt._attend_train
    monkeypatch.setattr(jatt, "_attend_train",
                        lambda q, k, v, scale, dropout, rng: orig(q, k, v, scale, 0.0, None))
    monkeypatch.setattr(jatt.nn, "Dropout", lambda rate, deterministic: (lambda x: x))
    gap = _model_gap(train)
    assert gap <= MODEL_TOL_STEPS[train], gap


# ---------------------------------------------------------------- train ----
def _tiny_batch(seed=0, n=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6, 128, 96).astype(np.float32)
    tgt = (rng.rand(n, J, 32, 24) > 0.99).astype(np.float32)   # sparse peaks
    tw = (rng.rand(n, J) > 0.2).astype(np.float32)
    return x, tgt, tw


@pytest.mark.parametrize("pos", ["sine", "learnable"])
def test_train_step_matches_jax(monkeypatch, pos):
    """One step at dropout 0, the port's TrainStep on the float64 model
    against JAX's value_and_grad in float64 (see the module docstring)."""
    import buctd_tpu.models.attention as jatt
    from buctd_tpu.core.loss import make_loss as jax_loss
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.train.state import TrainStep, make_lr_schedule, make_optimizer

    orig = jatt._attend_train
    monkeypatch.setattr(jatt, "_attend_train",
                        lambda q, k, v, scale, dropout, rng: orig(q, k, v, scale, 0.0, None))
    monkeypatch.setattr(jatt.nn, "Dropout", lambda rate, deterministic: (lambda x: x))
    opts = TINY_TRANSPOSE + F32 + ["MODEL.POS_EMBEDDING", pos]
    jcfg, cfg = _cfgs(opts)
    jmodel, variables = jax_variables(jcfg, seed=1)
    batch = _tiny_batch()
    loss_fn = jax_loss(jcfg)

    def compute_loss(params, stats, x, tgt, tw):
        out, mutated = jmodel.apply({"params": params, "batch_stats": stats}, x,
                                    train=True, mutable=["batch_stats"],
                                    rngs={"dropout": jax.random.PRNGKey(0)})
        return loss_fn(out, tgt, tw), mutated["batch_stats"]

    jax.config.update("jax_enable_x64", True)
    try:
        f64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        (jloss, jstats), jgrads = jax.value_and_grad(compute_loss, has_aux=True)(
            f64["params"], f64["batch_stats"],
            jnp.asarray(batch[0].transpose(0, 2, 3, 1), jnp.float64),
            jnp.asarray(batch[1].transpose(0, 2, 3, 1), jnp.float64),
            jnp.asarray(batch[2], jnp.float64))
        jloss, jstats, jgrads = jax.tree_util.tree_map(np.asarray, (jloss, jstats, jgrads))
    finally:
        jax.config.update("jax_enable_x64", False)

    model = port_model(cfg, variables).double()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        if hasattr(m, "in_proj_weight"):
            m.dropout = 0.0
    optimizer = make_optimizer(cfg, model)
    step = TrainStep(cfg, model, optimizer, make_lr_schedule(cfg, optimizer, 1),
                     torch.Generator().manual_seed(0))
    assert all(layer.self_attn.generator is not None
               for layer in model.global_encoder.layers)
    metrics = step({"input": torch.from_numpy(batch[0]).double(),
                    "target": torch.from_numpy(batch[1]).double(),
                    "target_weight": torch.from_numpy(batch[2]).double()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)

    want = from_flax({"params": jgrads, "batch_stats": jstats})
    floor = max(float(np.abs(g.numpy()).max()) for k, g in want.items()
                if "running" not in k and "num_batches" not in k)
    n = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert name == "pos_embedding" and pos == "sine" and p.grad is None
            continue
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=max(1e-5 * np.abs(ref).max(), 1e-8 * floor),
                                   err_msg=name)
        n += 1
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
            n += 1
    assert n > 100


def test_flash_dropout_draws_from_the_trainers_generator():
    """Training mode on the flash engine: the attention dropout's seed comes
    from the generator set_dropout_generator hands the TransPose attention;
    none raises; one seed gives one result."""
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.models.attention import set_dropout_generator

    _, tcfg = _cfgs(TINY_TRANSPOSE + ["TPU.ATTENTION_ENGINE", "flash"])
    torch.manual_seed(0)
    model = get_model(tcfg, device="cpu").train()
    x = _nchw(_input(tcfg, n=1))
    with pytest.raises(RuntimeError, match="set_dropout_generator"):
        model(x)

    def run(seed):
        set_dropout_generator(model, torch.Generator().manual_seed(seed))
        torch.manual_seed(1)                       # the residual dropouts
        out = model(x)
        out.square().mean().backward()
        return out.detach()

    a, b, c = run(3), run(3), run(4)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_train_entry_runs_transpose_on_coco(tmp_path):
    """train/run.py on a tiny COCO-format set (17 joints) whose annotations
    carry cond_kpts, as the yaml (SYNTHESIS_POSE false) trains."""
    from test_data_pipeline import _tiny_coco

    from buctd_tpu_torch.serving import PoseEstimator
    from buctd_tpu_torch.train import run

    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=J)
    res = run.main(["--cfg", str(TRANSPOSE_YAML), "--device", "cpu", "--steps", "2",
                    "--no-eval", *TINY_TRANSPOSE, "DATASET.TRAIN_IMAGE_DIR", str(tmp_path),
                    "DATASET.TRAIN_ANNOTATION_FILE", ann_file, "TPU.DEVICE_PIPELINE", "True",
                    "TRAIN.BATCH_SIZE_PER_GPU", "2", "WORKERS", "1",
                    "OUTPUT_DIR", str(tmp_path / "out")])
    losses = [float(m["loss"]) for s in res["stats"] for m in s["metrics"]]
    assert res["steps"] == 2 and len(losses) == 2 and np.isfinite(losses).all()
    # the trained weights serve through PoseEstimator (a strict load)
    est = PoseEstimator(load_cfg("torch", TRANSPOSE_YAML, TINY_TRANSPOSE),
                        checkpoint=str(res["output_dir"] / "final_state.pth"), device="cpu")
    for key, t in est.model.state_dict().items():
        torch.testing.assert_close(t, res["model"].state_dict()[key], rtol=0, atol=0)


# -------------------------------------------------- serving, validation ----
def _margins(maps) -> torch.Tensor:
    """Per heatmap of (n, J, h, w) batches: the smaller of the top-two gap and
    the |neighbour differences| at the argmax, what a decode's argmax and
    nudge depend on."""
    hm = torch.cat(maps).flatten(0, 1)
    n, h, w = hm.shape
    top2 = hm.flatten(1).topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    idx = hm.flatten(1).argmax(dim=1)
    py, px = idx // w, idx % w
    inb = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    r = torch.arange(n)
    dx = (hm[r, py, (px + 1).clamp(max=w - 1)] - hm[r, py, (px - 1).clamp(min=0)]).abs()
    dy = (hm[r, (py + 1).clamp(max=h - 1), px] - hm[r, (py - 1).clamp(min=0), px]).abs()
    return torch.where(inb, torch.minimum(gap, torch.minimum(dx, dy)), gap)


def test_pose_estimator_matches_jax():
    from buctd_tpu.serving import PoseEstimator as JaxEstimator
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.serving import PoseEstimator

    jcfg, tcfg = _cfgs(TINY_TRANSPOSE)
    _, variables = jax_variables(jcfg, seed=5)
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (200, 300, 3)).astype(np.uint8)
    conds = np.concatenate([rng.uniform(60, 180, (3, J, 2)),
                            np.ones((3, J, 1))], -1).astype(np.float32)
    colors = np.linspace(0, 255, J * 3).reshape(-1, 3)
    est = PoseEstimator(tcfg, refine_iters=2, colors=colors, device="cpu")
    est.model.load_state_dict(from_flax(variables), strict=True)
    maps = []
    est.model.register_forward_hook(lambda m, i, o: maps.append(o.detach().clone()))
    jest = JaxEstimator(jcfg, refine_iters=2, colors=colors)
    jest.variables = jax.tree_util.tree_map(jnp.asarray, variables)

    vis = -np.inf   # random weights: keep every joint
    got, want = est.predict(img, conds, vis), jest.predict(img, conds, vis)
    assert got.shape == (3, J, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)
    images = [img, np.ascontiguousarray(img[::-1, :290][:180])]
    got_b = est.predict_batch(images, [conds, conds * 0.9], vis)
    want_b = jest.predict_batch(images, [conds, conds * 0.9], vis)
    for g, w in zip(got_b, want_b):
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-4)
    # every prediction agreed above; nine in ten of the decodes they came
    # from were decisive (heatmaps 1e-4 apart move a difference by 2e-4)
    assert len(maps) == 4 and (_margins(maps) > MARGIN).float().mean() > 0.9


def test_validate_step_matches_jax():
    """One flip-test validate step (core/function.py::make_validate_step) on
    the tiny model against buctd_tpu's."""
    from buctd_tpu.core.function import _make_validate_step
    from buctd_tpu.data.datasets.coco import COCODataset as JaxCOCO
    from buctd_tpu.data.joints_dataset import rainbow_colors
    from buctd_tpu_torch.core.function import make_validate_step

    opts = TINY_TRANSPOSE + ["TEST.FLIP_TEST", "True"]
    jcfg, cfg = _cfgs(opts)
    jmodel, variables = jax_variables(jcfg, seed=2)
    model = port_model(cfg, variables)
    flip_pairs, colors = JaxCOCO.flip_pairs, rainbow_colors(J)
    rng = np.random.RandomState(3)
    B = 2
    batch = {"input": rng.randn(B, 128, 96, 6).astype(np.float32),
             "cond_joints": np.concatenate([rng.uniform(2, [94, 126], (B, J, 2)),
                                            np.zeros((B, J, 1))], -1).astype(np.float32),
             "cond_joints_vis": np.repeat((rng.rand(B, J, 1) > 0.25).astype(np.float32), 3, -1),
             "target": (rng.rand(B, 32, 24, J) > 0.995).astype(np.float32),
             "target_weight": (rng.rand(B, J) > 0.2).astype(np.float32),
             "center": rng.uniform(80, 200, (B, 2)).astype(np.float32),
             "scale": rng.uniform(0.5, 1.2, (B, 2)).astype(np.float32)}
    want = _make_validate_step(jcfg, jmodel, flip_pairs, colors)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    jp, jm, jloss, jacc, jcnt, jhm = (np.asarray(t) for t in want)

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["input"] = tb["input"].permute(0, 3, 1, 2).contiguous()
    tb["target"] = tb["target"].permute(0, 3, 1, 2).contiguous()
    for k in ("cond_joints", "cond_joints_vis", "center", "scale"):
        tb[k] = batch[k]                                   # numpy meta, as the loader's
    p, m, loss, acc, cnt, hm = make_validate_step(cfg, model, flip_pairs, colors)(tb)
    peak = float(np.abs(jhm).max())
    np.testing.assert_allclose(hm.permute(0, 2, 3, 1).numpy(), jhm, rtol=0, atol=1e-5 * peak)
    assert (_margins([hm]) > MARGIN).float().mean() > 0.9
    np.testing.assert_allclose(p.numpy(), jp, rtol=0, atol=1e-3)
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-5, atol=1e-5 * peak)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == float(jacc) and int(cnt) == int(jcnt)


def main():
    """Print every bf16 gap the tests hold, in bf16 steps of the output's max."""
    import os

    for name, engine in MODULES:
        os.environ["BUCTD_ATTENTION_ENGINE"] = engine
        for seed in (1, 2):
            print(f"{name} ({engine}) seed {seed}: {_module_gap(name, engine, seed)[0]:.3f}")
    os.environ["BUCTD_ATTENTION_ENGINE"] = "auto"
    import buctd_tpu.models.attention as jatt

    orig = jatt._attend_train
    jatt._attend_train = lambda q, k, v, scale, dropout, rng: orig(q, k, v, scale, 0.0, None)
    jatt.nn.Dropout = lambda rate, deterministic: (lambda x: x)
    for seed in (1, 2, 3):
        for train in (False, True):
            print(f"model seed {seed} {'train' if train else 'eval '}: "
                  f"{_model_gap(train, seed):.2f}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
