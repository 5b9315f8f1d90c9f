"""buctd_tpu_torch's trainer options vs buctd_tpu, on the CPU at tiny size:
TRAIN.MIX, TRAIN.GRAD_ACCUM_STEPS, TPU.REMAT, TPU.FUSED_OPTIMIZER and the
warm starts.

* mixup and cutmix: the port's mix fed JAX's own draws gives JAX's mixed
  batch to 1e-6 (f32, the same elementwise arithmetic; the cutmix box is the
  same f32 comparison, so bit for bit), and λ_f + λ_b = 1;
* the mixed (cutmix) step and the double-target step against JAX's jitted
  steps in float64, as test_torch_port_train.py's step test runs (dropout
  off on both sides): loss rtol 1e-6, every parameter's SGD update within
  1e-4 x its tensor's max (test_torch_port_train.py's CoAM tolerance: JAX's
  CoAM attention keeps f32 products, preferred_element_type, under x64, and
  the small BN-weight updates of layer1 sit up to ~2e-5 of their max from
  the port's float64 ones) and BN statistics to 1e-6;
* GRAD_ACCUM_STEPS 2 against optax.MultiSteps fed the same gradients,
  through the LR milestones (which count optimizer steps), to 1e-6;
* REMAT: gradients and BN statistics with remat equal those without, bit
  for bit, with attention dropout on (the flash engine's seeded mask and
  the nn.Dropout masks), for CoAM in each mode and for TransPose-H (the
  whole forward); two controls show the test tells: a recompute that draws
  a fresh flash seed moves the gradients, one that moves the BN statistics
  again moves those;
* FUSED_OPTIMIZER: parameters after 3 steps equal the unfused optimizer's
  to f32 rounding (1e-6 relative);
* warm starts: MODEL.PRETRAINED loads the PRETRAINED_LAYERS subset of a
  .pth the test writes, TEST.MODEL_FILE the whole; the entry point trains
  with each option and writes checkpoint_ep{epoch}.pth every 20 epochs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_data_pipeline import _tiny_coco
from test_torch_port_config import COAM_YAML, TINY_COAM, jax_variables, load_cfg, port_model
from test_torch_port_transpose import TINY_TRANSPOSE, TRANSPOSE_YAML

F32 = ["TPU.COMPUTE_DTYPE", "float32"]
SGD = ["TRAIN.OPTIMIZER", "sgd", "TRAIN.LR", "0.1", "TRAIN.MOMENTUM", "0.9",
       "TRAIN.WD", "0.0001", "TRAIN.NESTEROV", "False"]


def _plain_batch(seed=0, n=4, J=14, hw=(128, 96)):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6, *hw).astype(np.float32)
    tgt = (rng.rand(n, J, hw[0] // 4, hw[1] // 4) > 0.99).astype(np.float32)
    tw = (rng.rand(n, J) > 0.2).astype(np.float32)
    return x, tgt, tw


def _jax_batch(batch):
    x, tgt, tw = batch
    return {"input": jnp.asarray(x.transpose(0, 2, 3, 1)),
            "target": jnp.asarray(tgt.transpose(0, 2, 3, 1)), "target_weight": jnp.asarray(tw)}


def _torch_batch(batch, dtype=torch.float32):
    x, tgt, tw = (torch.from_numpy(a).to(dtype) for a in batch)
    return {"input": x, "target": tgt, "target_weight": tw}


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy() if t.dim() == 4 else t.numpy()


# --- mixing ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["mixup", "cutmix"])
def test_mix_matches_jax_with_its_draws(mode):
    from buctd_tpu.train import mixing as jmix
    from buctd_tpu_torch.train import mixing

    batch = _plain_batch(seed=1, n=5)
    key = jax.random.PRNGKey(3)
    alpha = 0.7
    if mode == "mixup":
        want = jmix.mixup_batch(key, _jax_batch(batch), alpha)
        got = mixing.mixup(_torch_batch(batch),
                           np.asarray(jax.random.beta(key, alpha, alpha, (5,))))
    else:
        want = jmix.cutmix_batch(key, _jax_batch(batch), alpha)
        k_lam, k_cx, k_cy = jax.random.split(key, 3)        # cutmix_batch's own draws
        got = mixing.cutmix(_torch_batch(batch),
                            np.asarray(jax.random.beta(k_lam, alpha, alpha, (5,))),
                            np.asarray(jax.random.uniform(k_cx, (5,))),
                            np.asarray(jax.random.uniform(k_cy, (5,))))
        pasted = np.asarray(want["lambda_b"])
        assert (pasted > 0).any() and (pasted < 1).all()   # real boxes, not whole images
        np.testing.assert_array_equal(_nhwc(got["input"]), np.asarray(want["input"]))
    assert sorted(got) == sorted(want)
    for key_, value in want.items():
        np.testing.assert_allclose(_nhwc(got[key_]), np.asarray(value), rtol=0, atol=1e-6,
                                   err_msg=key_)
    np.testing.assert_allclose((got["lambda_f"] + got["lambda_b"]).numpy(), 1.0, atol=1e-7)


def test_mix_fn_draws_from_seed_and_step():
    from buctd_tpu_torch.train.mixing import make_mix_fn

    assert make_mix_fn(load_cfg("torch", opts=["TRAIN.MIX", ""])) is None
    with pytest.raises(ValueError, match="cutmix"):
        make_mix_fn(load_cfg("torch", opts=["TRAIN.MIX", "blend"]))
    draw, mix = make_mix_fn(load_cfg("torch", opts=["TRAIN.MIX", "cutmix"]))
    a = draw(np.random.default_rng([0, 1]), 4)
    b = draw(np.random.default_rng([0, 1]), 4)
    c = draw(np.random.default_rng([0, 2]), 4)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["lam"], c["lam"])
    out = mix(_torch_batch(_plain_batch()), a)
    assert out["input"].shape == (4, 6, 128, 96)


# --- the mixed and double steps vs JAX, float64 ------------------------------

def _jax_dropout_off(monkeypatch):
    import buctd_tpu.models.attention as jatt

    orig = jatt._attend_train
    monkeypatch.setattr(jatt, "_attend_train",
                        lambda q, k, v, scale, dropout, rng: orig(q, k, v, scale, 0.0, None))
    monkeypatch.setattr(jatt.nn, "Dropout", lambda rate, deterministic: (lambda x: x))


def _port_f64(cfg, variables):
    model = port_model(cfg, variables).double()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _check_update(model, before, new_state, old_params, jmetrics, metrics):
    """The port's parameter updates and BN statistics against the JAX step's
    (its updates taken in float64, then carried across)."""
    from buctd_tpu_torch.convert import from_flax

    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["acc"]), float(jmetrics["acc"]), atol=1e-6)
    upd = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                 new_state.params, old_params)
    new = from_flax({"params": upd, "batch_stats": new_state.batch_stats})
    n = 0
    for name, p in model.named_parameters():
        want = new[name].numpy()
        got = p.detach().numpy() - before[name]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-30,
                                   err_msg=name)
        n += 1
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), new[name].numpy(), rtol=1e-6, atol=1e-9,
                                       err_msg=name)
    assert n > 50


@pytest.mark.parametrize("kind", ["mixed_cutmix", "double"])
def test_mixed_and_double_steps_match_jax(monkeypatch, kind):
    from buctd_tpu.train import mixing as jmix
    from buctd_tpu.train.state import (create_train_state, make_train_step_double,
                                       make_train_step_mixed)
    from buctd_tpu_torch.train.state import (DoubleTrainStep, MixedTrainStep, make_lr_schedule,
                                             make_optimizer)

    _jax_dropout_off(monkeypatch)
    opts = TINY_COAM + F32 + SGD + ["TRAIN.MIX", "cutmix"]
    jcfg, cfg = load_cfg("jax", opts=opts), load_cfg("torch", opts=opts)
    jmodel, variables = jax_variables(jcfg, seed=1)
    batch = _plain_batch(seed=2)
    rng = jax.random.PRNGKey(4)

    jax.config.update("jax_enable_x64", True)
    try:
        f64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        old = jax.tree_util.tree_map(np.asarray, f64["params"])   # the step donates the state
        state = create_train_state(jcfg, jmodel, None, None, 1, variables=f64)
        jb = {k: jnp.asarray(v, jnp.float64) for k, v in _jax_batch(batch).items()}
        # make_train_step_mixed's draws: fold_in(rng, step 0), split, cutmix's split
        mix_rng = jax.random.split(jax.random.fold_in(rng, 0))[0]
        k_lam, k_cx, k_cy = jax.random.split(mix_rng, 3)
        draws = {"lam": np.asarray(jax.random.beta(k_lam, 1.0, 1.0, (4,))),
                 "ux": np.asarray(jax.random.uniform(k_cx, (4,))),
                 "uy": np.asarray(jax.random.uniform(k_cy, (4,)))}
        if kind == "double":
            double = jmix.cutmix_batch(mix_rng, jb, 1.0)
            lam = np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (4,)), np.float64)
            double["lambda_f"], double["lambda_b"] = jnp.asarray(lam), jnp.asarray(1.0 - 0.5 * lam)
            new_state, jm = make_train_step_double(jcfg, jmodel)(state, double, rng)
        else:
            new_state, jm = make_train_step_mixed(jcfg, jmodel)(state, jb, rng)
        new_state, jm = jax.tree_util.tree_map(np.asarray, (new_state, jm))
    finally:
        jax.config.update("jax_enable_x64", False)

    model = _port_f64(cfg, variables)
    before = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    optimizer = make_optimizer(cfg, model)
    args = (cfg, model, optimizer, make_lr_schedule(cfg, optimizer, 1),
            torch.Generator().manual_seed(0))
    tb = _torch_batch(batch, torch.float64)
    if kind == "double":
        step = DoubleTrainStep(*args)
        from buctd_tpu_torch.train.mixing import cutmix

        mixed = cutmix(tb, draws["lam"], draws["ux"], draws["uy"])
        mixed["lambda_f"] = torch.from_numpy(lam.copy())
        mixed["lambda_b"] = torch.from_numpy(1.0 - 0.5 * lam)   # not 1 - λ_f: both weights used
        metrics = step(mixed)
    else:
        step = MixedTrainStep(*args, seed=0)
        monkeypatch.setattr(step, "draw", lambda b: draws)      # JAX's draws, injected
        metrics = step(tb)
    _check_update(model, before, new_state, old, jm, metrics)


# --- gradient accumulation -----------------------------------------------------

@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_grad_accum_matches_optax_multisteps(opt):
    import optax

    from buctd_tpu.train.state import make_optimizer as jax_optimizer
    from buctd_tpu_torch.train.state import TrainStep, make_lr_schedule, make_optimizer

    opts = ["TRAIN.OPTIMIZER", opt, "TRAIN.LR_STEP", "[2, 3]", "TRAIN.LR", "0.01",
            "TRAIN.NESTEROV", "True", "TRAIN.WD", "0.01", "TRAIN.MOMENTUM", "0.9",
            "TRAIN.GRAD_ACCUM_STEPS", "2"]
    jcfg, cfg = load_cfg("jax", opts=opts), load_cfg("torch", opts=opts)
    rng = np.random.RandomState(1)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(16)]

    # 4 loader batches an epoch, 2 an optimizer step: milestones at optimizer
    # steps 4 and 6, micro-steps 8 and 12
    tx, _ = jax_optimizer(jcfg, steps_per_epoch=4)
    jw = jnp.asarray(w0)
    state = tx.init(jw)
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    optimizer = make_optimizer(cfg, model)
    step = TrainStep(cfg, model, optimizer, make_lr_schedule(cfg, optimizer, 4),
                     torch.Generator())
    lrs = []
    for i, g in enumerate(grads):
        upd, state = tx.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        step.apply((model.w * torch.from_numpy(g)).sum())      # its gradient is g
        np.testing.assert_allclose(model.w.detach().numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7, err_msg=f"micro-step {i}")
        lrs.append(optimizer.param_groups[0]["lr"])
    assert step.micro == 0
    assert lrs[:7] == [0.01] * 7 and lrs[7] == pytest.approx(1e-3)     # after opt step 4
    assert lrs[-1] == pytest.approx(1e-4)


def test_grad_accum_averages_two_micro_batches():
    """Two micro-batches of 2 step as the mean of their gradients: the update
    of one batch of 4 when the loss is a mean over the batch (SGD, f64)."""
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.train.state import TrainStep, make_lr_schedule, make_optimizer

    batch = _torch_batch(_plain_batch(seed=3), torch.float64)
    out = []
    for k, parts in ((1, [slice(0, 4)]), (2, [slice(0, 2), slice(2, 4)])):
        cfg = load_cfg("torch", opts=TINY_COAM + F32 + SGD + ["TRAIN.GRAD_ACCUM_STEPS", str(k),
                                                              "TPU.ATTENTION_ENGINE", "mapped"])
        torch.manual_seed(0)
        model = get_model(cfg, device="cpu").double()
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
            if isinstance(m, torch.nn.BatchNorm2d):
                m.eval()                  # per-batch statistics differ by split
        model.train = lambda mode=True, m=model: m          # keep the BNs in eval mode
        optimizer = make_optimizer(cfg, model)
        step = TrainStep(cfg, model, optimizer, make_lr_schedule(cfg, optimizer, 1),
                         torch.Generator())
        for sl in parts:
            step({key: v[sl] for key, v in batch.items()})
        out.append({n: p.detach().clone() for n, p in model.named_parameters()})
    for name, p in out[0].items():
        torch.testing.assert_close(out[1][name], p, rtol=1e-9, atol=1e-12, msg=name)


# --- remat ---------------------------------------------------------------------

def _remat_run(yaml, opts, batch, seed=0):
    """One train step (f32, SGD, dropout on): gradients, BN statistics, the
    number of BatchNorm calls that ran as a recompute."""
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.models import hrnet
    from buctd_tpu_torch.models.hrnet import random_init
    from buctd_tpu_torch.train.state import TrainStep, make_lr_schedule, make_optimizer

    cfg = load_cfg("torch", yaml, opts + F32 + SGD + ["TPU.ATTENTION_ENGINE", "flash"])
    torch.manual_seed(seed)
    model = get_model(cfg, device="cpu")
    random_init(model)
    optimizer = make_optimizer(cfg, model)
    step = TrainStep(cfg, model, optimizer, make_lr_schedule(cfg, optimizer, 1),
                     torch.Generator().manual_seed(5))
    recomputes = []
    real = hrnet.recomputing
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hrnet, "recomputing", lambda: recomputes.append(real()) or recomputes[-1])
        torch.manual_seed(1)                       # nn.Dropout's masks
        metrics = step(batch)
    assert torch.isfinite(metrics["loss"])
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    stats = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    return grads, stats, sum(recomputes), model


def _same(a, b):
    assert a.keys() == b.keys()
    return all(torch.equal(a[k], b[k]) for k in a)


CASES = [("coam_modules", COAM_YAML, TINY_COAM, "modules"),
         ("coam_blocks", COAM_YAML, TINY_COAM, "blocks"),
         ("coam_stem", COAM_YAML, TINY_COAM, "stem"),
         ("coam_forward", COAM_YAML, TINY_COAM, "forward"),
         ("transpose_h", TRANSPOSE_YAML, TINY_TRANSPOSE, "modules")]


@pytest.mark.parametrize("name,yaml,opts,mode", CASES, ids=[c[0] for c in CASES])
def test_remat_gradients_equal_with_dropout(name, yaml, opts, mode):
    J = 17 if yaml == TRANSPOSE_YAML else 14
    batch = _torch_batch(_plain_batch(seed=4, n=2, J=J))
    plain, plain_stats, none, _ = _remat_run(yaml, opts, batch)
    remat, remat_stats, recomputes, model = _remat_run(
        yaml, opts + ["TPU.REMAT", "True", "TPU.REMAT_MODE", mode], batch)
    assert none == 0 and recomputes > 0
    if yaml == COAM_YAML:          # 'forward' checkpoints the whole forward instead
        assert model.remat == ("" if mode == "forward" else mode)
    else:
        assert not hasattr(model, "remat")
    assert _same(plain, remat)
    assert _same(plain_stats, remat_stats)
    assert max(float(g.abs().max()) for g in plain.values()) > 0


@pytest.mark.parametrize("control", ["fresh_seed", "bn_moves_twice"])
def test_remat_controls_tell(monkeypatch, control):
    """Without the seed replay, or with the recompute moving BN's statistics,
    the TransPose-H whole-forward remat no longer equals the plain step."""
    from buctd_tpu_torch.models import attention, hrnet

    batch = _torch_batch(_plain_batch(seed=4, n=2, J=17))
    plain, plain_stats, _, _ = _remat_run(TRANSPOSE_YAML, TINY_TRANSPOSE, batch)
    if control == "fresh_seed":
        monkeypatch.setattr(attention, "draw_seed", lambda g: int(
            torch.randint(0, 2**31 - 1, (), generator=g)))
    else:
        monkeypatch.setattr(hrnet, "recomputing", lambda: False)
    got, got_stats, _, _ = _remat_run(TRANSPOSE_YAML, TINY_TRANSPOSE + ["TPU.REMAT", "True"],
                                      batch)
    if control == "fresh_seed":
        assert not _same(plain, got)
    else:
        assert _same(plain, got) and not _same(plain_stats, got_stats)


def test_remat_mode_refuses_unknown_modes():
    from buctd_tpu_torch.models.remat import remat_mode
    from buctd_tpu_torch.train.state import check_train_options

    cfg = load_cfg("torch", opts=["TPU.REMAT", "True", "TPU.REMAT_MODE", "module"])
    with pytest.raises(ValueError, match="REMAT_MODE"):
        check_train_options(cfg)
    assert remat_mode(load_cfg("torch", opts=["TPU.REMAT_MODE", "module"])) == ""
    assert remat_mode(cfg, is_train=False) == ""


# --- the fused optimizer --------------------------------------------------------

@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_fused_optimizer_matches_unfused(opt):
    """The tiny CoAM's parameters, 3 steps of the same seeded gradients: the
    fused optimizer (one multi-tensor pass) against the unfused one."""
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.train.state import make_lr_schedule, make_optimizer

    out = []
    for fused in (False, True):
        cfg = load_cfg("torch", opts=TINY_COAM + SGD + [
            "TRAIN.OPTIMIZER", opt, "TRAIN.LR", "0.01", "TRAIN.LR_STEP", "[1]",
            "TPU.FUSED_OPTIMIZER", str(fused)])
        torch.manual_seed(0)
        model = get_model(cfg, device="cpu")
        optimizer = make_optimizer(cfg, model)
        assert bool(optimizer.defaults.get("fused")) == fused
        scheduler = make_lr_schedule(cfg, optimizer, 2)      # the LR drops after step 2
        rng = np.random.RandomState(1)
        for _ in range(3):
            for p in model.parameters():
                p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
            optimizer.step()
            scheduler.step()
        out.append({n: p.detach().clone() for n, p in model.named_parameters()})
    assert len(out[0]) > 100
    for name, p in out[0].items():
        torch.testing.assert_close(out[1][name], p, rtol=1e-6, atol=1e-7, msg=name)


# --- warm starts and the entry point ---------------------------------------------

def test_warm_start_loads_the_pretrained_subset(tmp_path):
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.models.hrnet import random_init
    from buctd_tpu_torch.train.run import load_warm_start

    layers = ["conv1", "bn1", "layer1", "stage2"]
    opts = TINY_COAM + ["MODEL.EXTRA.PRETRAINED_LAYERS", str(layers)]
    torch.manual_seed(7)
    source = get_model(load_cfg("torch", opts=opts), device="cpu")
    random_init(source)
    sd = source.state_dict()
    sd["final_layer.weight"] = torch.zeros(3, 3)            # another shape: skipped
    path = tmp_path / "imagenet.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)

    cfg = load_cfg("torch", opts=opts + ["MODEL.PRETRAINED", str(path)])
    torch.manual_seed(8)
    model = get_model(cfg, device="cpu")
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    load_warm_start(cfg, model)
    got = model.state_dict()
    for key, value in got.items():
        want = sd[key] if key.split(".")[0] in layers else fresh[key]
        torch.testing.assert_close(value, want, rtol=0, atol=0, msg=key)
    assert any(not torch.equal(sd[k], fresh[k]) for k in got if k.startswith("layer1"))

    whole = load_cfg("torch", opts=TINY_COAM + ["TEST.MODEL_FILE", str(tmp_path / "m.pth")])
    torch.save(source.state_dict(), tmp_path / "m.pth")
    load_warm_start(whole, model)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, source.state_dict()[key], rtol=0, atol=0, msg=key)
    with pytest.raises(ValueError, match="PRETRAINED not found"):
        load_warm_start(load_cfg("torch", opts=opts + ["MODEL.PRETRAINED",
                                                       str(tmp_path / "none.pth")]), model)


def _entry_args(tmp_path, *extra, steps=("--steps", "2")):
    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=14)
    return ["--cfg", str(COAM_YAML), "--device", "cpu", "--no-eval", *steps, *TINY_COAM,
            "DATASET.TRAIN_IMAGE_DIR", str(tmp_path),
            "DATASET.TRAIN_ANNOTATION_FILE", ann_file, "TPU.DEVICE_PIPELINE", "True",
            "TRAIN.BATCH_SIZE_PER_GPU", "2", "WORKERS", "1", "AUTO_RESUME", "False",
            "OUTPUT_DIR", str(tmp_path / "out"), *extra]


OPTIONS = {"cutmix": ["TRAIN.MIX", "cutmix"], "mixup": ["TRAIN.MIX", "mixup"],
           "accum2": ["TRAIN.GRAD_ACCUM_STEPS", "2"], "remat": ["TPU.REMAT", "True"],
           "fused": ["TPU.FUSED_OPTIMIZER", "True"],
           "synthesis": ["TPU.DEVICE_SYNTHESIS", "True"]}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_entry_point_trains_with_each_option(tmp_path, option):
    from buctd_tpu_torch.train import run

    res = run.main(_entry_args(tmp_path, *OPTIONS[option]))
    losses = [float(m["loss"]) for s in res["stats"] for m in s["metrics"]]
    assert res["steps"] == 2 and len(losses) == 2 and np.isfinite(losses).all(), losses


def test_entry_point_warm_starts_and_writes_checkpoint_ep(tmp_path):
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.train import run

    torch.manual_seed(3)
    source = get_model(load_cfg("torch", opts=TINY_COAM), device="cpu")
    torch.save(source.state_dict(), tmp_path / "warm.pth")
    # epoch 19 alone: (19 + 1) % 20 == 0 writes checkpoint_ep19.pth
    res = run.main(_entry_args(tmp_path, "TEST.MODEL_FILE", str(tmp_path / "warm.pth"),
                               "TRAIN.BEGIN_EPOCH", "19", "TRAIN.END_EPOCH", "20", steps=()))
    out = res["output_dir"]
    assert res["steps"] == 2 and (out / "checkpoint_ep19.pth").exists()
    ep = torch.load(out / "checkpoint_ep19.pth", weights_only=False)
    assert ep["epoch"] == 20
    for key, t in res["model"].state_dict().items():
        torch.testing.assert_close(ep["state_dict"][key], t, rtol=0, atol=0)
