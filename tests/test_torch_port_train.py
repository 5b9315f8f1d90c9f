"""buctd_tpu_torch training vs buctd_tpu, on the CPU at tiny size.

* losses and PCK vs the JAX functions to 1e-6 (the same f32 means);
* Adam and SGD (nesterov, weight decay) fed identical gradients vs optax,
  through the LR milestones, to 1e-6 relative (the same elementwise updates);
* one tiny-CoAM train step at dropout 0 in f32 vs the JAX step's loss and
  gradients: loss rtol 1e-5, every gradient within 1e-4 x its tensor's max
  (f32 convs and attention summed in another order), BN running statistics
  after the step to 1e-5 (the port's BN moves them as flax does, with the
  biased batch variance).  The JAX step runs in float64 (jax_enable_x64,
  for this test only): flax's BatchNorm takes the batch variance as
  E[x^2] - E[x]^2, which in f32 puts the stem's gradients ~4e-3 of their max
  away from float64 here, while the port's f32 gradients stay within 1.1e-5
  of float64 at these weights (seed 1) and sparse, heatmap-like targets.
  fc_k's bias has a zero gradient in exact arithmetic (softmax is shift
  invariant): every tolerance has a floor of 1e-8 x the model's largest
  gradient.  The JAX side's dropout is switched off inside the test; no JAX
  file changes;
* a fixed batch repeated for 10 steps lowers the loss;
* the entry point trains, checkpoints and refuses what is not ported.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_data_pipeline import _tiny_coco
from test_torch_port_config import (COAM_YAML, TINY_COAM, jax_variables, load_cfg,
                                    port_model)

F32 = ["TPU.COMPUTE_DTYPE", "float32"]


def test_losses_and_pck_match_jax():
    from buctd_tpu.core.loss import joints_mse_loss as jmse
    from buctd_tpu.core.loss import joints_ohkm_mse_loss as johkm
    from buctd_tpu.core.metrics import pck_accuracy as jpck
    from buctd_tpu_torch.core.loss import joints_mse_loss, joints_ohkm_mse_loss, make_loss
    from buctd_tpu_torch.core.metrics import pck_accuracy

    rng = np.random.RandomState(0)
    pred = rng.rand(4, 14, 24, 18).astype(np.float32)          # NCHW
    tgt = rng.rand(4, 14, 24, 18).astype(np.float32)
    tw = (rng.rand(4, 14) > 0.3).astype(np.float32)
    p, t, w = (torch.from_numpy(x) for x in (pred, tgt, tw))
    jp, jt = jnp.asarray(pred.transpose(0, 2, 3, 1)), jnp.asarray(tgt.transpose(0, 2, 3, 1))
    for use_w in (True, False):
        np.testing.assert_allclose(float(joints_mse_loss(p, t, w, use_w)),
                                   float(jmse(jp, jt, jnp.asarray(tw), use_w)), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(float(joints_ohkm_mse_loss(p, t, w, 5, use_w)),
                                   float(johkm(jp, jt, jnp.asarray(tw), 5, use_w)),
                                   atol=1e-6, rtol=0)
    cfg = load_cfg("torch", opts=["LOSS.USE_OHKM", "True", "LOSS.TOPK", "5"])
    assert float(make_loss(cfg)(p, t, w)) == float(joints_ohkm_mse_loss(p, t, w, 5))

    acc, cnt, preds = pck_accuracy(p, t)
    jacc, jcnt, jpreds = jpck(jnp.asarray(pred), jnp.asarray(tgt))
    np.testing.assert_allclose(float(acc), float(jacc), atol=1e-6)
    assert int(cnt) == int(jcnt)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_optimizer_and_milestones_match_optax(opt):
    import optax

    from buctd_tpu.train.state import make_optimizer as jax_optimizer
    from buctd_tpu_torch.train.state import make_lr_schedule, make_optimizer

    opts = ["TRAIN.OPTIMIZER", opt, "TRAIN.LR_STEP", "[2, 3]", "TRAIN.LR", "0.01",
            "TRAIN.NESTEROV", "True", "TRAIN.WD", "0.01", "TRAIN.MOMENTUM", "0.9"]
    jcfg, cfg = load_cfg("jax", opts=opts), load_cfg("torch", opts=opts)
    rng = np.random.RandomState(1)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(8)]

    tx, _ = jax_optimizer(jcfg, steps_per_epoch=2)   # milestones at steps 4 and 6
    jw, state = jnp.asarray(w0), None
    state = tx.init(jw)
    param = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    model = torch.nn.Module()
    model.w = param
    optimizer = make_optimizer(cfg, model)
    scheduler = make_lr_schedule(cfg, optimizer, steps_per_epoch=2)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        param.grad = torch.from_numpy(g.copy())
        optimizer.step()
        scheduler.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
    assert optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)


def _tiny_batch(seed=0, n=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6, 128, 96).astype(np.float32)
    tgt = (rng.rand(n, 14, 32, 24) > 0.99).astype(np.float32)   # sparse peaks
    tw = (rng.rand(n, 14) > 0.2).astype(np.float32)
    return x, tgt, tw


def _port_step(cfg, model, batch):
    from buctd_tpu_torch.train.state import TrainStep, make_lr_schedule, make_optimizer

    optimizer = make_optimizer(cfg, model)
    step = TrainStep(cfg, model, optimizer, make_lr_schedule(cfg, optimizer, 1),
                     torch.Generator().manual_seed(0))
    return step, step({"input": torch.from_numpy(batch[0]),
                       "target": torch.from_numpy(batch[1]),
                       "target_weight": torch.from_numpy(batch[2])})


def test_train_step_matches_jax(monkeypatch):
    import buctd_tpu.models.attention as jatt
    from buctd_tpu.core.loss import make_loss as jax_loss
    from buctd_tpu_torch.convert import from_flax

    # dropout off on the JAX side, for this test only
    orig = jatt._attend_train
    monkeypatch.setattr(jatt, "_attend_train",
                        lambda q, k, v, scale, dropout, rng: orig(q, k, v, scale, 0.0, None))
    monkeypatch.setattr(jatt.nn, "Dropout", lambda rate, deterministic: (lambda x: x))

    jcfg = load_cfg("jax", opts=TINY_COAM + F32)
    jmodel, variables = jax_variables(jcfg, seed=1)
    batch = _tiny_batch()
    loss_fn = jax_loss(jcfg)

    def compute_loss(params, stats, x, tgt, tw):   # train/state.py::make_train_step
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

    cfg = load_cfg("torch", opts=TINY_COAM + F32)
    model = port_model(cfg, variables)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    _, metrics = _port_step(cfg, model, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)

    want = from_flax({"params": jgrads, "batch_stats": jstats})
    floor = max(float(np.abs(g.numpy()).max()) for k, g in want.items()
                if "running" not in k and "num_batches" not in k)
    n = 0
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=max(1e-4 * np.abs(ref).max(), 1e-8 * floor),
                                   err_msg=name)
        n += 1
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
            n += 1
    assert n > 100


def test_repeated_batch_lowers_the_loss():
    cfg = load_cfg("torch", opts=TINY_COAM + F32)
    from buctd_tpu_torch.models import get_model

    torch.manual_seed(0)
    model = get_model(cfg, device="cpu")
    batch = _tiny_batch(seed=5)
    step, first = _port_step(cfg, model, batch)
    tb = {"input": torch.from_numpy(batch[0]), "target": torch.from_numpy(batch[1]),
          "target_weight": torch.from_numpy(batch[2])}
    losses = [float(first["loss"])] + [float(step(tb)["loss"]) for _ in range(9)]
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.8 * losses[0], losses


def _train_args(tmp_path, *extra):
    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=14)
    return ["--cfg", str(COAM_YAML), "--device", "cpu", *TINY_COAM,
            "DATASET.TRAIN_IMAGE_DIR", str(tmp_path),
            "DATASET.TRAIN_ANNOTATION_FILE", ann_file, "TPU.DEVICE_PIPELINE", "True",
            "TRAIN.BATCH_SIZE_PER_GPU", "2", "WORKERS", "1",
            "OUTPUT_DIR", str(tmp_path / "out"), *extra]


def test_train_entry_runs_and_checkpoints(tmp_path):
    from buctd_tpu_torch.serving import PoseEstimator
    from buctd_tpu_torch.train import run

    args = _train_args(tmp_path)
    res = run.main(args[:2] + ["--steps", "3", "--no-eval"] + args[2:])
    assert res["steps"] == 3
    losses = [float(m["loss"]) for s in res["stats"] for m in s["metrics"]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    ckpt = res["output_dir"] / "final_state.pth"
    assert (res["output_dir"] / "checkpoint.pth").exists()
    est = PoseEstimator(load_cfg("torch", opts=TINY_COAM), checkpoint=str(ckpt),
                        device="cpu")
    for key, t in est.model.state_dict().items():
        torch.testing.assert_close(t, res["model"].state_dict()[key], rtol=0, atol=0)
    # AUTO_RESUME (true in the yaml): 2 steps per epoch, so the checkpoint
    # holds epoch 1 and a second run starts there
    again = run.main(args[:2] + ["--steps", "1", "--no-eval"] + args[2:])
    assert res["begin_epoch"] == 0 and again["begin_epoch"] == 1 and again["steps"] == 1


def test_train_entry_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Validation at EPOCH_EVAL_FREQ runs (results json, best AP tracked in
    model_best.pth); TPU.DEVICE_PIPELINE False and DEBUG.DEBUG train; an
    orbax TEST.MODEL_FILE of JAX's save_params warm-starts the model (the
    weights equal from_flax of the saved tree) and trains, while a
    save_checkpoint train-state directory raises ValueError as JAX's
    tools/train.py:76-77 does; a TPU.MESH_SHAPE over more cards than the
    run has raises."""
    from buctd_tpu_torch.core import function
    from buctd_tpu_torch.train import run

    args = _train_args(tmp_path)
    # the tiny random model scores AP 0, and model_best.pth is written only for
    # an AP above the best so far (tools/train.py:170): the wrapper reports
    # the real AP + 0.5 to the trainer
    real, aps = function.validate, []

    def validate(*a, **k):
        name_values, ap = real(*a, **k)
        aps.append(ap)
        return name_values, ap + 0.5

    monkeypatch.setattr(function, "validate", validate)
    res = run.main(args[:2] + ["--steps", "3"] + args[2:] + [
        "EPOCH_EVAL_FREQ", "1", "DATASET.TEST_IMAGE_DIR", str(tmp_path),
        "DATASET.TEST_ANNOTATION_FILE", str(tmp_path / "ann.json"),
        "TEST.BATCH_SIZE_PER_GPU", "2"])
    out = res["output_dir"]
    assert len(aps) == 1 and 0.0 <= aps[0] <= 1.0       # epoch 0 only: 3 steps, 2 a epoch
    assert res["perf"] == [aps[0] + 0.5]
    rows = json.loads((out / "results" / "keypoints_test_results_epoch0.json").read_text())
    assert len(rows) == 4
    best = torch.load(out / "model_best.pth", weights_only=False)
    last = torch.load(out / "checkpoint.pth", weights_only=False)["state_dict"]
    for key, t in best.items():
        torch.testing.assert_close(t, last[key], rtol=0, atol=0)
    # the host cv2 Loader and the train debug dumps run now
    for opts in (["TPU.DEVICE_PIPELINE", "False"], ["DEBUG.DEBUG", "True"]):
        assert run.main(args[:2] + ["--steps", "1", "--no-eval"] + args[2:] + opts)["steps"] == 1
    from test_torch_port_orbax import write_params_dir, write_train_state_dir

    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.models import get_model

    jcfg = load_cfg("jax", opts=TINY_COAM)
    jmodel, variables = jax_variables(jcfg, seed=7)
    orbax = write_params_dir(tmp_path / "orbax", variables)
    cfg = load_cfg("torch", opts=TINY_COAM + ["TEST.MODEL_FILE", orbax])
    model = get_model(cfg, device="cpu")
    run.load_warm_start(cfg, model)
    want = from_flax(variables)
    for key, t in model.state_dict().items():
        torch.testing.assert_close(t, want[key], rtol=0, atol=0)
    assert run.main(args[:2] + ["--steps", "1", "--no-eval"] + args[2:] +
                    ["TEST.MODEL_FILE", orbax])["steps"] == 1
    state = write_train_state_dir(tmp_path, jcfg, jmodel, variables)
    for opts, error, match in (
            # a mesh is ported; one over more cards than the run has raises
            (["TPU.MESH_SHAPE", "[2]"], ValueError, "MESH_SHAPE.*does not match"),
            (["TEST.MODEL_FILE", state], ValueError, "opt_state")):
        with pytest.raises(error, match=match):
            run.main(args[:2] + ["--steps", "1", "--no-eval"] + args[2:] + opts)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run.main(["--cfg", str(COAM_YAML), "--steps", "1"])


def test_bn_running_var_moves_like_flax():
    from buctd_tpu_torch.models.hrnet import batch_norm

    bn = batch_norm(3).train()
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 3, 4, 5).astype(np.float32))
    bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.9 + 0.1 * var).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               (0.1 * x.mean(dim=(0, 2, 3))).numpy(), rtol=1e-6, atol=1e-7)
    assert int(bn.num_batches_tracked) == 1
