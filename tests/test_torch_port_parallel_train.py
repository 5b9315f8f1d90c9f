"""Data-parallel training in buctd_tpu_torch vs buctd_tpu, on the CPU in real
processes over gloo (tests/torch_dist_children.py).

* Two SGD steps of tiny HRNet (tests/disthelp.py's config and 8-row global
  batch) and of tiny CoAM (attention dropout 0), run as 2 processes x 4
  rows, against JAX's single-process steps on the 8 rows and the port's
  one-process steps, within JAX's own tolerance for its sharded steps
  (1e-5 + 1e-4 x |ref|, tests/test_distributed.py): the losses of the port
  in f32 and in float64, and the BN running statistics after the steps of
  the port in float64, against JAX in float64 (see the test).  In f32 the
  order of the sums alone moves one element of HRNet's transition1.0.1
  running mean 1.1e-5 from float64 after the two steps, against 1.02e-5 of
  tolerance there.
* ``train.run`` with ``--coordinator/--num-processes/--process-id`` on
  ``--device cpu``: two epochs with the merged validation, one log file,
  one ``metrics.jsonl``, the checkpoints from process 0; ``AUTO_RESUME``
  restores on both processes.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)

import glob
from pathlib import Path

import numpy as np
import pytest
import torch

import disthelp
import torch_dist_children as tdc
from test_data_pipeline import _tiny_coco
from test_torch_port_config import COAM_YAML, REPO, TINY_COAM, jax_variables, load_cfg

ATOL, RTOL = 1e-5, 1e-4
HRNET_YAML = REPO / "experiments" / "coco" / "hrnet" / "w32_384x288_adam_lr1e-3.yaml"
SGD = ["TRAIN.OPTIMIZER", "sgd", "TRAIN.LR", "0.01"]
F32 = ["TPU.COMPUTE_DTYPE", "float32"]


def _coam_batch(seed=0, n=8, joints=14):
    rng = np.random.RandomState(seed)
    return {"input": rng.randn(n, 6, 128, 96).astype(np.float32),
            "target": (rng.rand(n, joints, 32, 24) > 0.99).astype(np.float32),   # sparse peaks
            "target_weight": (rng.rand(n, joints) > 0.2).astype(np.float32)}


def _jax_two_steps(jcfg, jmodel, variables, sample, batch, x64: bool):
    """JAX's train step (buctd_tpu/train/state.py, one process) twice on the
    NCHW ``batch``: the losses and the batch statistics after.  ``x64``: in
    float64 (jax_enable_x64 for this call only)."""
    import jax
    import jax.numpy as jnp

    from buctd_tpu.train.state import create_train_state, make_train_step

    dtype = jnp.float64 if x64 else jnp.float32
    jax.config.update("jax_enable_x64", x64)
    try:
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)
        state = create_train_state(jcfg, jmodel, jax.random.PRNGKey(0), sample.astype(dtype),
                                   steps_per_epoch=10, variables=variables)
        step = make_train_step(jcfg, jmodel, None)
        nhwc = {"input": jnp.asarray(batch["input"].transpose(0, 2, 3, 1), dtype),
                "target": jnp.asarray(batch["target"].transpose(0, 2, 3, 1), dtype),
                "target_weight": jnp.asarray(batch["target_weight"], dtype)}
        losses = []
        for _ in range(2):
            state, metrics = step(state, nhwc, jax.random.PRNGKey(1))
            losses.append(float(metrics["loss"]))
        return losses, jax.tree_util.tree_map(np.asarray, state.batch_stats)
    finally:
        jax.config.update("jax_enable_x64", False)


def _hrnet_case():
    import jax
    import jax.numpy as jnp

    from buctd_tpu.models import get_model as jax_get_model

    opts = disthelp.TINY + SGD
    jcfg = load_cfg("jax", HRNET_YAML, opts)
    jmodel = jax_get_model(jcfg, is_train=True)
    sample = jnp.zeros((1, 64, 64, 3))
    variables = jmodel.init(jax.random.PRNGKey(0), sample, train=False)   # as create_train_state
    g = disthelp.global_batch(8)
    batch = {"input": g["input"].transpose(0, 3, 1, 2), "target": g["target"].transpose(0, 3, 1, 2),
             "target_weight": g["target_weight"]}
    return HRNET_YAML, opts + F32, jcfg, jmodel, variables, sample, batch


def _coam_case(monkeypatch):
    import jax.numpy as jnp

    import buctd_tpu.models.attention as jatt

    # the attention dropout off on the JAX side, for this test only
    orig = jatt._attend_train
    monkeypatch.setattr(jatt, "_attend_train",
                        lambda q, k, v, scale, dropout, rng: orig(q, k, v, scale, 0.0, None))
    monkeypatch.setattr(jatt.nn, "Dropout", lambda rate, deterministic: (lambda x: x))
    opts = TINY_COAM + F32 + SGD
    jcfg = load_cfg("jax", COAM_YAML, opts)
    jmodel, variables = jax_variables(jcfg, seed=1)
    return (COAM_YAML, opts, jcfg, jmodel, variables, jnp.zeros((1, 128, 96, 6)),
            _coam_batch())


def _bn_stats(state_dict) -> dict:
    return {k: v for k, v in state_dict.items() if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("name", ["hrnet", "coam"])
def test_two_process_steps_match_jax_and_one_process(tmp_path, monkeypatch, name):
    from buctd_tpu_torch.convert import from_flax

    yaml, opts, jcfg, jmodel, variables, sample, batch = (
        _hrnet_case() if name == "hrnet" else _coam_case(monkeypatch))
    state_dict = from_flax(variables)                 # before JAX's step donates them
    # JAX's steps in float64: flax's f32 batch variance, E[x^2] - E[x]^2,
    # puts CoAM's second loss 1.07e-4 of itself and HRNet's running means up
    # to 2e-5 from float64 at these weights (test_torch_port_train.py's step
    # test runs JAX in float64 for it too)
    jlosses, jstats = _jax_two_steps(jcfg, jmodel, variables, sample, batch, x64=True)
    want_stats = _bn_stats(from_flax({"params": {}, "batch_stats": jstats}))
    assert len(want_stats) > 20
    for dtype in (torch.float32, torch.float64):
        job = {"yaml": yaml, "opts": opts, "state_dict": state_dict, "batches": [batch, batch],
               "dtype": dtype}
        torch.save(job, tmp_path / "train_job.pt")
        outs = tdc.spawn("train", tmp_path)
        one = tdc.train_job(job)
        for out in (*outs, one):
            assert out["loss"] == outs[0]["loss"] or out is one   # global, on every process
            np.testing.assert_allclose(out["loss"], jlosses, rtol=RTOL, atol=ATOL)
            if dtype == torch.float64:
                # the statistics in float64, where the order of the sums is
                # below the tolerance: in f32 it moves one element of HRNet's
                # transition1.0.1 running mean 1.1e-5 from float64
                for key, ref in want_stats.items():
                    np.testing.assert_allclose(out["state_dict"][key].numpy(), ref.numpy(),
                                               rtol=RTOL, atol=ATOL, err_msg=key)
        np.testing.assert_allclose(outs[0]["loss"], one["loss"], rtol=RTOL, atol=ATOL)
        # every process holds the same parameters after the steps
        for key, t in outs[0]["state_dict"].items():
            torch.testing.assert_close(outs[1]["state_dict"][key], t, rtol=0, atol=0)
        assert outs[0]["acc"] == pytest.approx(one["acc"], abs=1e-6)
        assert outs[0]["cnt"] == one["cnt"]


def _run_args(tmp_path, ann_file, *extra):
    return ["--cfg", str(COAM_YAML), "--device", "cpu", *TINY_COAM,
            "DATASET.TRAIN_IMAGE_DIR", str(tmp_path), "DATASET.TRAIN_ANNOTATION_FILE", ann_file,
            "DATASET.TEST_IMAGE_DIR", str(tmp_path), "DATASET.TEST_ANNOTATION_FILE", ann_file,
            "TRAIN.BATCH_SIZE_PER_GPU", "2", "TEST.BATCH_SIZE_PER_GPU", "2", "WORKERS", "1",
            "TPU.MESH_SHAPE", "[2]", "EPOCH_EVAL_FREQ", "1",
            "OUTPUT_DIR", str(tmp_path / "out"), "LOG_DIR", str(tmp_path / "log"), *extra]


RUN = ("import sys; sys.path.insert(0, 'tests'); import torch_cpu_threads; "
       "from buctd_tpu_torch.train import run; r = run.main(sys.argv[1:]); "
       "print('RESULT', r['begin_epoch'], r['steps'], len(r['perf']))")


def _two_processes(args):
    def argv(rank, port):
        flags = ["--coordinator", f"localhost:{port}", "--num-processes", "2",
                 "--process-id", str(rank)]
        return ["-c", RUN, *args[:4], *flags, *args[4:]]

    return [line for out in tdc.spawn_command(argv) for line in out.splitlines()
            if line.startswith("RESULT")]


def test_train_entry_in_two_processes_persists_once_and_resumes(tmp_path):
    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=14)   # 4 samples: a step an epoch
    first = _two_processes(_run_args(tmp_path, ann_file, "TRAIN.END_EPOCH", "2"))
    assert first == ["RESULT 0 2 2"] * 2          # 2 epochs of one global step, 2 validations
    out = Path(glob.glob(str(tmp_path / "out" / "*" / "*" / "*"))[0])
    assert sorted(p.name for p in out.glob("*.pth")) == ["checkpoint.pth", "final_state.pth"]
    assert len(list(out.glob("*.log"))) == 1
    assert len(glob.glob(str(tmp_path / "log" / "**" / "metrics.jsonl"), recursive=True)) == 1
    # both processes evaluated the merged set: process 1 into proc1/
    for root in (out, out / "proc1"):
        assert (root / "results" / "keypoints_test_results_epoch1.json").exists()
    state = torch.load(out / "checkpoint.pth", weights_only=False)
    assert state["epoch"] == 2
    final = torch.load(out / "final_state.pth", weights_only=False)
    for key, t in final.items():
        torch.testing.assert_close(state["state_dict"][key], t, rtol=0, atol=0)
    again = _two_processes(_run_args(tmp_path, ann_file, "TRAIN.END_EPOCH", "3"))
    assert again == ["RESULT 2 1 1"] * 2          # AUTO_RESUME on both processes
