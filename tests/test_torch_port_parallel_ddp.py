"""Data-parallel training steps in buctd_tpu_torch against the one-process
steps, on the CPU in real processes over gloo (tests/torch_dist_children.py);
test_torch_port_parallel_train.py holds them to JAX.

* The DDP step in float64 against the one-process step, every tensor of the
  state dict (parameters and BN running statistics) after the steps within
  1e-9 of its largest value, the losses within 1e-6 (the loss is taken in
  f32, core/loss.py): tiny HRNet's and tiny TransPose-H's plain steps (the
  attention dropout at 0), and tiny CoAM's plain step,
  ``GRAD_ACCUM_STEPS 2`` (the first micro-step under ``no_sync``),
  ``TPU.REMAT`` ('modules', 'forward'), ``FUSED_OPTIMIZER`` and both
  ``TRAIN.MIX`` modes (the double step).  In float64 the only gap left is
  the order of the sums, so a wrong gradient, a missed all-reduce or a
  local BatchNorm would show by orders of magnitude.
* The mixed batch of 2 processes equals the one-process batch on the same
  draws bit for bit, the roll's boundary rows (process 1's first row from
  process 0's last, process 0's from process 1's) included.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)

import numpy as np
import pytest
import torch

import disthelp
import torch_dist_children as tdc
from test_torch_port_config import COAM_YAML, TINY_COAM, TINY_TRANSPOSE, TRANSPOSE_YAML
from test_torch_port_parallel_train import F32, HRNET_YAML, SGD, _coam_batch


DDP_CASES = {
    "hrnet": [],
    "transpose_h": [],
    "plain": [],
    "grad_accum": ["TRAIN.GRAD_ACCUM_STEPS", "2"],
    "remat_modules": ["TPU.REMAT", "True", "TPU.REMAT_MODE", "modules"],
    "remat_forward": ["TPU.REMAT", "True", "TPU.REMAT_MODE", "forward"],
    "fused_optimizer": ["TPU.FUSED_OPTIMIZER", "True"],
    "cutmix": ["TRAIN.MIX", "cutmix"],
    "mixup": ["TRAIN.MIX", "mixup"],
}


@pytest.mark.parametrize("case", list(DDP_CASES))
def test_ddp_steps_equal_one_process_in_float64(tmp_path, case):
    from buctd_tpu_torch.models import get_model

    torch.manual_seed(0)
    steps = 4 if case == "grad_accum" else 2
    if case == "hrnet":
        yaml, opts = HRNET_YAML, disthelp.TINY + F32 + SGD
        g = disthelp.global_batch(8)
        batches = [{"input": g["input"].transpose(0, 3, 1, 2),
                    "target": g["target"].transpose(0, 3, 1, 2),
                    "target_weight": g["target_weight"]}] * steps
    elif case == "transpose_h":          # COCO's 17 joints; LayerNorm in the encoder
        yaml, opts = TRANSPOSE_YAML, TINY_TRANSPOSE + F32 + SGD
        batches = [_coam_batch(seed, joints=17) for seed in range(steps)]
    else:
        yaml, opts = COAM_YAML, TINY_COAM + F32 + SGD + DDP_CASES[case]
        batches = [_coam_batch(seed) for seed in range(steps)]
    model = get_model(tdc.load_cfg(yaml, opts), device="cpu")
    for p in model.parameters():                       # O(1) heatmaps, as jax_variables
        if p.dim() > 1:
            torch.nn.init.normal_(p, 0.0, float(p[0].numel()) ** -0.5)
    job = {"yaml": yaml, "opts": opts, "state_dict": model.state_dict(),
           "dtype": torch.float64, "batches": batches}
    torch.save(job, tmp_path / "train_job.pt")
    outs = tdc.spawn("train", tmp_path)
    one = tdc.train_job(job)
    np.testing.assert_allclose(outs[0]["loss"], one["loss"], rtol=1e-6, atol=0)
    moved = 0
    for key, want in one["state_dict"].items():
        got = outs[0]["state_dict"][key]
        if not want.is_floating_point():
            assert torch.equal(got, want), key
            continue
        tol = 1e-9 * float(want.abs().max()) + 1e-13
        assert float((got - want).abs().max()) <= tol, key
        torch.testing.assert_close(outs[1]["state_dict"][key], got, rtol=0, atol=0)
        moved += not torch.equal(want, job["state_dict"][key].double())
    assert moved > 60                 # the steps moved the parameters and statistics


@pytest.mark.parametrize("mode", ["cutmix", "mixup"])
def test_mixed_batch_of_two_processes_is_the_global_batch(tmp_path, mode):
    job = {"yaml": COAM_YAML, "opts": TINY_COAM + ["TRAIN.MIX", mode], "batch": _coam_batch()}
    torch.save(job, tmp_path / "mixed_job.pt")
    outs = tdc.spawn("mixed", tmp_path)
    one = tdc.mixed_batch_job(job)
    assert set(one) == set(outs[0]) >= {"input", "target_b", "lambda_f", "lambda_b"}
    for key, want in one.items():
        torch.testing.assert_close(torch.cat([o[key] for o in outs]), want, rtol=0, atol=0,
                                   msg=key)
    # the boundary rows: each process's first background row is the previous
    # process's last row (process 0's the last process's)
    x = torch.as_tensor(job["batch"]["target"])
    torch.testing.assert_close(outs[1]["target_b"][0], x[3], rtol=0, atol=0)
    torch.testing.assert_close(outs[0]["target_b"][0], x[7], rtol=0, atol=0)
