"""Optimizer, LR schedule and the train steps.

Counterpart of buctd_tpu/train/state.py.  The optimizer semantics are the
reference's (lib/utils/utils.py:256-272): Adam with the LR only, or
SGD(momentum, nesterov) with the weight decay added to the gradient before
the momentum (``optax.add_decayed_weights``, which torch SGD's
``weight_decay`` is).  ``TPU.FUSED_OPTIMIZER`` takes the optimizers'
``fused=True`` form: the same math in one multi-tensor pass a step (the JAX
package runs it over one flat vector).  The LR follows MultiStepLR on
OPTIMIZER steps, with boundaries at ``epoch * steps_per_epoch // k``
(optax's ``piecewise_constant_schedule``: step t trains at LR *
factor^#(boundaries <= t)), k = ``TRAIN.GRAD_ACCUM_STEPS``.

``TrainStep`` is the counterpart of ``make_train_step``'s jitted step: a
train-mode forward under ``torch.autocast(bfloat16)`` when
``TPU.COMPUTE_DTYPE`` says so (parameters stay f32), the loss, the backward
and, every k-th call, the optimizer step on the mean of the k micro-batches'
gradients (``optax.MultiSteps``).  With ``TPU.REMAT`` the model checkpoints
its units (models/remat.py), or the step the whole forward.
``DoubleTrainStep`` (``make_train_step_double``) takes a double-target batch;
``MixedTrainStep`` (``make_train_step_mixed``) mixes a plain batch first
(train/mixing.py, TRAIN.MIX).  Each returns ``{loss, acc, cnt}`` as device
tensors, and ``TrainStep`` with ``DEBUG.DEBUG`` also the heatmaps ``out``
(for the debug dumps), and makes no host sync, so steps queue up on the
card.

In a run of several processes (torch.distributed, one a card) the steps run
the model under ``DistributedDataParallel``: each process's gradients are
averaged over the processes, so the update is that of the global batch's
mean loss, as JAX's psum-mean under a batch-sharded jit; BatchNorm takes the
global batch's statistics (models/hrnet.py::BatchNorm2d); the first k-1
micro-steps of ``GRAD_ACCUM_STEPS`` run under ``no_sync``; ``loss``, ``acc``
and ``cnt`` are the global batch's (``global_metrics``).  Every process
seeds its dropout generator alike: JAX hashes the masks on the replicated
seed and each shard's local rows (buctd_tpu/ops/flash_attention.py:791-850).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.loss import make_loss
from ..core.metrics import pck_accuracy, pck_counts, pck_from_counts
from ..models import autocast, compute_dtype
from ..models.attention import set_dropout_generator
from ..models.remat import checkpoint, remat_mode
from ..parallel.mesh import fill_mesh_shape
from ..utils import distributed


def check_train_options(cfg) -> None:
    """Raise on training options that cannot run: a ``TPU.MESH_SHAPE`` that
    does not match the run's cards (one a process), an unknown REMAT_MODE."""
    fill_mesh_shape(cfg.TPU.MESH_SHAPE, distributed.process_info()[1])
    remat_mode(cfg)


def global_metrics(loss, out, target):
    """(loss, acc, cnt) of the global batch: the mean of the processes'
    losses (equal row counts), and PCK from the summed per-joint hits and
    counts (core/metrics.py::pck_from_counts), through one all-reduce."""
    import torch.distributed as dist

    world = distributed.process_info()[1]
    hits, counts, _ = pck_counts(out, target)
    vec = torch.cat([loss.detach().float().view(1) / world, hits.float(), counts.float()])
    dist.all_reduce(vec)
    J = hits.shape[0]
    acc, cnt = pck_from_counts(vec[1:J + 1], vec[J + 1:])
    return vec[0], acc, cnt


class _Forward(torch.nn.Module):
    """The model's forward, or with ``remat`` the whole forward as one
    checkpointed unit: the module DDP wraps, so that a recompute runs the
    model's forward and not DDP's."""

    def __init__(self, model, remat: bool):
        super().__init__()
        self.model, self.remat = model, remat

    def forward(self, x):
        return checkpoint(self.model, x) if self.remat else self.model(x)


def accum_steps(cfg) -> int:
    return max(int(cfg.TRAIN.GRAD_ACCUM_STEPS), 1)


def make_optimizer(cfg, model: torch.nn.Module) -> torch.optim.Optimizer:
    check_train_options(cfg)
    params = model.parameters()
    lr = float(cfg.TRAIN.LR)
    fused = bool(cfg.TPU.FUSED_OPTIMIZER) or None
    if cfg.TRAIN.OPTIMIZER == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=float(cfg.TRAIN.MOMENTUM),
                               weight_decay=float(cfg.TRAIN.WD),
                               nesterov=bool(cfg.TRAIN.NESTEROV), fused=fused)
    if cfg.TRAIN.OPTIMIZER == "adam":
        return torch.optim.Adam(params, lr=lr, fused=fused)   # lr only (utils.py:267-270)
    raise ValueError(f"unknown optimizer {cfg.TRAIN.OPTIMIZER}")


def make_lr_schedule(cfg, optimizer, steps_per_epoch: int):
    """MultiStepLR stepped once per optimizer step; ``steps_per_epoch``
    counts the loader's batches, k of which make one optimizer step."""
    per_epoch = max(int(steps_per_epoch) // accum_steps(cfg), 1)
    milestones = sorted(int(e) * per_epoch for e in cfg.TRAIN.LR_STEP)
    return torch.optim.lr_scheduler.MultiStepLR(optimizer, milestones,
                                                gamma=float(cfg.TRAIN.LR_FACTOR))


class TrainStep:
    """One micro-step on a batch ``{'input', 'target', 'target_weight'}``
    (NCHW input, (B, J, h, w) target); every ``GRAD_ACCUM_STEPS``-th call
    steps the optimizer.  ``generator`` (a CPU ``torch.Generator``) seeds the
    flash attention's dropout masks."""

    def __init__(self, cfg, model, optimizer, scheduler, generator: torch.Generator):
        check_train_options(cfg)
        self.model, self.optimizer, self.scheduler = model, optimizer, scheduler
        self.loss_fn = make_loss(cfg)
        self.dtype = compute_dtype(cfg)
        self.accum = accum_steps(cfg)
        self.micro = 0
        # models without remat units (TransPose-H) and 'forward' checkpoint
        # the whole forward, as the JAX step does
        mode = remat_mode(cfg)
        self.remat_forward = bool(mode) and (mode == "forward" or not hasattr(model, "remat"))
        self.debug = bool(cfg.DEBUG.DEBUG)
        set_dropout_generator(model, generator)
        self.run = _Forward(model, self.remat_forward)
        self.world = distributed.process_info()[1]
        if self.world > 1:
            dev = next(model.parameters()).device
            self.run = torch.nn.parallel.DistributedDataParallel(
                self.run, device_ids=[dev] if dev.type == "cuda" else None,
                broadcast_buffers=False)   # global BN keeps them equal on every process

    def forward(self, x):
        self.model.train()
        with autocast(x.device, self.dtype):
            return self.run(x)

    def sync(self):
        """The context of one micro-step: DDP's ``no_sync`` for the first
        k-1 of ``GRAD_ACCUM_STEPS`` in a run of several processes (their
        gradients accumulate locally and the k-th averages the sum)."""
        if self.world > 1 and self.micro < self.accum - 1:
            return self.run.no_sync()
        return contextlib.nullcontext()

    def metrics(self, loss, out, target) -> dict:
        """{loss, acc, cnt} of the batch: the global batch's in a run of
        several processes."""
        with torch.no_grad():
            if self.world > 1:
                loss, acc, cnt = global_metrics(loss, out, target)
            else:
                loss = loss.detach()
                acc, cnt, _ = pck_accuracy(out, target)
        return {"loss": loss, "acc": acc, "cnt": cnt}

    def apply(self, loss) -> None:
        """Backward; the optimizer step on the k-th micro-batch, with the
        gradients summed over the k then divided by k (their mean)."""
        if self.micro == 0:
            self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.micro += 1
        if self.micro < self.accum:
            return
        if self.accum > 1:
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            torch._foreach_div_(grads, float(self.accum))
        self.optimizer.step()
        self.scheduler.step()
        self.micro = 0

    def __call__(self, batch) -> dict:
        x, target, weight = batch["input"], batch["target"], batch["target_weight"]
        with self.sync():
            out = self.forward(x)
            loss = self.loss_fn(out.float(), target, weight)
            self.apply(loss)
        metrics = self.metrics(loss, out.detach().float(), target)
        if self.debug:
            # the heatmaps, for train_epoch's debug dumps (JAX state.py:179-181)
            metrics["out"] = out.detach()
        return metrics


class DoubleTrainStep(TrainStep):
    """The λ-weighted double-target step (``make_train_step_double``, the
    legacy cutmix/mixup loops' loss, lib/core/train.py:179-343):
    loss = crit(out, target_f, w_f·λ_f) + crit(out, target_b, w_b·λ_b).
    Batch keys: input, target_f, target_b, target_weight_f, target_weight_b,
    lambda_f, lambda_b (B,).  PCK is taken against target_b: the reference
    computes both accuracies and keeps the last (train.py:224-228)."""

    def __call__(self, batch) -> dict:
        with self.sync():
            out = self.forward(batch["input"]).float()
            w_f = batch["target_weight_f"] * batch["lambda_f"][:, None]
            w_b = batch["target_weight_b"] * batch["lambda_b"][:, None]
            loss = (self.loss_fn(out, batch["target_f"], w_f)
                    + self.loss_fn(out, batch["target_b"], w_b))
            self.apply(loss)
        return self.metrics(loss, out.detach(), batch["target_b"])


class MixedTrainStep(DoubleTrainStep):
    """Cutmix/mixup (``make_train_step_mixed``): a plain batch is mixed on its
    device (train/mixing.py) and trained with the double loss.  The draws of
    call t come from ``numpy.random.default_rng([seed, t])``."""

    def __init__(self, cfg, model, optimizer, scheduler, generator: torch.Generator,
                 seed: int = 0):
        from .mixing import make_mix_fn

        super().__init__(cfg, model, optimizer, scheduler, generator)
        mix = make_mix_fn(cfg)
        if mix is None:
            raise ValueError("TRAIN.MIX must be 'cutmix' or 'mixup' for the mixed step")
        self.draw_fn, self.mix_fn = mix
        self.seed, self.calls = int(seed), 0

    def draw(self, batch) -> dict:
        """The call's draws for this process's rows: drawn for the global
        batch on every process alike, then its rows taken
        (train/mixing.py::local_rows)."""
        from .mixing import local_rows

        rng = np.random.default_rng([self.seed, self.calls])
        B = batch["input"].shape[0]
        return local_rows(self.draw_fn(rng, B * distributed.process_info()[1]), B)

    def __call__(self, batch) -> dict:
        draws = self.draw(batch)
        self.calls += 1
        return super().__call__(self.mix_fn(batch, draws))


def make_train_step(cfg, model, optimizer, scheduler, generator: torch.Generator,
                    seed: int = 0) -> TrainStep:
    """The step tools/train.py:144-152 picks: mixed with TRAIN.MIX, else plain."""
    if cfg.TRAIN.MIX:
        return MixedTrainStep(cfg, model, optimizer, scheduler, generator, seed)
    return TrainStep(cfg, model, optimizer, scheduler, generator)
