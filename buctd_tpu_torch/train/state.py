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
tensors and makes no host sync, so steps queue up on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.loss import make_loss
from ..core.metrics import pck_accuracy
from ..models import autocast, compute_dtype
from ..models.attention import set_dropout_generator
from ..models.remat import checkpoint, remat_mode

_LATER = "ROADMAP Queue 1 item 8, 'training: the rest'"


def check_train_options(cfg) -> None:
    """Raise on the training options of the JAX package not ported yet."""
    unported = [
        (bool(cfg.DEBUG.DEBUG), "DEBUG.DEBUG (train debug image dumps)"),
        (list(cfg.TPU.MESH_SHAPE) not in ([-1], [1]),
         f"TPU.MESH_SHAPE={list(cfg.TPU.MESH_SHAPE)} (a mesh: multi-card DDP)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported to buctd_tpu_torch "
                                      f"yet: {_LATER}")
    remat_mode(cfg)                     # an unknown REMAT_MODE raises here


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
        set_dropout_generator(model, generator)

    def forward(self, x):
        self.model.train()
        with autocast(x.device, self.dtype):
            return checkpoint(self.model, x) if self.remat_forward else self.model(x)

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
        out = self.forward(x)
        loss = self.loss_fn(out.float(), target, weight)
        self.apply(loss)
        with torch.no_grad():
            acc, cnt, _ = pck_accuracy(out.detach().float(), target)
        return {"loss": loss.detach(), "acc": acc, "cnt": cnt}


class DoubleTrainStep(TrainStep):
    """The λ-weighted double-target step (``make_train_step_double``, the
    legacy cutmix/mixup loops' loss, lib/core/train.py:179-343):
    loss = crit(out, target_f, w_f·λ_f) + crit(out, target_b, w_b·λ_b).
    Batch keys: input, target_f, target_b, target_weight_f, target_weight_b,
    lambda_f, lambda_b (B,).  PCK is taken against target_b: the reference
    computes both accuracies and keeps the last (train.py:224-228)."""

    def __call__(self, batch) -> dict:
        out = self.forward(batch["input"]).float()
        w_f = batch["target_weight_f"] * batch["lambda_f"][:, None]
        w_b = batch["target_weight_b"] * batch["lambda_b"][:, None]
        loss = (self.loss_fn(out, batch["target_f"], w_f)
                + self.loss_fn(out, batch["target_b"], w_b))
        self.apply(loss)
        with torch.no_grad():
            acc, cnt, _ = pck_accuracy(out.detach(), batch["target_b"])
        return {"loss": loss.detach(), "acc": acc, "cnt": cnt}


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
        rng = np.random.default_rng([self.seed, self.calls])
        return self.draw_fn(rng, batch["input"].shape[0])

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
