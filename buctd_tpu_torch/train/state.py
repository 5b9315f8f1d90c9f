"""Optimizer, LR schedule and the train step.

Counterpart of buctd_tpu/train/state.py.  The optimizer semantics are the
reference's (lib/utils/utils.py:256-272): Adam with the LR only, or
SGD(momentum, nesterov) with the weight decay added to the gradient before
the momentum (``optax.add_decayed_weights``, which torch SGD's
``weight_decay`` is).  The LR follows MultiStepLR on OPTIMIZER steps, with
boundaries at ``epoch * steps_per_epoch`` (optax's
``piecewise_constant_schedule``: step t trains at LR * factor^#(boundaries
<= t)).

``TrainStep`` is the counterpart of ``make_train_step``'s jitted step: a
train-mode forward under ``torch.autocast(bfloat16)`` when
``TPU.COMPUTE_DTYPE`` says so (parameters stay f32), the loss, the backward
and the optimizer step.  It returns ``{loss, acc, cnt}`` as device tensors
and makes no host sync, so steps queue up on the card.
"""

from __future__ import annotations

import torch

from ..core.loss import make_loss
from ..core.metrics import pck_accuracy
from ..models import compute_dtype
from ..models.attention import set_dropout_generator

_LATER = "ROADMAP Queue 1 item 8, 'training: the rest'"


def check_train_options(cfg) -> None:
    """Raise on the training options of the JAX package not ported yet."""
    unported = [
        (int(getattr(cfg.TRAIN, "GRAD_ACCUM_STEPS", 1)) > 1, "TRAIN.GRAD_ACCUM_STEPS > 1"),
        (bool(getattr(cfg.TPU, "FUSED_OPTIMIZER", False)), "TPU.FUSED_OPTIMIZER"),
        (bool(getattr(cfg.TPU, "REMAT", False)), "TPU.REMAT"),
        (bool(cfg.TRAIN.MIX), f"TRAIN.MIX={cfg.TRAIN.MIX!r}"),
        (bool(getattr(cfg.TPU, "DEVICE_SYNTHESIS", False)),
         "TPU.DEVICE_SYNTHESIS (the batched condition sampler, pose_synthesis_jax)"),
        (bool(cfg.DEBUG.DEBUG), "DEBUG.DEBUG (train debug image dumps)"),
        (list(cfg.TPU.MESH_SHAPE) not in ([-1], [1]),
         f"TPU.MESH_SHAPE={list(cfg.TPU.MESH_SHAPE)} (a mesh: multi-card DDP)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported to buctd_tpu_torch "
                                      f"yet: {_LATER}")


def make_optimizer(cfg, model: torch.nn.Module) -> torch.optim.Optimizer:
    check_train_options(cfg)
    params = model.parameters()
    lr = float(cfg.TRAIN.LR)
    if cfg.TRAIN.OPTIMIZER == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=float(cfg.TRAIN.MOMENTUM),
                               weight_decay=float(cfg.TRAIN.WD),
                               nesterov=bool(cfg.TRAIN.NESTEROV))
    if cfg.TRAIN.OPTIMIZER == "adam":
        return torch.optim.Adam(params, lr=lr)   # lr only (utils.py:267-270)
    raise ValueError(f"unknown optimizer {cfg.TRAIN.OPTIMIZER}")


def make_lr_schedule(cfg, optimizer, steps_per_epoch: int):
    """MultiStepLR stepped once per optimizer step."""
    milestones = sorted(int(e) * int(steps_per_epoch) for e in cfg.TRAIN.LR_STEP)
    return torch.optim.lr_scheduler.MultiStepLR(optimizer, milestones,
                                                gamma=float(cfg.TRAIN.LR_FACTOR))


class TrainStep:
    """One optimizer step on a batch ``{'input', 'target', 'target_weight'}``
    (NCHW input, (B, J, h, w) target).  ``generator`` (a CPU
    ``torch.Generator``) seeds the flash attention's dropout masks."""

    def __init__(self, cfg, model, optimizer, scheduler, generator: torch.Generator):
        check_train_options(cfg)
        self.model, self.optimizer, self.scheduler = model, optimizer, scheduler
        self.loss_fn = make_loss(cfg)
        self.dtype = compute_dtype(cfg)
        set_dropout_generator(model, generator)

    def __call__(self, batch) -> dict:
        x, target, weight = batch["input"], batch["target"], batch["target_weight"]
        self.model.train()
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            out = self.model(x)
        loss = self.loss_fn(out.float(), target, weight)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        with torch.no_grad():
            acc, cnt, _ = pck_accuracy(out.detach().float(), target)
        return {"loss": loss.detach(), "acc": acc, "cnt": cnt}
