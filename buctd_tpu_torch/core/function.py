"""The train loop (reference: lib/core/function.py:102-175).

Counterpart of buctd_tpu/core/function.py::train_epoch.  ``validate`` and the
lambda sweeps wait for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import logging
import time

from ..utils.prefetch import prefetch

logger = logging.getLogger(__name__)


class AverageMeter:
    """Running average (function.py:360-375)."""

    def __init__(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


def train_epoch(cfg, train_loader, train_step, epoch: int, max_steps=None,
                writer=None) -> dict:
    """One training epoch, or its first ``max_steps`` steps.

    The loader runs ahead in a background thread (``TPU.PREFETCH`` batches).
    Metrics are read on the host only every PRINT_FREQ steps: a read waits
    for the card, so reading every step would fence each step.  Returns the
    per-step host times: ``data_wait_s`` (blocked on the loader),
    ``step_s`` (dispatching the step; the card runs behind it) and the
    per-step metric tensors (``metrics``), still on the device.
    """
    batch_time, data_time = AverageMeter(), AverageMeter()
    losses, acc = AverageMeter(), AverageMeter()
    stats = {"data_wait_s": [], "step_s": [], "metrics": []}
    it = prefetch(train_loader, None, int(getattr(cfg.TPU, "PREFETCH", 2)))
    end = time.perf_counter()
    try:
        for i, batch in enumerate(it):
            got = time.perf_counter()
            data_time.update(got - end)
            metrics = train_step(batch)
            done = time.perf_counter()
            stats["data_wait_s"].append(got - end)
            stats["step_s"].append(done - got)
            stats["metrics"].append(metrics)
            batch_time.update(done - end)
            end = done
            n = batch["input"].shape[0]
            if i % cfg.PRINT_FREQ == 0:
                losses.update(float(metrics["loss"]), n)
                acc.update(float(metrics["acc"]), max(int(metrics["cnt"]), 1))
                logger.info("Epoch: [%d][%d/%d]\tTime %.3fs (%.3fs)\tData %.3fs\t"
                            "Loss %.5f (%.5f)\tAccuracy %.3f (%.3f)", epoch, i,
                            len(train_loader), batch_time.val, batch_time.avg,
                            data_time.val, losses.val, losses.avg, acc.val, acc.avg)
                if writer is not None:
                    writer.add_scalar("train_loss", losses.val)
                    writer.add_scalar("train_acc", acc.val)
            if max_steps is not None and i + 1 >= max_steps:
                break
    finally:
        it.close()
    return stats
