"""Train and validate loops (reference: lib/core/function.py).

Counterpart of buctd_tpu/core/function.py: ``train_epoch``, and the
evaluation ``make_validate_step`` / ``validate``.  The per-batch eval protocol
(forward, the flip test with its condition re-render, flip_back + the 1-px
shift + the average, loss, PCK, decode with POST_PROCESS/DARK and the inverse
affine) is one function on the card, as the JAX step is one jitted program;
the host only gathers (N, J, 3) predictions and calls ``dataset.evaluate``.
With ``TPU.EVAL_DTYPE bfloat16`` the forward runs under bf16 autocast and
everything after it on the bf16 heatmaps, as JAX's bf16 step does: the
flip average and shift in bf16, the loss and PCK, and the decode.
The lambda sweeps (``validate_lambda_quantitative``, ``validate_lambda``) are
not ported: ``check_eval_options`` refuses ``TEST.LAMBDA_SWEEP``.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..data.pipeline import condition_mode, render_condition
from ..geometry import flip_pairs_to_perm
from ..models import autocast, compute_dtype
from ..ops.decode import get_final_preds
from ..utils.prefetch import prefetch
from .loss import make_loss
from .metrics import pck_accuracy

logger = logging.getLogger(__name__)

_EVAL_LEFT = "ROADMAP Queue 1 item 7, 'Evaluation: the rest'"


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


def check_eval_options(cfg) -> None:
    """Raise on the evaluation options of the JAX package not ported yet."""
    unported = [
        (bool(cfg.TEST.LAMBDA_SWEEP), "TEST.LAMBDA_SWEEP (validate_lambda_quantitative)"),
        (bool(cfg.DEBUG.DEBUG), "DEBUG.DEBUG (validation debug image dumps)"),
        (not cfg.TPU.DEVICE_PIPELINE,
         "TPU.DEVICE_PIPELINE False (the host cv2 Loader); pass TPU.DEVICE_PIPELINE True"),
        (list(cfg.TPU.MESH_SHAPE) not in ([-1], [1]),
         f"TPU.MESH_SHAPE={list(cfg.TPU.MESH_SHAPE)} (the eval set sharded over cards)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported to buctd_tpu_torch "
                                      f"yet: {_EVAL_LEFT}")


def make_validate_step(cfg, model, flip_pairs, kpt_colors):
    """One eval step on the model's device: batch -> (preds, maxvals, loss,
    acc, cnt, heatmaps) (buctd_tpu/core/function.py::_make_validate_step).

    The batch is the device loader's: 'input' (B, C, H, W), 'target'
    (B, J, h, w) and 'target_weight' on the device, the meta in numpy.  The
    flip test (function.py:213-236) runs x and its mirror as one 2B forward:
      * colored or plain condition: re-rendered as COLORED from the flipped
        condition joints (x -> img_w - x - 1, pair-swapped, times the
        pair-swapped visibility, as fliplr_joints returns them).  A plain
        condition re-rendered as colored is the reference's quirk (flip_hm
        dispatches on the channel count, transforms.py:37), kept on purpose;
      * stacked condition: channel swap + spatial flip of the rendered map;
      * no condition: the RGB flip alone.
    The flipped output is flipped back (W flip + pair swap), shifted by 1 px
    with SHIFT_HEATMAP, and averaged with the unflipped one.  The forward runs
    in ``TPU.EVAL_DTYPE`` (bf16: autocast; the heatmaps, and what follows
    them, stay bf16); the inputs and the flip test's render stay f32.
    """
    device = next(model.parameters()).device
    dtype = compute_dtype(cfg, "EVAL_DTYPE")
    J = int(cfg.MODEL.NUM_JOINTS)
    perm = torch.as_tensor(flip_pairs_to_perm(J, flip_pairs), device=device)
    img_w, img_h = int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.MODEL.IMAGE_SIZE[1])
    hm_w, hm_h = int(cfg.MODEL.HEATMAP_SIZE[0]), int(cfg.MODEL.HEATMAP_SIZE[1])
    mode = condition_mode(cfg)
    conditional = bool(cfg.MODEL.CONDITIONAL_TOPDOWN)
    flip_test = bool(cfg.TEST.FLIP_TEST)
    shift = bool(cfg.TEST.SHIFT_HEATMAP)
    post_process = bool(cfg.TEST.POST_PROCESS)
    use_dark = bool(cfg.TEST.USE_DARK)
    colors = torch.as_tensor(np.asarray(kpt_colors, np.float32), device=device)
    loss_fn = make_loss(cfg)

    def on_device(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    @torch.inference_mode()
    def step(batch):
        x = batch["input"]
        B = x.shape[0]
        if flip_test:
            x_f = torch.flip(x[:, :3], dims=[3])
            if conditional and mode == "stacked":
                x_f = torch.cat([x_f, torch.flip(x[:, 3:], dims=[3])[:, perm]], 1)
            elif conditional:
                cj = on_device(batch["cond_joints"])
                cv = on_device(batch["cond_joints_vis"])[:, perm]
                cjf = torch.cat([img_w - cj[..., :1] - 1, cj[..., 1:]], dim=-1)[:, perm] * cv
                cond_f = render_condition(cjf, "colored", (img_h, img_w), colors)
                x_f = torch.cat([x_f, cond_f.permute(0, 3, 1, 2)], 1)
            with autocast(device, dtype):
                out_all = model(torch.cat([x, x_f], 0))
            out, out_f = out_all[:B], torch.flip(out_all[B:], dims=[3])[:, perm]
            if shift:
                out_f = torch.cat([out_f[..., :1], out_f[..., :-1]], dim=-1)
            out = (out + out_f) * 0.5
        else:
            with autocast(device, dtype):
                out = model(x)
        loss = loss_fn(out, batch["target"], batch["target_weight"])
        acc, cnt, _ = pck_accuracy(out, batch["target"])
        preds, maxvals = get_final_preds(out, on_device(batch["center"]),
                                         on_device(batch["scale"]), (hm_w, hm_h),
                                         post_process=post_process, use_dark=use_dark)
        return preds, maxvals, loss, acc, cnt, out

    return step


def validate(cfg, val_loader, val_dataset, model, output_dir, epoch=-1, writer=None,
             print_prefix="", stats=None):
    """Full evaluation: loop -> gather -> dataset.evaluate (function.py:178-336).

    Returns (name_values, AP).  The card runs ahead: the step's outputs stay
    on the device until the loop ends (a host read every PRINT_FREQ batches
    for the log), while the loader stages the next batch in its thread.
    ``stats``, a dict, receives the host times of the loop (``loop_s``, to
    the last batch's results on the host) and of ``evaluate``
    (``evaluate_s``), and the number of crops (``crops``).
    """
    check_eval_options(cfg)
    model.eval()
    step = make_validate_step(cfg, model, val_dataset.flip_pairs, val_dataset.kpt_colors)
    losses, acc = AverageMeter(), AverageMeter()
    outs, metas = [], []
    t0 = time.perf_counter()
    it = prefetch(val_loader, None, int(getattr(cfg.TPU, "PREFETCH", 2)))
    try:
        for i, batch in enumerate(it):
            preds, maxvals, loss, a, cnt, _ = step(batch)
            n = int(batch["valid"].sum())
            outs.append((preds[:n], maxvals[:n], loss, a, cnt))
            metas.append({k: batch[k][:n] for k in ("center", "scale", "score",
                                                    "annotation_id", "image_path")})
            if i % cfg.PRINT_FREQ == 0 or i == len(val_loader) - 1:
                logger.info("Test: [%d/%d]\tLoss %.6f\tAccuracy %.3f", i,
                            len(val_loader) - 1, float(loss), float(a))
    finally:
        it.close()
    preds = torch.cat([o[0] for o in outs]).cpu().numpy()
    maxvals = torch.cat([o[1] for o in outs]).float().cpu().numpy()
    for (p, _, loss, a, cnt) in outs:
        losses.update(float(loss), len(p))
        acc.update(float(a), int(cnt))
    t1 = time.perf_counter()

    N = len(preds)
    all_preds = np.zeros((N, int(cfg.MODEL.NUM_JOINTS), 3), np.float32)
    all_preds[:, :, 0:2] = preds[:, :, 0:2]
    all_preds[:, :, 2:3] = maxvals
    c, s = (np.concatenate([m[k] for m in metas]) for k in ("center", "scale"))
    all_boxes = np.zeros((N, 7))
    all_boxes[:, 0:2] = c[:, 0:2]
    all_boxes[:, 2:4] = s[:, 0:2]
    all_boxes[:, 4] = np.prod(s * 200, 1)
    all_boxes[:, 5] = np.concatenate([m["score"] for m in metas])
    all_boxes[:, 6] = np.concatenate([m["annotation_id"] for m in metas])
    image_path = [p for m in metas for p in m["image_path"]]

    name_values, perf = val_dataset.evaluate(cfg, all_preds, str(output_dir), all_boxes,
                                             image_path, epoch)
    t2 = time.perf_counter()
    logger.info("Test%s: %d crops, loop %.3f s (%.2f crops/s), evaluate %.3f s, "
                "loss %.6f, accuracy %.3f", print_prefix, N, t1 - t0,
                N / max(t1 - t0, 1e-9), t2 - t1, losses.avg, acc.avg)
    if stats is not None:
        stats.update(loop_s=t1 - t0, evaluate_s=t2 - t1, crops=N, loss=losses.avg,
                     acc=acc.avg)
    if writer is not None:
        writer.add_scalar("valid_loss", losses.avg)
        writer.add_scalar("valid_acc", acc.avg)
        for k, v in name_values.items():
            writer.add_scalar(f"valid_{k}", v)
    _print_name_value(name_values, type(model).__name__)
    return name_values, perf


def _print_name_value(name_value, full_arch_name):
    """Markdown AP table (function.py:340-357)."""
    if not isinstance(name_value, dict):
        return
    names, values = list(name_value.keys()), list(name_value.values())
    logger.info("| Arch " + " ".join([f"| {n}" for n in names]) + " |")
    logger.info("|---" * (len(names) + 1) + "|")
    if len(full_arch_name) > 15:
        full_arch_name = full_arch_name[:8] + "..."
    logger.info(f"| {full_arch_name} " + " ".join([f"| {v:.3f}" for v in values]) + " |")
