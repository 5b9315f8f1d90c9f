"""Heatmap-space PCK@0.5 training metric (lib/core/evaluate.py:15-70).

Counterpart of buctd_tpu/core/metrics.py::pck_accuracy, on the device with no
host sync: argmax coords of predicted and target maps, distances normalized
by heatmap_size / 10, hits among joints whose target coords are > 1 on both
axes.
"""

from __future__ import annotations

import torch

from ..ops.decode import get_max_preds


def pck_counts(pred_heatmaps, target_heatmaps, thr: float = 0.5):
    """Inputs (B, J, h, w).  Returns the per-joint hits and valid counts
    (J,) and the predicted coords: what ``pck_from_counts`` reduces, and
    what processes sum to take the PCK of their global batch."""
    _, _, h, w = pred_heatmaps.shape
    pred, _ = get_max_preds(pred_heatmaps)     # bf16 maps: argmax on bf16, as JAX
    gt, _ = get_max_preds(target_heatmaps)
    # reference quirk kept: norm = [h, w] / 10 divides (x, y) (evaluate.py:50-53)
    norm = torch.tensor([h, w], dtype=torch.float32, device=pred.device) / 10.0
    valid = (gt[..., 0] > 1) & (gt[..., 1] > 1)                   # (B, J)
    dist = torch.linalg.norm((pred - gt) / norm, dim=-1)
    hit = (dist < thr) & valid
    return hit.sum(dim=0), valid.sum(dim=0), pred


def pck_from_counts(hits, per_joint_cnt):
    """(avg_acc, cnt) from per-joint hits and valid counts (J,)."""
    has = per_joint_cnt > 0
    per_joint_acc = hits / per_joint_cnt.clamp(min=1)
    n_valid = has.sum()
    avg = torch.where(has, per_joint_acc, torch.zeros_like(per_joint_acc)).sum()
    avg = torch.where(n_valid > 0, avg / n_valid.clamp(min=1), torch.zeros_like(avg))
    return avg, n_valid


def pck_accuracy(pred_heatmaps, target_heatmaps, thr: float = 0.5):
    """Inputs (B, J, h, w).  Returns (avg_acc, cnt, pred_coords) as tensors.

    cnt is the number of joint TYPES with any valid sample (<= J), what the
    reference feeds its AverageMeter (evaluate.py:60-70).
    """
    hits, per_joint_cnt, pred = pck_counts(pred_heatmaps, target_heatmaps, thr)
    avg, n_valid = pck_from_counts(hits, per_joint_cnt)
    return avg, n_valid, pred
