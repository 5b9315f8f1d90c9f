"""Heatmap losses (lib/core/loss.py), NCHW.

Counterpart of buctd_tpu/core/loss.py (``joints_mse_loss``,
``joints_ohkm_mse_loss``, ``joints_lambda_mse_loss``, ``make_loss``).  The JAX
functions take NHWC maps; these take the port's NCHW layout: pred and target
(B, J, h, w), per-joint weights (B, J).  The soft-argmax experiment
``joints_expectation_loss``, which no path of the JAX package calls, is not
ported.
"""

from __future__ import annotations

import torch


def _weighted_diff(pred, target, target_weight, use_target_weight: bool):
    diff = pred.float() - target.float()
    if use_target_weight:
        diff = diff * target_weight.float()[:, :, None, None]
    return diff


def joints_mse_loss(pred, target, target_weight, use_target_weight: bool = True):
    """1/2 MSE per joint, masked by target_weight, averaged over joints
    (loss.py:17-41); equal per-joint element counts make it one masked mean."""
    return 0.5 * _weighted_diff(pred, target, target_weight, use_target_weight).pow(2).mean()


def joints_lambda_mse_loss(pred, target, target_weight, use_target_weight: bool = True):
    """Per-SAMPLE masked 1/2 MSE (loss.py:43-68), the lambda-conditioned
    (MIPNet-heritage) variant: joints_mse_loss reduced per sample, (B,)."""
    return 0.5 * _weighted_diff(pred, target, target_weight,
                                use_target_weight).pow(2).mean(dim=(1, 2, 3))


def joints_ohkm_mse_loss(pred, target, target_weight, topk: int = 8,
                         use_target_weight: bool = True):
    """Online hard keypoint mining (loss.py:140-182): per sample, the mean of
    the top-k hardest joints' losses."""
    diff = _weighted_diff(pred, target, target_weight, use_target_weight)
    per_joint = 0.5 * diff.pow(2).mean(dim=(2, 3))                # (B, J)
    top, _ = torch.topk(per_joint, topk, dim=1)
    return (top.sum(dim=1) / topk).mean()


def make_loss(cfg):
    """The loss of the cfg's LOSS block: f(pred, target, target_weight)."""
    use_w = bool(cfg.LOSS.USE_TARGET_WEIGHT)
    if cfg.LOSS.USE_OHKM:
        topk = int(cfg.LOSS.TOPK)
        return lambda pred, target, tw: joints_ohkm_mse_loss(pred, target, tw, topk, use_w)
    return lambda pred, target, tw: joints_mse_loss(pred, target, tw, use_w)
