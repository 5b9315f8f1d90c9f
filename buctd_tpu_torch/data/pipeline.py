"""Condition-render dispatch and input-channel rules, the serving subset of
buctd_tpu/data/pipeline.py (:39-69).  The batch loader and the training
target synthesis are not ported yet."""

from __future__ import annotations

from ..ops.heatmap import (render_condition_colored, render_condition_plain,
                           render_condition_stacked)


def condition_mode(cfg) -> str:
    if cfg.DATASET.STACKED_CONDITION:
        return "stacked"
    if cfg.DATASET.COLORED:
        return "colored"
    return "plain"


def num_input_channels(cfg) -> int:
    """3 / 6 / 3+J input channels (tools/train.py:109-121)."""
    if not cfg.MODEL.CONDITIONAL_TOPDOWN:
        return 3
    if cfg.DATASET.STACKED_CONDITION:
        return 3 + int(cfg.MODEL.NUM_JOINTS)
    return 6


def render_condition(cond_joints, mode: str, out_hw, colors=None):
    """Dispatch to the three condition encodings (all return (B, H, W, c))."""
    if mode == "stacked":
        return render_condition_stacked(cond_joints, out_hw)
    if mode == "colored":
        return render_condition_colored(cond_joints, colors, out_hw)
    return render_condition_plain(cond_joints, out_hw)
