"""Condition-render dispatch and input-channel rules.

Counterpart of buctd_tpu/data/pipeline.py: ``condition_mode``,
``num_input_channels`` and ``render_condition`` (:39-69) for serving and the
device loader.  Not ported yet (ROADMAP Queue 1 item 8): the host cv2
``Loader``, ``device_synthesize_batch`` (TPU.DEVICE_SYNTHESIS) and the
multi-process sharding helpers (:98-141); the port's loader runs in one
process and plans every condition on the host.
"""

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
