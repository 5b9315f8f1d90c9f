"""Condition-render dispatch, input-channel rules and batched synthesis.

Counterpart of buctd_tpu/data/pipeline.py: ``condition_mode``,
``num_input_channels`` and ``render_condition`` (:39-69) for serving and the
device loader, and ``device_synthesize_batch`` (:72, TPU.DEVICE_SYNTHESIS).
Not ported yet (ROADMAP Queue 1 item 8): the host cv2 ``Loader`` and the
multi-process sharding helpers (:98-141); the port's loader runs in one
process.
"""

from __future__ import annotations

import numpy as np
import torch

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


def render_condition(cond_joints, mode: str, out_hw, colors=None, tf32: bool = False):
    """Dispatch to the three condition encodings (all return (B, H, W, c));
    ``tf32``: the sums over joints take TF32 operands (ops/heatmap.py)."""
    if mode == "stacked":
        return render_condition_stacked(cond_joints, out_hw)
    if mode == "colored":
        return render_condition_colored(cond_joints, colors, out_hw, tf32)
    return render_condition_plain(cond_joints, out_hw, tf32)


def synthesis_generator(device, seed: int, step: int) -> torch.Generator:
    """The sampler's generator for one batch, on ``device``: its seed derives
    from (loader seed, step), as JAX's ``fold_in(PRNGKey(seed), step)``."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def device_synthesize_batch(loader, idxs):
    """One batched condition synthesis for a whole batch (TPU.DEVICE_SYNTHESIS):
    (J, 3) numpy rows for plan_sample's cond_override, or Nones where the
    loader keeps the host sampler (``loader.device_synth`` unset).

    ``plan_sample`` needs the poses on the host: the BU box and the crop
    affine derive from them.  The loader runs in the prefetch thread while
    the trainer queues steps on the default stream, and a device-to-host copy
    there would wait for every step already queued.  So on CUDA the sampler
    runs on the loader's own stream, its result is copied into pinned memory
    on that stream, and only that stream's event is waited on."""
    if loader.device_synth is None:
        return [None] * len(idxs)
    seeds = [loader.ds.synthesis_seed(loader.ds.db[i]) for i in idxs]
    args = (np.stack([s[0] for s in seeds]), np.stack([s[1] for s in seeds]),
            [s[2] for s in seeds], np.array([s[3] for s in seeds]))
    gen = synthesis_generator(loader.device, loader._synth_seed, loader._synth_step)
    loader._synth_step += 1
    if loader.device.type != "cuda":
        return list(loader.device_synth(gen, *args).numpy())
    stream = loader.synth_stream
    with torch.cuda.stream(stream):
        out = loader.device_synth(gen, *args)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return list(host.numpy())
