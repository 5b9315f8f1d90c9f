"""Rematerialization (TPU.REMAT, TPU.REMAT_MODE): activation checkpointing.

Counterpart of buctd_tpu/models/hrnet.py::_maybe_remat and ``remat_mode``
(:110-139, :464-472) and the whole-forward ``jax.checkpoint`` of
buctd_tpu/train/state.py (:138-148).  A unit runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: only its inputs
stay resident through the backward, and its forward runs again when its
backward needs the intermediates.  The units are the JAX package's:

  'modules'  the stem + layer1 as one unit and every HRModule as one;
  'blocks'   every residual block (layer1's Bottlenecks, the stages' blocks);
  'stem'     the stem + layer1 only;
  'forward'  the whole forward (train/state.py), also for models without
             units (TransPose-H), as JAX does;

and in every mode but 'forward' the preNet stems, as one unit.

A recompute must run the forward it replays, so two pieces of state that
``checkpoint`` does not restore are handled here:

  * the flash attention's dropout seed is drawn from the trainer's CPU
    ``torch.Generator`` (models/attention.py), which ``preserve_rng_state``
    does not cover; a fresh draw in the recompute would give the backward
    another mask and silently wrong gradients.  ``draw_seed`` records every
    seed a unit draws in its forward and hands the same seeds back, in
    order, to the recompute;
  * BatchNorm in training moves its running statistics in every forward; the
    recompute normalises with the batch statistics again but moves nothing
    (``recomputing``), as flax discards the replay's ``batch_stats``.

The global and CUDA RNGs (``nn.Dropout``) are ``checkpoint``'s own
``preserve_rng_state``.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

MODES = ("stem", "blocks", "modules", "forward")

_STATE = threading.local()


def remat_mode(cfg, is_train: bool = True) -> str:
    """'' (off), 'stem', 'blocks', 'modules' or 'forward'.  Unknown strings
    raise: a typo'd mode would silently train without remat."""
    if not (is_train and bool(getattr(cfg.TPU, "REMAT", False))):
        return ""
    mode = str(getattr(cfg.TPU, "REMAT_MODE", "modules"))
    if mode not in MODES:
        raise ValueError(f"TPU.REMAT_MODE={mode!r}: expected one of {MODES}")
    return mode


class _Tape:
    """The dropout seeds one unit drew in its forward."""

    def __init__(self):
        self.seeds = []
        self.replay = None          # an iterator over ``seeds`` while recomputing


@contextlib.contextmanager
def _active(tape, replay: bool):
    prev = getattr(_STATE, "tape", None)
    tape.replay = iter(list(tape.seeds)) if replay else None
    _STATE.tape = tape
    try:
        yield
    finally:
        _STATE.tape = prev
        tape.replay = None


def draw_seed(generator) -> int:
    """A dropout seed from ``generator`` (the trainer's CPU generator); inside a
    checkpointed unit the forward's seeds are recorded and its recompute
    replays them."""
    tape = getattr(_STATE, "tape", None)
    if tape is not None and tape.replay is not None:
        return next(tape.replay)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    if tape is not None:
        tape.seeds.append(seed)
    return seed


def recomputing() -> bool:
    """True inside the recompute of a checkpointed unit."""
    tape = getattr(_STATE, "tape", None)
    return tape is not None and tape.replay is not None


def checkpoint(fn, *args):
    """``fn(*args)`` as one rematerialized unit."""
    tape = _Tape()
    return _checkpoint(fn, *args, use_reentrant=False,
                       context_fn=lambda: (_active(tape, False), _active(tape, True)))
