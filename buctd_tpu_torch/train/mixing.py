"""Cutmix / mixup batch construction on the card (TRAIN.MIX).

Counterpart of buctd_tpu/train/mixing.py (reference lib/core/train.py:
179-343), NCHW.  The "background" sample is the batch rolled by one along the
batch axis, λ is drawn per sample from Beta(α, α), and the input is either

  * mixup:  x = λ·x_f + (1-λ)·x_b (all channels, the condition's too), or
  * cutmix: a box of area fraction 1-λ of the background pasted into the
    foreground at the same place, λ then recomputed as the exact pasted
    fraction, so λ_f + λ_b = 1.

Targets are not spliced: each branch of the double loss sees its whole
target, weighted by its λ (train.py:206-211).

Each function is a draw and a mix.  The draws (λ, and cutmix's box centre
as uniforms in [0, 1)) come from a numpy ``Generator`` on the host: B
scalars a step, so no device sync; ``torch.distributions.Beta`` takes no
generator.  The mix is deterministic given the draws and runs on the
batch's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import distributed


def _previous_last_rows(tensors) -> list:
    """The last row of each of ``tensors`` on the previous process (process
    0: the last process), through one all-gather of every process's last
    rows."""
    import torch.distributed as dist

    rank, world = distributed.process_info()
    wide = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    last = torch.cat([t[-1:].reshape(-1).to(wide) for t in tensors])
    parts = [torch.empty_like(last) for _ in range(world)]
    dist.all_gather(parts, last)
    flat, rows, at = parts[(rank - 1) % world], [], 0
    for t in tensors:
        size = t[-1:].numel()
        rows.append(flat[at:at + size].view_as(t[-1:]).to(t.dtype))
        at += size
    return rows


def _pair(batch):
    """Foreground = batch, background = the global batch rolled by one
    (pairs i with i-1)."""
    keys = ("input", "target", "target_weight")
    rolled = {k: torch.roll(batch[k], 1, dims=0) for k in keys}
    if distributed.process_info()[1] > 1:
        for k, row in zip(keys, _previous_last_rows([batch[k] for k in keys])):
            rolled[k] = torch.cat([row, rolled[k][1:]])
    return {"target_f": batch["target"], "target_weight_f": batch["target_weight"],
            "target_b": rolled["target"],
            "target_weight_b": rolled["target_weight"]}, rolled["input"]


def local_rows(draws: dict, B: int) -> dict:
    """This process's rows of draws made for the global batch of B rows a
    process (contiguous, in process order); the draws themselves in one
    process."""
    rank, world = distributed.process_info()
    if world == 1:
        return draws
    return {k: v[rank * B:(rank + 1) * B] for k, v in draws.items()}


def _on(x, values, dtype=torch.float32):
    """Host draws onto x's device as ``dtype`` (pinned and asynchronous on
    CUDA)."""
    t = torch.as_tensor(np.array(values)).to(dtype)
    if x.is_cuda:
        t = t.pin_memory()
    return t.to(x.device, non_blocking=True)


def draw_mixup(rng: np.random.Generator, B: int, alpha: float) -> dict:
    return {"lam": rng.beta(alpha, alpha, B).astype(np.float32)}


def mixup(batch, lam):
    """Blend each sample with its rolled neighbour by λ (B,): the double-target
    batch (input, target_f/b, target_weight_f/b, lambda_f/b)."""
    x_f = batch["input"]
    out, x_b = _pair(batch)
    lam = _on(x_f, lam, x_f.dtype)
    w = lam[:, None, None, None]
    out["input"] = w * x_f + (1.0 - w) * x_b
    out["lambda_f"], out["lambda_b"] = lam, 1.0 - lam
    return out


def draw_cutmix(rng: np.random.Generator, B: int, alpha: float) -> dict:
    return {"lam": rng.beta(alpha, alpha, B).astype(np.float32),
            "ux": rng.random(B, dtype=np.float32), "uy": rng.random(B, dtype=np.float32)}


def cutmix(batch, lam, ux, uy):
    """Paste the rolled neighbour's box into each sample: the box has sides
    W·sqrt(1-λ) and H·sqrt(1-λ), centre (ux·W, uy·H), clipped to the image;
    λ_b is the pasted fraction, λ_f = 1 - λ_b."""
    x_f = batch["input"]
    B, _, H, W = x_f.shape
    out, x_b = _pair(batch)
    lam, cx, cy = (_on(x_f, v) for v in (lam, ux, uy))
    cut = torch.sqrt(1.0 - lam)
    cw, ch = (W * cut) / 2.0, (H * cut) / 2.0
    cx, cy = cx * W, cy * H
    x0, x1 = (cx - cw).clamp(0, W), (cx + cw).clamp(0, W)
    y0, y1 = (cy - ch).clamp(0, H), (cy + ch).clamp(0, H)
    ys = torch.arange(H, dtype=torch.float32, device=x_f.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=x_f.device)[None, None, :]
    in_box = ((ys >= y0[:, None, None]) & (ys < y1[:, None, None])
              & (xs >= x0[:, None, None]) & (xs < x1[:, None, None]))     # (B, H, W)
    out["input"] = torch.where(in_box[:, None], x_b, x_f)
    acc = torch.promote_types(x_f.dtype, torch.float32)
    lam_b = in_box.to(acc).mean(dim=(1, 2)).to(x_f.dtype)       # the exact pasted fraction
    out["lambda_f"], out["lambda_b"] = 1.0 - lam_b, lam_b
    return out


def make_mix_fn(cfg):
    """cfg.TRAIN.MIX ('', 'cutmix', 'mixup') -> (draw(rng, B), mix(batch,
    draws)), or None when mixing is off.  α is cfg.TRAIN.MIX_ALPHA."""
    mode = str(cfg.TRAIN.MIX).lower()
    if not mode:
        return None
    alpha = float(cfg.TRAIN.MIX_ALPHA)
    if mode == "mixup":
        return (lambda rng, B: draw_mixup(rng, B, alpha),
                lambda batch, d: mixup(batch, d["lam"]))
    if mode == "cutmix":
        return (lambda rng, B: draw_cutmix(rng, B, alpha),
                lambda batch, d: cutmix(batch, d["lam"], d["ux"], d["uy"]))
    raise ValueError(f"unknown TRAIN.MIX {cfg.TRAIN.MIX!r} (want cutmix|mixup)")
