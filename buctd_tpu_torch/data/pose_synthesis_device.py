"""Generative condition-noise sampler on the card (TPU.DEVICE_SYNTHESIS).

Counterpart of buctd_tpu/data/pose_synthesis_jax.py: the fixed-shape form of
data/pose_synthesis.py's rejection sampler, for a whole batch at once.  The
host sampler runs once a sample inside ``plan_sample``; this one takes the
batch's seeds (``JointsDataset.synthesis_seed``) and returns every
condition pose of the batch.

It has the JAX sampler's reformulations, and so the host sampler's
distributions, not its draws:

  * candidate sets are fixed-size (N per joint, mode and anchor) with
    validity masks; "pick uniformly among kept" is an argmax of uniform
    scores over the mask (``_masked_uniform_pick``);
  * the miss and swap modes pick in two stages: an anchor by a Gumbel draw
    over the kept counts (the gt anchor's weighted 4x in the miss mode,
    the reference's 1/4 subsample of the other anchors), then uniformly
    inside that anchor's kept set;
  * the anchors sit in the fixed layout [gt, swaps(P), inversion(1),
    swap-inversions(P)], A = 2P + 2, and the reference's "special" swap
    slot 1 + len(swaps), which points at the first valid swap-inversion
    anchor when the inversion anchor is absent (pose_synthesis.py:700-711),
    is computed (``special_slot``).

The JAX sampler vmaps one pose and one joint; here the work is batched
tensor ops with explicit axes: (B, J) for the per-joint work, (B, J, A, N)
for the miss and swap candidates.  Distances are compared squared (d^2 > r^2
for d, r >= 0), so no (..., 2) difference tensor is made.  Every random
number comes from the ``torch.Generator`` passed in, on the sampler's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .pose_synthesis import (COCO_SIGMAS, COCO_SYMMETRY, CROWDPOSE_SIGMAS,
                             CROWDPOSE_SYMMETRY, _coco_tables, _crowdpose_tables,
                             _generic_tables)

N = 500  # candidate samples per (joint, mode[, anchor]), as in the reference


class SynthSpec(NamedTuple):
    """The dataset's tables (numpy; the sampler moves them to its device)."""

    sigmas: np.ndarray       # (J,)
    pair: np.ndarray         # (J,) int32, -1 = no symmetric pair
    jitter_v: np.ndarray     # (2, J)  [nv <= thr, nv > thr]
    miss_v: np.ndarray       # (3, J)  [nv <= t0, t0 < nv <= t1, nv > t1]
    inv_v: np.ndarray        # (J,)
    swap_v: np.ndarray       # (2, J)  [rule true, rule false]
    jitter_thr: int
    miss_thr: tuple
    swap_rule: tuple         # (t1, t2, t3): (nv<=t1 and no>0) or (nv<=t2 and no>=t3)


def make_spec(dataset: str, J: int) -> SynthSpec:
    if dataset == "coco":
        sig, sym, tab = COCO_SIGMAS, COCO_SYMMETRY, _coco_tables()
        jt, mt, sr = 10, (5, 10), (10, 15, 3)
        reps_j, reps_m = (1, 11), (1, 6, 11)
    elif dataset == "crowdpose":
        sig, sym, tab = CROWDPOSE_SIGMAS, CROWDPOSE_SYMMETRY, _crowdpose_tables()
        jt, mt, sr = 10, (5, 10), (10, 15, 3)
        reps_j, reps_m = (1, 11), (1, 6, 11)
    else:
        sig, sym, tab = np.full(J, 0.1), [], _generic_tables(J)
        jt, mt, sr = 4, (2, 4), (4, 5, 1)
        reps_j, reps_m = (1, 5), (1, 3, 5)
    pair = np.full(J, -1, np.int32)
    for q, w in sym:
        pair[q], pair[w] = w, q
    return SynthSpec(
        sigmas=np.asarray(sig, np.float32),
        pair=pair,
        jitter_v=np.stack([tab["jitter"](nv) for nv in reps_j]).astype(np.float32),
        miss_v=np.stack([tab["miss"](nv) for nv in reps_m]).astype(np.float32),
        inv_v=tab["inv"](1).astype(np.float32),
        swap_v=np.stack([tab["swap"](1, 1), tab["swap"](99, 0)]).astype(np.float32),
        jitter_thr=jt, miss_thr=mt, swap_rule=sr,
    )


def _gather(x, idx):
    """x (..., K, *rest) at idx (...) along the K axis -> (..., *rest)."""
    rest = x.shape[idx.dim() + 1:]
    i = idx.reshape(*idx.shape, 1, *([1] * len(rest))).expand(*idx.shape, 1, *rest)
    return torch.gather(x, idx.dim(), i).squeeze(idx.dim())


def _masked_uniform_pick(u, pts, keep):
    """Uniform pick among the kept rows: u (..., n) uniform scores in [0, 1),
    pts (..., n, 2), keep (..., n) -> (xy (..., 2), found (...)).  With
    nothing kept every score is -1 and the first row is returned; ``found``
    then zeroes the mode's weight."""
    i = torch.argmax(torch.where(keep, u, -1.0), dim=-1)
    return _gather(pts, i), keep.any(-1)


def _annulus(center, r_lo, r_hi, u_ang, u_r):
    """Points at uniform angle and radius in [r_lo, r_hi) around ``center``,
    from the uniform draws u_ang, u_r (..., n): center (..., 2), r_lo and
    r_hi broadcastable to (...) -> (pts (..., n, 2), r (..., n))."""
    ang = u_ang * (2 * math.pi)
    # a Python float stays one (a scalar made a device tensor is a copy)
    r_lo, r_hi = (x[..., None] if torch.is_tensor(x) else x for x in (r_lo, r_hi))
    r = u_r * (r_hi - r_lo) + r_lo                   # jax.random.uniform's form
    r = torch.maximum(r, r_lo) if torch.is_tensor(r_lo) else r.clamp_min(r_lo)
    pts = center[..., None, :] + r[..., None] * torch.stack(
        [torch.cos(ang), torch.sin(ang)], dim=-1)
    return pts, r


def _over(pts, anchors, avalid, exempt, radius):
    """keep mask (..., n): every valid, non-exempt anchor is farther than
    ``radius`` from the sample.  pts (..., n, 2), anchors (..., A, 2),
    avalid and exempt (..., A), radius (...) or (..., n)."""
    radius = torch.as_tensor(radius, dtype=pts.dtype, device=pts.device)
    r2 = (radius * radius)[..., None]
    if r2.dim() < pts.dim():                   # one radius for all n samples
        r2 = r2[..., None]
    d2 = (pts[..., 0, None] - anchors[..., None, :, 0]).square_()
    d2 += (pts[..., 1, None] - anchors[..., None, :, 1]).square_()
    near = (d2 <= r2) & (avalid & ~exempt)[..., None, :]
    return ~near.any(-1)


def special_slot(inv_valid, swapinv_m):
    """The reference's "special" swap-mode slot 1 + len(swaps) in the fixed
    layout: the inversion anchor (P + 1) when present, else the first valid
    swap-inversion anchor, else none (A).  inv_valid (...), swapinv_m
    (..., P) -> (...) int64."""
    P = swapinv_m.shape[-1]
    first_si = P + 2 + torch.argmax(swapinv_m.to(torch.int32), dim=-1)
    none = torch.full_like(first_si, 2 * P + 2)
    return torch.where(inv_valid, torch.full_like(first_si, P + 1),
                       torch.where(swapinv_m.any(-1), first_si, none))


def _gumbel(u):
    """Gumbel draws -log(-log(U)) from uniform draws u in [0, 1), U clamped to
    [tiny, 1) as jax.random.gumbel draws it: finite at u = 0."""
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _log_weights(w, u, floor):
    """Gumbel-perturbed log weights from uniform draws u: -inf where the
    weight is 0."""
    g = torch.log(torch.clamp_min(w, floor)) + _gumbel(u)
    return torch.where(w > 0, g, torch.full_like(g, -math.inf))


_TABLES = ("sigmas", "pair", "jitter_v", "miss_v", "inv_v", "swap_v")


def spec_on(spec: SynthSpec, device) -> SynthSpec:
    """``spec`` with its tables as tensors on ``device`` (a no-op for tables
    already there)."""
    return spec._replace(**{f: torch.as_tensor(getattr(spec, f), device=device)
                            for f in _TABLES})


def synthesize_pose_batch(gen, joints, est, near, near_valid, area, num_overlap,
                          spec: SynthSpec):
    """Batched synthesis on the generator's device.

    joints/est (B, J, 3), near (B, P, J, 3), near_valid (B, P) bool, area (B,),
    num_overlap (B,) -> (B, J, 3) f32.  Makes no host sync once ``spec``'s
    tables are on the device (``spec_on``).
    """
    dev = joints.device
    t = spec_on(spec, dev)
    joints, est, near, area = (x.float() for x in (joints, est, near, area))
    B, J = joints.shape[:2]
    P = near.shape[1]
    A = 2 * P + 2
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731

    var = (t.sigmas * 2.0) ** 2
    ks = {p: torch.sqrt(-2.0 * area[:, None] * var * math.log(p)) for p in (0.10, 0.50, 0.85)}
    ks10, ks50, ks85 = ks[0.10], ks[0.50], ks[0.85]                   # (B, J)

    vis = joints[..., 2] > 0
    synth0 = torch.where(vis[..., None], joints, est)                # (B, J, 3)
    nv = vis.sum(1)

    # mode-probability tables (variant index from nv / num_overlap), (B, J)
    jit_t = t.jitter_v[(nv > spec.jitter_thr).long()]
    miss_t = t.miss_v[(nv > spec.miss_thr[0]).long() + (nv > spec.miss_thr[1]).long()]
    inv_t = t.inv_v.expand(B, J)
    t1, t2, t3 = spec.swap_rule
    s_rule = ((nv <= t1) & (num_overlap > 0)) | ((nv <= t2) & (num_overlap >= t3))
    swap_t = t.swap_v[(~s_rule).long()]

    has_pair = t.pair >= 0                                            # (J,)
    pair_c = t.pair.clamp_min(0).long()
    gt = synth0[..., :2]                                              # (B, J, 2)
    inv_valid = has_pair & (joints[:, pair_c, 2] > 0)                 # (B, J)

    # the fixed anchor layout [gt, swaps(P), inv, swap_inv(P)]: (B, J, A, 2)
    near_vis = (near[..., 2] > 0) & near_valid[..., None]             # (B, P, J)
    swaps = near[..., :2].transpose(1, 2)                             # (B, J, P, 2)
    swap_m = near_vis.transpose(1, 2)
    inv_a = synth0[:, pair_c, :2]
    swapinv = near[:, :, pair_c, :2].transpose(1, 2)
    swapinv_m = near_vis[:, :, pair_c].transpose(1, 2) & has_pair[:, None]
    anchors = torch.cat([gt[:, :, None], swaps, inv_a[:, :, None], swapinv], dim=2)
    avalid = torch.cat([torch.ones_like(inv_valid)[..., None], swap_m,
                        inv_valid[..., None], swapinv_m], dim=2)

    special2 = special_slot(inv_valid, swapinv_m)                     # (B, J)
    slot = torch.arange(A, device=dev)
    ex_gt = (slot == 0).expand(B, J, A)
    ex_sp2 = slot == special2[..., None]                              # (B, J, A)

    # jitter: annulus (ks85, ks50) of gt, per-sample-r rejection
    pts, r = _annulus(gt, ks85, ks50, rand(B, J, N), rand(B, J, N))
    keep = _over(pts, anchors, avalid, ex_gt, r)
    xy_j, f_j = _masked_uniform_pick(rand(B, J, N), pts, keep)

    # miss: annulus (ks50, ks10) of EVERY anchor, fixed-ks50 rejection;
    # two-stage pick with the gt anchor's weight x4
    pts_a, _ = _annulus(anchors, ks50[..., None], ks10[..., None],
                        rand(B, J, A, N), rand(B, J, A, N))           # (B, J, A, N, 2)
    own = torch.eye(A, dtype=torch.bool, device=dev)                  # anchor m exempts m
    keep_a = avalid[..., None] & _over(pts_a, anchors[:, :, None], avalid[:, :, None],
                                       own, ks50[..., None])          # (B, J, A, N)
    w = keep_a.sum(-1).float() * torch.where(slot == 0, 4.0, 1.0)
    c = torch.argmax(_log_weights(w, rand(*w.shape), 1e-9), dim=-1)
    xy_m, _ = _masked_uniform_pick(rand(B, J, N), _gather(pts_a, c), _gather(keep_a, c))
    f_m = (w > 0).any(-1)

    # inversion: disk (0, ks50) of the pair anchor, per-sample-r rejection
    pts, r = _annulus(inv_a, 0.0, ks50, rand(B, J, N), rand(B, J, N))
    keep = inv_valid[..., None] & _over(pts, anchors, avalid, ex_sp2, r)
    xy_i, f_i = _masked_uniform_pick(rand(B, J, N), pts, keep)

    # swap: disks around the non-gt, non-special anchors; the rejection tests
    # ONLY the gt and special slots (pose_synthesis.py:700-711), so those two
    # are the anchors _over sees; uniform pick over the union = two-stage
    # pick weighted by the kept counts
    pts_s, r_s = _annulus(anchors, 0.0, ks50[..., None], rand(B, J, A, N), rand(B, J, A, N))
    sp = special2.clamp_max(A - 1)
    tested = torch.stack([anchors[:, :, 0], _gather(anchors, sp)], dim=2)   # (B, J, 2, 2)
    tested_ok = torch.stack([torch.ones_like(inv_valid),
                             _gather(avalid, sp) & (special2 < A)], dim=2)
    ok = avalid & ~ex_gt & ~ex_sp2                                    # (B, J, A)
    keep_s = ok[..., None] & _over(pts_s, tested[:, :, None], tested_ok[:, :, None],
                                   torch.zeros_like(tested_ok[:, :, None]), r_s)
    ws = keep_s.sum(-1).float()
    cs = torch.argmax(_log_weights(ws, rand(*ws.shape), 1e-9), dim=-1)
    xy_s, _ = _masked_uniform_pick(rand(B, J, N), _gather(pts_s, cs), _gather(keep_s, cs))
    f_s = (ws > 0).any(-1)

    # good: disk (0, ks85) of gt, N/4 samples, per-sample-r rejection
    pts, r = _annulus(gt, 0.0, ks85, rand(B, J, N // 4), rand(B, J, N // 4))
    keep = _over(pts, anchors, avalid, ex_gt, r)
    xy_g, f_g = _masked_uniform_pick(rand(B, J, N // 4), pts, keep)

    cand = torch.stack([xy_j, xy_m, xy_i, xy_s, xy_g], dim=2)         # (B, J, 5, 2)
    found = torch.stack([f_j, f_m, f_i, f_s, f_g], dim=2)
    base = torch.stack([jit_t, miss_t, inv_t, swap_t,
                        1.0 - (jit_t + miss_t + inv_t + swap_t)], dim=2)
    p = base * found
    mode = torch.argmax(_log_weights(p, rand(*p.shape), 1e-12), dim=-1)
    out = torch.cat([_gather(cand, mode), torch.ones_like(xy_j[..., :1])], dim=-1)
    return torch.where((p.sum(-1) > 0)[..., None], out, torch.zeros_like(out))


def pad_near(near_list, J: int, P_max: int):
    """Per-sample (P_i, J, 3) arrays -> (B, P_max, J, 3) f32 and a (B, P_max)
    validity mask, padded or truncated to P_max."""
    B = len(near_list)
    near = np.zeros((B, P_max, J, 3), np.float32)
    near_valid = np.zeros((B, P_max), bool)
    for i, nl in enumerate(near_list):
        nl = np.asarray(nl, np.float32).reshape(-1, J, 3)[:P_max]
        near[i, :len(nl)] = nl
        near_valid[i, :len(nl)] = True
    return near, near_valid


def make_synthesize_fn(cfg, P_max: int = 8, device="cuda"):
    """cfg -> fn(gen, joints, est, near_list, area) -> (B, J, 3) f32 tensor on
    ``device``.  ``near_list`` holds one (P_i, J, 3) array a sample (as the db
    stores them), padded or truncated to P_max; num_overlap is 0 on the
    training path (joints_dataset.py:204-207).  The inputs are copied to
    ``device`` on the current stream; the result stays there."""
    J = int(cfg.MODEL.NUM_JOINTS)
    device = torch.device(device)
    spec = spec_on(make_spec(cfg.DATASET.DATASET, J), device)

    def to_dev(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def fn(gen, joints, est, near_list, area):
        near, near_valid = pad_near(near_list, J, P_max)
        B = len(near_list)
        return synthesize_pose_batch(
            gen, to_dev(joints, np.float32), to_dev(est, np.float32), to_dev(near),
            to_dev(near_valid), to_dev(area, np.float32),
            torch.zeros(B, dtype=torch.int32, device=device), spec)

    return fn
