"""Generative condition-noise sampler ("pose synthesis").

Replaces the reference's per-joint rejection-sampling loops
(lib/dataset/pose_synthesis.py:505-817) with one vectorized numpy engine shared by the
coco / crowdpose / generic(fish) variants — the variants differ only in OKS sigmas,
symmetry pairs, and the per-joint-group probability tables.

Behavioral contract (same distributions as the reference):
  * condition starts from GT; invisible joints are replaced by the estimated
    (BU-model) joints (:516-518).
  * per joint, five error modes are sampled in OKS-isodistance annuli around four
    anchor groups [gt, swap (same joint of nearby poses), inversion (left/right pair),
    swap-inversion]:
      - jitter: r in (ks85, ks50) of gt, rejected within r of any other anchor
      - miss:   r in (ks50, ks10) of EVERY anchor, rejected within ks50 of the others;
                non-gt anchor candidate sets are subsampled to 1/4 (:631-641)
      - inversion: r in (0, ks50) of the pair joint, rejected within r of others
      - swap:   r in (0, ks50) of each swap/swap-inv anchor, rejected within r of the
                gt and inversion anchors only (:708-711)
      - good:   r in (0, ks85) of gt (N/4 samples), rejected within r of others
  * mode probabilities come from per-dataset tables keyed on joint group,
    #visible joints, and #overlapping poses; infeasible modes get probability 0 and
    the rest renormalize; all-infeasible -> the joint is zeroed (:758-767).

Known reference quirk reproduced on purpose: the crowdpose jitter table has no branch
for head/neck (j=12,13), so python falls through with the value left over from j=11 —
i.e. head/neck inherit the ankle/knee jitter probability (pose_synthesis.py:289-302).

This runs host-side (numpy) in the input pipeline workers.

The port's own copy of buctd_tpu/data/pose_synthesis.py (numpy only): the
port imports nothing of the JAX package.  Its draws come from numpy's global
RandomState, in the JAX package's order, so seeded runs synthesize the same
conditions in both packages.
"""

from __future__ import annotations

import numpy as np

N = 500  # candidate samples per (joint, mode), as in the reference


# ---------------------------------------------------------------------------
# per-dataset specs
# ---------------------------------------------------------------------------

COCO_SIGMAS = np.array([.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
                        1.07, 1.07, .87, .87, .89, .89]) / 10.0
COCO_SYMMETRY = [(1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16)]

CROWDPOSE_SIGMAS = np.array([.79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87,
                             .89, .89, .79, .79]) / 10.0
CROWDPOSE_SYMMETRY = [(0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11)]


def _groups(J, *ranges):
    """Build a (J,) int group-id array from [(ids..., gid), ...]."""
    g = np.zeros(J, np.int64)
    for ids, gid in ranges:
        g[list(ids)] = gid
    return g


def _coco_tables(J=17):
    face = range(0, 5)
    jitter_g = _groups(J, ([0, 13, 14, 15, 16], 0), (range(1, 11), 1), ([11, 12], 2))
    miss_g = _groups(J, (face, 0), ([5, 6, 15, 16], 1), ([7, 8, 9, 10, 11, 12, 13, 14], 2))
    inv_g = _groups(J, (face, 0), (range(5, 11), 1), (range(11, 17), 2))
    swap_g = inv_g
    return {
        "jitter": lambda nv: (np.array([.15, .20, .25]) if nv <= 10
                              else np.array([.10, .15, .20]))[jitter_g],
        "miss": lambda nv: (np.array([.15, .20, .25]) if nv <= 5 else
                            np.array([.10, .13, .15]) if nv <= 10 else
                            np.array([.02, .05, .10]))[miss_g],
        "inv": lambda nv: np.array([.01, .03, .06])[inv_g],
        "swap": lambda nv, no: (np.array([.02, .15, .10])
                                if (nv <= 10 and no > 0) or (nv <= 15 and no >= 3)
                                else np.array([.01, .06, .03]))[swap_g],
    }


def _crowdpose_tables(J=14):
    # groups: 0 = ankle/knee (8-11), 1 = upper body (0-5), 2 = hip (6-7),
    # head/neck (12-13) fall through to group 0 (the reference's leftover-variable bug)
    jitter_g = _groups(J, (range(8, 12), 0), (range(0, 6), 1), ([6, 7], 2), ([12, 13], 0))
    miss_g = _groups(J, ([12, 13], 0), ([0, 1, 8, 9], 1),
                     ([2, 3, 4, 5, 6, 7, 10, 11], 2))
    inv_g = _groups(J, ([12, 13], 0), (range(0, 6), 1), (range(6, 12), 2))
    swap_g = inv_g
    return {
        "jitter": lambda nv: (np.array([.15, .20, .25]) if nv <= 10
                              else np.array([.10, .15, .20]))[jitter_g],
        "miss": lambda nv: (np.array([.15, .20, .25]) if nv <= 5 else
                            np.array([.10, .13, .15]) if nv <= 10 else
                            np.array([.02, .05, .10]))[miss_g],
        "inv": lambda nv: np.array([.01, .03, .06])[inv_g],
        "swap": lambda nv, no: (np.array([.02, .15, .10])
                                if (nv <= 10 and no > 0) or (nv <= 15 and no >= 3)
                                else np.array([.01, .06, .03]))[swap_g],
    }


def _generic_tables(J):
    # fish/animal variant (pose_synthesis.py:6-233): flat tables
    ones = np.zeros(J, np.int64)
    return {
        "jitter": lambda nv: (np.array([.20]) if nv <= 4 else np.array([.15]))[ones],
        "miss": lambda nv: (np.array([.20]) if nv <= 2 else
                            np.array([.13]) if nv <= 4 else np.array([.05]))[ones],
        "inv": lambda nv: np.array([.03])[ones],
        "swap": lambda nv, no: (np.array([.10])
                                if (nv <= 4 and no > 0) or (nv <= 5 and no >= 1)
                                else np.array([.04]))[ones],
    }


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _pick(rng, x, y):
    i = rng.randint(0, len(x))
    return np.array([x[i], y[i], 1.0])


def _annulus(rng, center, r_lo, r_hi, n):
    ang = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(r_lo, r_hi, n)
    return center[0] + r * np.cos(ang), center[1] + r * np.sin(ang), r


def _reject(x, y, anchors, skip, radius):
    """Keep samples farther than ``radius`` (scalar or per-sample) from every anchor
    except the indices in ``skip``."""
    mask = np.ones(len(x), bool)
    for i, a in enumerate(anchors):
        if i in skip:
            continue
        mask &= np.hypot(a[0] - x, a[1] - y) > radius
    return x[mask], y[mask]


def _synthesize(sigmas, symmetry, tables, joints, estimated_joints, near_joints,
                area, num_overlap, rng):
    J = len(sigmas)
    pair_of = {}
    for q, w in symmetry:
        pair_of[q] = w
        pair_of[w] = q

    var = (np.asarray(sigmas) * 2) ** 2
    ks10 = np.sqrt(-2 * area * var * np.log(0.10))
    ks50 = np.sqrt(-2 * area * var * np.log(0.50))
    ks85 = np.sqrt(-2 * area * var * np.log(0.85))

    synth = np.array(joints, np.float64, copy=True)
    for j in range(J):
        if joints[j, 2] == 0:
            synth[j] = estimated_joints[j]
    nv = int(np.sum(joints[:, 2] > 0))

    jitter_t = tables["jitter"](nv)
    miss_t = tables["miss"](nv)
    inv_t = tables["inv"](nv)
    swap_t = tables["swap"](nv, num_overlap)

    near = np.asarray(near_joints, np.float64)
    if near.ndim != 3:
        near = near.reshape(0, J, 3)

    for j in range(J):
        gt = synth[j, :2]
        swaps = near[near[:, j, 2] > 0, j, :2] if len(near) else np.empty((0, 2))
        pair = pair_of.get(j)
        has_inv = pair is not None and joints[pair, 2] > 0
        inv_anchor = synth[pair, :2][None] if has_inv else np.empty((0, 2))
        swap_inv = (near[near[:, pair, 2] > 0, pair, :2]
                    if pair is not None and len(near) else np.empty((0, 2)))
        anchors = np.concatenate([gt[None], swaps, inv_anchor, swap_inv])
        inv_idx = 1 + len(swaps)  # index of the inversion anchor when it exists

        # jitter: annulus (ks85, ks50) around gt, per-sample-r rejection
        x, y, r = _annulus(rng, gt, ks85[j], ks50[j], N)
        x, y = _reject(x, y, anchors, {0}, r)
        s_jitter = _pick(rng, x, y) if len(x) else np.zeros(3)

        # miss: annulus (ks50, ks10) around every anchor, fixed-ks50 rejection
        pts = []
        for m, a in enumerate(anchors):
            x, y, _ = _annulus(rng, a, ks50[j], ks10[j], 4 * N)
            x, y = _reject(x, y, anchors, {m}, ks50[j])
            if len(x) == 0:
                continue
            if m > 0:  # non-gt anchors subsampled to 1/4 (pose_synthesis.py:636-638)
                idx = rng.choice(range(len(x)), size=len(x) // 4)
                x, y = np.take(x, idx), np.take(y, idx)
            if len(x):
                pts.append(np.stack([x, y], 1))
        if pts:
            pts = np.concatenate(pts)
            s_miss = np.array([*pts[rng.randint(0, len(pts))], 1.0])
        else:
            s_miss = np.zeros(3)

        # inversion: disk (0, ks50) around the pair joint
        s_inv = np.zeros(3)
        if has_inv:
            x, y, r = _annulus(rng, anchors[inv_idx], 0, ks50[j], N)
            x, y = _reject(x, y, anchors, {inv_idx}, r)
            if len(x):
                s_inv = _pick(rng, x, y)

        # swap: disks around the non-gt, non-inversion anchors, rejected vs the gt and
        # index-(1+S) anchors only.  NB the reference special-cases index
        # len(gt)+len(swaps) even when the inversion slot is empty (so it then points
        # at the first swap-inv anchor) — reproduced (pose_synthesis.py:700-711).
        s_swap = np.zeros(3)
        if len(swaps) or len(swap_inv):
            special = {0} | ({inv_idx} if inv_idx < len(anchors) else set())
            skip = set(range(len(anchors))) - special
            pts = []
            for m in range(len(anchors)):
                if m in special:
                    continue
                x, y, r = _annulus(rng, anchors[m], 0, ks50[j], N)
                x, y = _reject(x, y, anchors, skip, r)
                if len(x):
                    pts.append(np.stack([x, y], 1))
            if pts:
                pts = np.concatenate(pts)
                s_swap = np.array([*pts[rng.randint(0, len(pts))], 1.0])

        # good: disk (0, ks85) around gt, N/4 samples
        x, y, r = _annulus(rng, gt, 0, ks85[j], N // 4)
        x, y = _reject(x, y, anchors, {0}, r)
        s_good = _pick(rng, x, y) if len(x) else np.zeros(3)

        p = np.array([jitter_t[j], miss_t[j], inv_t[j], swap_t[j],
                      1.0 - (jitter_t[j] + miss_t[j] + inv_t[j] + swap_t[j])])
        cands = [s_jitter, s_miss, s_inv, s_swap, s_good]
        p = p * np.array([c[2] for c in cands])
        tot = p.sum()
        if tot == 0:
            synth[j] = 0
            continue
        synth[j] = cands[rng.choice(5, p=p / tot)]

    return synth


def synthesize_pose(cfg, joints, estimated_joints, near_joints, area, num_overlap,
                    rng=None):
    """Dispatch on cfg.DATASET.DATASET (pose_synthesis.py:779-817).

    joints / estimated_joints: (J, 3); near_joints: (P, J, 3) other poses in the image;
    area: GT bbox area; num_overlap: #poses with IoU > SWAP_OVERLAP.
    Returns the synthesized condition pose (J, 3).
    """
    if rng is None:
        rng = np.random.mtrand._rand  # module-level RNG, like the reference
    J = int(cfg.MODEL.NUM_JOINTS)
    name = cfg.DATASET.DATASET
    if name == "coco":
        sig, sym, tab = COCO_SIGMAS, COCO_SYMMETRY, _coco_tables()
    elif name == "crowdpose":
        sig, sym, tab = CROWDPOSE_SIGMAS, CROWDPOSE_SYMMETRY, _crowdpose_tables()
    else:
        sig, sym, tab = np.full(J, 0.1), [], _generic_tables(J)
    return _synthesize(sig, sym, tab, np.asarray(joints, np.float64),
                       np.asarray(estimated_joints, np.float64),
                       near_joints, float(area), int(num_overlap), rng)
