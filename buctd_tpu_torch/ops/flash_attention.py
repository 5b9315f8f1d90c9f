"""Flash attention: hand-written CUDA kernels for the forward and backward,
their plain versions, and the autograd Function that training uses.

``flash_attention(q, k, v, scale, dropout, seed)`` computes
``dropout(softmax(q k^T * scale)) @ v`` and the logsumexp of every query row
for the long-sequence token attention of the CoAM position module (L = 6912
at d = 48 and L = 1728 at d = 96 for BUCTD-CoAM-W48).
``flash_attention_train`` wraps it in a ``torch.autograd.Function`` whose
backward runs the two backward kernels: the counterpart of the custom VJP of
buctd_tpu/ops/flash_attention.py::flash_attention (:941-971).

* On CUDA tensors the wrappers launch ``csrc/flash_fwd.cu`` (K1, the port of
  ``_fwd_kernel`` :86) and ``csrc/flash_bwd.cu`` (K2: ``_dq_kernel`` :212 and
  ``_dkv_kernel`` :363).  They launch the kernel or raise; they never fall
  back.  Both run both dtypes on the tensor cores: f32 operands (K1:
  serving and evaluation; K2: the f32 train step) in 3xTF32, f32-accurate
  (``forward_tf32`` and ``backward_tf32`` emulate them), bf16 operands (the
  autocast training step, bf16 serving and evaluation) rounding q * scale,
  p * keep * c, do and ds to bf16 where JAX's kernels do at
  Precision.DEFAULT; the plain versions round there too (``_logits``).
* bf16 K1 and K1' dispatch by shape between two hand-written kernels
  (``takes_wgmma``, the rule of csrc/flash_fwd_wgmma.cuh::takes): the
  TMA + wgmma kernel where the head dim is a multiple of 8 and q, k and v
  start 16-byte aligned (TMA's strides and bases), else the mma.sync kernel
  of csrc/flash_fwd_tc.cuh.  f32 K1 and K1' dispatch by the same rule
  (``takes_wgmma_f32``, csrc/flash_fwd_tf32_wgmma.cuh::takes) between the
  TMA + wgmma 3xTF32 kernel of csrc/flash_fwd_tf32_wgmma.cuh and the
  mma.sync 3xTF32 kernel of csrc/flash_fwd_tf32.cuh.  ``flash_attention_mma``
  launches the mma.sync kernel of either dtype for any call, for timing the
  two in turns.
* bf16 K2 and K2' dispatch the same way (``takes_wgmma_bwd``, the rule of
  csrc/flash_bwd_wgmma.cuh::takes): the TMA + wgmma dq and dk/dv kernels
  where the head dim is a multiple of 8 and q, k, v and the cast do start
  16-byte aligned, else the mma.sync kernels of csrc/flash_bwd_tc.cuh.  f32
  K2 and K2' by the same rule (``takes_wgmma_bwd_f32``,
  csrc/flash_bwd_tf32_wgmma.cuh::takes): the TMA + wgmma 3xTF32 dq and dk/dv
  kernels of csrc/flash_bwd_tf32_wgmma.cuh, else the mma.sync 3xTF32 ones of
  csrc/flash_bwd_tf32.cuh.  ``flash_bwd_dq_mma`` and ``flash_bwd_dkv_mma``
  launch the mma.sync kernels of either dtype for any call, for timing the
  two in turns.
* ``BUCTD_FLASH_KVRES``, read at every call with JAX's rule (:474, :684: any
  value but "0" turns it on), routes CUDA tensors to the kv/q-resident
  kernels instead: ``csrc/flash_fwd_kvres.cu`` (K1', ``_fwd_kernel_kvres``
  :139) in ``flash_attention`` and ``csrc/flash_bwd_kvres.cu`` (K2',
  ``_dq_kernel_kvres`` :245 and ``_dkv_kernel_kvres`` :295) in
  ``flash_attention_backward``.  K1' computes K1's function and K2' K2's, with
  another schedule: K1' is K1's tensor-core kernels and K2' K2's, with a
  deeper ring, in both dtypes, equal to K1 and K2 bit for bit and taking any
  row alignment.  A kv-resident kernel that fails to build or launch raises;
  it never falls back to K1/K2.
* On CPU tensors the wrappers run the plain dense versions
  (``flash_attention_reference``, ``flash_attention_backward_reference``),
  which the CPU tests hold against the JAX kernels.
* ``flash_attention_simt``, ``flash_bwd_dq_simt`` and ``flash_bwd_dkv_simt``
  launch the f32 SIMT kernels (exact f32 on the CUDA cores) that the f32
  paths ran before the 3xTF32 ones; no path calls them: the card tests hold
  the f32 kernels' accuracy at long rows to theirs, and ``chip_smoke.py``
  times the backward's in turns with K2.

Dropout masks: the TPU kernels draw theirs from the TPU PRNG per tile, so
they cannot be reproduced and depend on the tile shape.  Here every weight
(bh, q_row, k_col) has 32 bits from a counter-based hash of
(seed, bh, q_row, k_col) (``csrc/dropout_hash.cuh``; ``dropout_bits`` is the
same hash in int64 torch ops): all the kernels and the plain versions draw
the same mask bit for bit.  As in JAX, an entry is kept when its bits are
>= p * 2^32 and scaled by 1 / (1 - p).

The forward is the operator ``torch.ops.buctd.flash_fwd`` (``flash_fwd_op``,
with a ``register_fake`` for its shapes): ``torch.export`` records it as one
node (serving_export.py), and a CUDA-graph capture records its launch
(graphs.py); ``flash_attention`` checks the operands and calls it.

Launch counts (CPU calls do not count): ``flash_attention.launches`` (K1),
of its bf16 calls ``flash_attention.wgmma_launches`` (the wgmma kernel) and
``flash_attention.mma_launches`` (the mma.sync kernel), and of its f32 calls
``flash_attention.f32_wgmma_launches`` and ``f32_mma_launches`` (likewise);
``flash_bwd_dq.launches`` and ``flash_bwd_dkv.launches`` (K2), each with
``wgmma_launches`` and ``mma_launches`` of its bf16 calls and
``f32_wgmma_launches`` and ``f32_mma_launches`` of its f32 calls;
``flash_attention_kvres.launches`` (K1', with its own four by kernel), ``flash_bwd_dq_kvres.launches`` and
``flash_bwd_dkv_kvres.launches`` (K2', likewise), ``flash_attention_simt.launches``,
``flash_attention_mma.launches``, ``flash_bwd_dq_simt.launches``,
``flash_bwd_dkv_simt.launches``, ``flash_bwd_dq_mma.launches``,
``flash_bwd_dkv_mma.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from .tf32 import tf32_product

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
WGMMA_ROWS = 128   # query rows a block of the wgmma kernel (hw::kRows)
# the wgmma backward kernels (csrc/flash_bwd_wgmma.cuh): a block's own rows
# (q rows for dq, keys for dk/dv; hwb::kRows), dq's key tile and dk/dv's q
# tile by head dim rounded up to 16 (hwb::dq_key_tile, hwb::dkv_q_tile)
WGMMA_BWD_ROWS = 128
WGMMA_DQ_KEY_TILE = 64
WGMMA_DKV_Q_TILE = {"narrow": 64, "wide": 32}
MAX_BH = 65535   # grid.y of the kernels
_MASK32 = 0xFFFFFFFF
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
KVRES_ENV = "BUCTD_FLASH_KVRES"


# ------------------------------------------------------------ dropout bits ----
def _mul32(a, m: int):
    """(a * m) mod 2^32 for int64 tensors a in [0, 2^32) and m < 2^32, in
    16-bit halves so no product leaves int64."""
    return ((a & 0xFFFF) * m + ((((a >> 16) * m) & 0xFFFF) << 16)) & _MASK32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_bits(seed: int, bh: int, lq: int, lk: int, device="cpu", bh0: int = 0):
    """(bh, lq, lk) int64 tensor of the 32 random bits of every attention
    weight, the hash of csrc/dropout_hash.cuh; rows bh0 .. bh0 + bh - 1 of the
    batch-head axis (a slice of a larger call's mask)."""
    b = torch.arange(bh0, bh0 + bh, dtype=torch.int64, device=device)
    r, c = (torch.arange(n, dtype=torch.int64, device=device) for n in (lq, lk))
    bkey = _fmix32((int(seed) + _mul32(b, 0x9E3779B9)) & _MASK32)
    row_key = _fmix32(bkey[:, None] ^ _mul32(r, 0x85EBCA77)[None, :])
    return _fmix32(row_key[:, :, None] ^ _mul32(c, 0xC2B2AE3D)[None, None, :])


def dropout_threshold(p: float) -> int:
    """Keep an entry when its bits are >= this (the JAX rule, :55-59)."""
    return min(int(p * 2.0**32), _MASK32) if p > 0.0 else 0


def _dropout_args(p: float, seed: int) -> tuple:
    """The kernels' (keep_thr, keep_scale, seed) launch arguments."""
    return dropout_threshold(p), 1.0 / (1.0 - p), int(seed)


def dropout_multiplier(seed: int, bh: int, lq: int, lk: int, p: float, device="cpu",
                       bh0: int = 0):
    """(bh, lq, lk) f32: 1 / (1 - p) where kept, 0 where dropped."""
    keep = dropout_bits(seed, bh, lq, lk, device, bh0) >= dropout_threshold(p)
    return keep.float() * (1.0 / (1.0 - p))


def _check_dropout(p: float, seed: int) -> None:
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate {p} not in [0, 1)")
    if not 0 <= int(seed) <= _MASK32:
        raise ValueError(f"dropout seed {seed} not in [0, 2^32)")


# ---------------------------------------------------------- plain versions ----
def _bf16(t):
    """f32 values rounded to bf16 (nearest even) and widened back: the bf16
    operand of one MXU pass."""
    return t.to(torch.bfloat16).float()


def _logits(q, k, scale: float):
    """The rounding rules of every flash kernel, forward and backward, in one
    place: returns (s, q_op), the f32 logits (BH, Lq, Lk) and the f32 q
    operand they were formed from.  f32 operands (JAX's Precision.HIGHEST):
    exact, s = (q k^T) * scale.  bf16 operands (Precision.DEFAULT, one MXU
    pass): q' = bf16(q * bf16(scale)) (JAX :99, :169, :221, :375), s = q' k^T
    with f32 sums; every later product of a bf16 call takes its other f32
    operand through ``_bf16`` (p * keep * c, do, ds)."""
    kt = k.float().transpose(1, 2)
    if q.dtype == torch.bfloat16:
        qs = _bf16(q.float() * float(torch.tensor(scale).to(torch.bfloat16)))
        return torch.matmul(qs, kt), qs
    qs = q.float()
    return torch.matmul(qs, kt) * scale, qs


def flash_attention_reference(q, k, v, scale: float, dropout: float = 0.0,
                              seed: int = 0, bh0: int = 0):
    """Plain version: dense softmax in f32, dropout on the probabilities.
    q (BH, Lq, d), k/v (BH, Lk, d) -> out f32 (BH, Lq, d), lse f32 (BH, Lq)
    (natural log, of the logits before dropout).  ``bh0``: the inputs are
    rows bh0 .. of a larger call, whose dropout mask they take.

    f32 operands: every step in f32.  bf16 operands compute what JAX's
    ``_fwd_kernel`` computes (:99-133): the logits of ``_logits``, m the row
    max, p = exp(s - m) in f32, l = sum(p) over the unrounded p before
    dropout (:116-118), lse = m + ln max(l, 1e-30), and out = (bf16(p keep c)
    @ v) / max(l, 1e-30) with f32 sums (:126-133).  The kernels round p
    relative to the running max of the key tiles seen so far, this dense
    version relative to the final row max: where the running max moves, a p
    can land one bf16 step apart."""
    s, _ = _logits(q, k, scale)
    keep = (dropout_multiplier(seed, *s.shape, dropout, s.device, bh0)
            if dropout > 0.0 else None)
    return forward_from_logits(s, v, keep, q.dtype == torch.bfloat16)


def forward_from_logits(s, v, keep, low: bool):
    """``flash_attention_reference`` from the logits s of ``_logits``:
    ``keep`` the dropout multiplier (or None), ``low`` the bf16 rules."""
    if not low:
        lse = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1)
        if keep is not None:
            p = p * keep
        return torch.matmul(p, v.float()), lse
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if keep is not None:
        p = p * keep
    return torch.matmul(_bf16(p), v.float()) / l, (m + torch.log(l)).squeeze(-1)


# bf16 K1's key tiles, by head dim rounded up to 16: the wgmma kernel's
# (csrc/flash_fwd_wgmma.cuh::key_tile, kWideKeyTile above 64) and the mma.sync
# kernel's (csrc/flash_fwd_tc.cuh::fwd_key_tile)
WGMMA_KEY_TILE = {"narrow": 128, "wide": 96}
MMA_KEY_TILE = {"narrow": 64, "wide": 32}


def _tma_operands(q, k, v) -> bool:
    """The head dim a multiple of 8 and at most 128, q, k and v starting
    16-byte aligned: what the forward's TMA loads take (16-byte strides from
    16-byte aligned bases), in either dtype."""
    d = q.shape[-1]
    return 0 < d <= MAX_HEAD_DIM and d % 8 == 0 and all(t.data_ptr() % 16 == 0
                                                        for t in (q, k, v))


def takes_wgmma(q, k, v) -> bool:
    """Whether bf16 K1 and K1' run the wgmma kernel on these operands
    (csrc/flash_fwd_wgmma.cuh::takes): bf16 and ``_tma_operands``;
    otherwise the mma.sync kernel."""
    return q.dtype == torch.bfloat16 and _tma_operands(q, k, v)


def takes_wgmma_f32(q, k, v) -> bool:
    """Whether f32 K1 and K1' run the TMA + wgmma kernel on these operands
    (csrc/flash_fwd_tf32_wgmma.cuh::takes): f32 and ``_tma_operands``;
    otherwise the mma.sync kernel of csrc/flash_fwd_tf32.cuh."""
    return q.dtype == torch.float32 and _tma_operands(q, k, v)


# f32 K1's wgmma kernel (csrc/flash_fwd_tf32_wgmma.cuh): its key tiles
# (kNarrowKeyTile up to d = 64, kWideKeyTile above, halved until two ring
# slots fit), the slots K1 and K1' ask for (kStages, kKvresStages: the most
# that fit), and the shared memory that decides both (smem_for)
TF32_WGMMA_KEY_TILE = {"narrow": 64, "wide": 32}
TF32_WGMMA_STAGES = {"k1": 2, "k1_kvres": 3}
SMEM_LIMIT = 232448   # a block's shared memory on the H100


def tf32_wgmma_smem(d: int, bk: int, stages: int) -> int:
    """The f32 wgmma kernel's shared memory at head dim d (padded to 16),
    key tile bk and ``stages`` ring slots (csrc/flash_fwd_tf32_wgmma.cuh::
    smem_for): alignment slack, q' hi and lo of 128 rows, 4 tiles a slot
    (K hi, K lo, V^T hi, V^T lo), the barriers."""
    dp = -(-d // 16) * 16
    return 1024 + 2 * WGMMA_ROWS * dp * 4 + stages * 4 * bk * dp * 4 + 8 * (2 + 6 * stages)


def tf32_wgmma_key_tile(d: int) -> int:
    """Keys a tile of the f32 wgmma kernel at head dim d (::key_tile)."""
    bk = TF32_WGMMA_KEY_TILE["narrow" if -(-d // 16) * 16 <= 64 else "wide"]
    while bk > 8 and tf32_wgmma_smem(d, bk, 2) > SMEM_LIMIT:
        bk //= 2
    return bk


def tf32_wgmma_stages(d: int, kvres: bool = False) -> int:
    """Ring slots the f32 wgmma kernel runs at head dim d for K1 or K1'
    (::ring): the slots asked for, fewer where they do not fit (never under
    2)."""
    s = TF32_WGMMA_STAGES["k1_kvres" if kvres else "k1"]
    while s > 2 and tf32_wgmma_smem(d, tf32_wgmma_key_tile(d), s) > SMEM_LIMIT:
        s -= 1
    return s


def takes_wgmma_bwd(q, k, v, dout) -> bool:
    """Whether bf16 K2 and K2' run the wgmma kernels on these operands
    (csrc/flash_bwd_wgmma.cuh::takes): K1's rule (``takes_wgmma``) with do as
    the kernels read it (the bf16 cast of ``_k2_dout``) starting 16-byte
    aligned too; otherwise the mma.sync kernels."""
    return takes_wgmma(q, k, v) and dout.data_ptr() % 16 == 0


def wgmma_bwd_tiles(d: int) -> dict:
    """The wgmma backward kernels' looped tiles at head dim d: dq's keys,
    dk/dv's q rows (64 while d rounded up to 16 is at most 64, else 32)."""
    width = "narrow" if -(-d // 16) * 16 <= 64 else "wide"
    return {"dq": WGMMA_DQ_KEY_TILE, "dkv": WGMMA_DKV_Q_TILE[width]}


def takes_wgmma_bwd_f32(q, k, v, dout) -> bool:
    """Whether f32 K2 and K2' run the TMA + wgmma 3xTF32 kernels on these
    operands (csrc/flash_bwd_tf32_wgmma.cuh::takes): f32, ``_tma_operands``
    and do starting 16-byte aligned too; otherwise the mma.sync kernels of
    csrc/flash_bwd_tf32.cuh."""
    return (q.dtype == torch.float32 and _tma_operands(q, k, v)
            and dout.data_ptr() % 16 == 0)


# f32 K2's wgmma kernels (csrc/flash_bwd_tf32_wgmma.cuh): the plans (consumer
# warpgroups of 64 own rows, looped tile) in order of preference
# (plan_consumers, plan_tile), the slots K2 and K2' ask for (kStages,
# kKvresStages: the most that fit), and the shared memory that decides both
# (smem_for)
TF32_WGMMA_BWD_PLANS = ((2, 32), (1, 32), (1, 16), (1, 8))
TF32_WGMMA_BWD_STAGES = {"k2": 2, "k2_kvres": 3}


def tf32_wgmma_bwd_smem(d: int, dq: bool, consumers: int, tile: int, stages: int) -> int:
    """The f32 wgmma dq (``dq``) or dk/dv kernel's shared memory at head dim
    d (padded to 16) (csrc/flash_bwd_tf32_wgmma.cuh::smem_for): alignment
    slack; the own rows' two operands in hi and lo (64 rows a consumer
    warpgroup); ``stages`` slots of the looped tile (dq: K, V and K^T in hi
    and lo; dk/dv: q', do, q'^T and do^T in hi and lo, and the stats); the
    barriers."""
    dp = -(-d // 16) * 16
    slot = 6 * tile * dp * 4 if dq else 8 * tile * dp * 4 + 3 * tile * 4
    return 1024 + 4 * 64 * consumers * dp * 4 + stages * slot + 8 * (consumers + 3 * stages)


def tf32_wgmma_bwd_plan(d: int, dq: bool) -> tuple:
    """(consumer warpgroups, looped tile) of the f32 wgmma dq (``dq``) or
    dk/dv kernel at head dim d (::plan): the first plan whose two slots fit
    SMEM_LIMIT."""
    for c, t in TF32_WGMMA_BWD_PLANS[:-1]:
        if tf32_wgmma_bwd_smem(d, dq, c, t, TF32_WGMMA_BWD_STAGES["k2"]) <= SMEM_LIMIT:
            return c, t
    return TF32_WGMMA_BWD_PLANS[-1]


def tf32_wgmma_bwd_stages(d: int, dq: bool, kvres: bool = False) -> int:
    """Ring slots the f32 wgmma dq (``dq``) or dk/dv kernel runs at head dim
    d for K2 or K2' (::ring): the slots asked for, fewer where they do not
    fit (never under K2's)."""
    k2 = TF32_WGMMA_BWD_STAGES["k2"]
    s = TF32_WGMMA_BWD_STAGES["k2_kvres" if kvres else "k2"]
    c, t = tf32_wgmma_bwd_plan(d, dq)
    while s > k2 and tf32_wgmma_bwd_smem(d, dq, c, t, s) > SMEM_LIMIT:
        s -= 1
    return s


def fwd_key_tile(d: int, wgmma: bool | None = None) -> int:
    """Keys a tile of the bf16 forward kernel that the dispatch picks at
    head dim d: the wgmma kernel's where ``wgmma`` (by default: d a multiple
    of 8, the dispatch for aligned operands), else the mma.sync kernel's."""
    if wgmma is None:
        wgmma = d % 8 == 0
    tiles = WGMMA_KEY_TILE if wgmma else MMA_KEY_TILE
    return tiles["narrow" if -(-d // 16) * 16 <= 64 else "wide"]


def forward_tile_rounded(s, v, keep, bk: int | None = None):
    """bf16 K1's rounding emulated densely, for the checks: from the logits s
    of ``_logits``, p rounded to bf16 relative to the running row max after
    each key tile of ``bk`` keys (by default ``fwd_key_tile`` of v's head
    dim), in the exp2 domain; l and the rescaling as the kernel's online
    softmax.  ``keep`` the dropout multiplier (or None).  Returns that out,
    and the control: the same with p * keep * c left unrounded, what a kernel
    that skipped the rounding computes."""
    bk = bk or fwd_key_tile(v.shape[-1])
    bh, lq, lk = s.shape
    nt, pad = -(-lk // bk), -lk % bk
    tiles = F.pad(s * _LOG2E, (0, pad), value=float("-inf")).view(bh, lq, nt, bk)
    m = tiles.amax(-1).cummax(-1).values                  # the running max after each tile
    p = torch.exp2(tiles - m[..., None])
    del tiles
    rescale = torch.exp2(m - m[..., -1:])[..., None]
    l = (p * rescale).sum((-1, -2))[..., None].clamp_min(1e-30)
    if keep is not None:
        p = p * F.pad(keep, (0, pad)).view(bh, lq, nt, bk)
    vt = F.pad(v.float(), (0, 0, 0, pad)).view(bh, nt, bk, -1)
    return tuple(torch.einsum("bqtk,btkd->bqd", x * rescale, vt) / l for x in (_bf16(p), p))


def forward_tf32(q, k, v, scale: float, passes: int = 3, keep=None):
    """f32 K1's arithmetic emulated densely, for the checks: the logits in
    the exp2 domain, s = q' k^T with q' = q * scale * log2 e in f32 before
    the split, and p v, each product in ``passes`` tf32 passes (3: 3xTF32,
    the kernel's; 1: plain TF32, the control a single-pass kernel would
    compute); p = exp2(s - m) unrounded, l summed before the dropout
    multiplier ``keep`` (or None).  Returns out f32 (BH, Lq, d) and the
    natural-log lse (BH, Lq).  Nothing on the main path calls it."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    qs = q.float() * (scale * _LOG2E)
    s = tf32_product(qs, k.float().transpose(1, 2), passes)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    del s
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if keep is not None:
        p = p * keep
    out = tf32_product(p, v.float(), passes) / l
    return out, ((m + torch.log2(l)) * _LN2).squeeze(-1)


def bwd_loop_tile(d: int, dq: bool, wgmma: bool | None = None) -> int:
    """f32 K2's looped tile (keys for the dq kernel, q rows for the dk/dv
    kernel) in the kernel that the dispatch picks at head dim d: the wgmma
    kernels' (``tf32_wgmma_bwd_plan``) where ``wgmma`` (by default: d a
    multiple of 8, the dispatch for aligned operands), else the mma.sync
    kernels' (csrc/flash_bwd_tf32.cuh::bwd_loop_tile: dq 64 keys while the
    head dim rounded up to 16 is at most 48, its q' and do fragments in
    registers, else 32; dk/dv 32 q rows)."""
    if wgmma is None:
        wgmma = 0 < d <= MAX_HEAD_DIM and d % 8 == 0
    if wgmma:
        return tf32_wgmma_bwd_plan(d, dq)[1]
    return 64 if dq and -(-d // 16) * 16 <= 48 else 32


def _tf32_folded(a, b, tile: int, passes: int):
    """a @ b with the contraction cut into tiles of ``tile``: each tile's
    product from zero in ``passes`` tf32 passes, the tiles' products summed
    in f32, as f32 K2 folds a looped tile's products into its sums."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1], device=a.device)
    for i in range(0, a.shape[-1], tile):
        out += tf32_product(a[..., i:i + tile], b[..., i:i + tile, :], passes)
    return out


def backward_tf32(q, k, v, dout, lse, delta, scale: float, passes: int = 3, keep=None,
                  wgmma: bool | None = None):
    """f32 K2's arithmetic emulated densely, for the checks: q' = q * scale *
    log2 e rounded to f32, s = q' k^T and g = do v^T, p = exp2(s - lse log2
    e), ds = p (g keep - delta), then dq = (ds k) scale, dv = (p keep)^T do
    and dk = (ds^T q') ln 2, each product in ``passes`` tf32 passes (3: the
    kernels' 3xTF32; 1: the control a single-pass kernel would compute), the
    last three folded over the kernels' looped tiles (``bwd_loop_tile`` of
    the wgmma kernels where ``wgmma``, by default where the dispatch picks
    them for aligned operands, else of the mma.sync kernels).  ``keep`` is
    the dropout multiplier (or None).  Returns f32 dq, dk, dv.  Nothing on
    the main path calls it."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    kf, vf, do = k.float(), v.float(), dout.float()
    qs = q.float() * (scale * _LOG2E)
    p = torch.exp2(tf32_product(qs, kf.transpose(1, 2), passes) - lse[..., None] * _LOG2E)
    g = tf32_product(do, vf.transpose(1, 2), passes)
    pk = p
    if keep is not None:
        g, pk = g * keep, p * keep
    ds = p * (g - delta[..., None])
    d = q.shape[-1]
    t_dq, t_dkv = bwd_loop_tile(d, True, wgmma), bwd_loop_tile(d, False, wgmma)
    dq = _tf32_folded(ds, kf, t_dq, passes) * scale
    dv = _tf32_folded(pk.transpose(1, 2), do, t_dkv, passes)
    dk = _tf32_folded(ds.transpose(1, 2), qs, t_dkv, passes) * _LN2
    return dq, dk, dv


def flash_attention_backward_reference(q, k, v, dout, lse, delta, scale: float,
                                       dropout: float = 0.0, seed: int = 0, bh0: int = 0):
    """Plain backward, written out: p recomputed from lse, g = do v^T masked,
    ds = p (g - delta).  Returns f32 dq, dk, dv.  ``bh0`` as in
    ``flash_attention_reference``.

    f32 operands: every product in f32 (JAX's Precision.HIGHEST).  bf16
    operands: the products take bf16 operands where JAX's kernels round at
    Precision.DEFAULT (the MXU's single bf16 pass) and K2's tensor-core
    kernels do, with f32 sums: q' = bf16(q * bf16(scale)) (:221, :375) for s
    and for dk, which then takes no scale; do (:228, :390); ds (:235, :396);
    p * keep * c for dv (:386)."""
    kf, vf = k.float(), v.float()
    low = q.dtype == torch.bfloat16
    s, qs = _logits(q, k, scale)
    do = _bf16(dout.float()) if low else dout.float()
    p = torch.exp(s - lse[..., None])
    g = torch.matmul(do, vf.transpose(1, 2))
    pk = p
    if dropout > 0.0:
        keep = dropout_multiplier(seed, *s.shape, dropout, s.device, bh0)
        g, pk = g * keep, p * keep
    ds = p * (g - delta[..., None])
    if low:
        ds, pk = _bf16(ds), _bf16(pk)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(1, 2), qs)
    if not low:
        dk = dk * scale
    dv = torch.matmul(pk.transpose(1, 2), do)
    return dq, dk, dv


# ---------------------------------------------------------------- checks ----
def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention wants (BH, L, d) operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, _, d = q.shape
    if k.shape[0] != bh or v.shape[0] != bh or k.shape[1] != v.shape[1]:
        raise ValueError(f"mismatched operands {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[2] != d or v.shape[2] != d:
        raise ValueError(f"flash_attention needs d_k == d_v == d_q, got "
                         f"{d}, {k.shape[2]}, {v.shape[2]}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if bh > MAX_BH:
        raise ValueError(f"BH = {bh} > {MAX_BH}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes f32 or bf16 operands of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous operands")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")


def _check_bwd(q, k, v, dout, lse, delta, dropout: float, seed: int):
    """The backward kernels' operands: those of the forward, then do, lse and
    delta in f32 beside q."""
    _check(q, k, v)
    _check_dropout(dropout, seed)
    bh, lq, d = q.shape
    for name, t, shape in (("dout", dout, (bh, lq, d)), ("lse", lse, (bh, lq)),
                           ("delta", delta, (bh, lq))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous on {q.device}")


def _on_cuda(q, what: str) -> bool:
    """False for CPU tensors (plain version), True for CUDA, else raise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")
    return True


def _require_cuda(q, what: str, plain: str) -> None:
    if not _on_cuda(q, what):
        raise ValueError(f"{what} is a CUDA kernel; CPU tensors take {plain}")


def _check_copyable(*tensors) -> None:
    """f32 K2 and K2' read their operands' rows in 4-byte units (16-byte
    cp.async copies where the rows allow, else through registers): every
    row start must be 4-byte aligned.  (The bf16 kernels read unaligned rows
    through registers: no check.)"""
    for t in tensors:
        row = t.shape[-1] * t.element_size()
        if row % 4 or t.data_ptr() % 4:
            raise ValueError(f"the f32 flash backward kernels read rows in 4-byte "
                             f"units: a {t.dtype} row of {t.shape[-1]} elements "
                             f"({row} bytes) at address {t.data_ptr():#x} is not "
                             f"4-byte aligned")


def kvres_enabled() -> bool:
    """JAX's ``BUCTD_FLASH_KVRES`` rule, read at call time: unset or "0" is
    off, any other value is on."""
    return os.environ.get(KVRES_ENV, "0") != "0"


@functools.lru_cache(maxsize=None)
def _fn(lib: str, symbol: str, argtypes: tuple):
    """A C entry of csrc/<lib>.cu (built and loaded at first call)."""
    from .._build import load

    fn = getattr(load(lib), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_FWD_ARGS = (_P,) * 5 + (_I,) * 4 + (_F, _U, _F, _U, _I, _P)
_DQ_ARGS = (_P,) * 7 + (_I,) * 4 + (_F, _U, _F, _U, _I, _P)
_DKV_ARGS = (_P,) * 8 + (_I,) * 4 + (_F, _U, _F, _U, _I, _P)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str, q, k):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err} at q "
                           f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")


def _launch_fwd(lib: str, q, k, v, scale, dropout, seed, symbol: str = ""):
    """out, lse from the forward kernel of csrc/<lib>.cu (K1 or K1'), through
    its C entry ``symbol`` (default ``buctd_<lib>``)."""
    bh, lq, d = q.shape
    out = torch.empty((bh, lq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _fn(lib, symbol or f"buctd_{lib}", _FWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            bh, lq, k.shape[1], d, float(scale), *_dropout_args(dropout, seed),
            _DTYPE_CODES[q.dtype], _stream(q))
    _raise_on(err, lib, q, k)
    return out, lse


def _launch_dq(lib: str, symbol: str, q, k, v, dout, lse, delta, scale, dropout, seed):
    bh, lq, d = q.shape
    dq = torch.empty((bh, lq, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _fn(lib, symbol, _DQ_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), bh, lq, k.shape[1], d, float(scale),
            *_dropout_args(dropout, seed), _DTYPE_CODES[q.dtype], _stream(q))
    _raise_on(err, symbol, q, k)
    return dq


def _launch_dkv(lib: str, symbol: str, q, k, v, dout, lse, delta, scale, dropout, seed):
    bh, lq, d = q.shape
    lk = k.shape[1]
    dk = torch.empty((bh, lk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((bh, lk, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _fn(lib, symbol, _DKV_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, lq, lk, d,
            float(scale), *_dropout_args(dropout, seed), _DTYPE_CODES[q.dtype],
            _stream(q))
    _raise_on(err, symbol, q, k)
    return dk, dv


# --------------------------------------------------------------- kernels ----
@torch.library.custom_op("buctd::flash_fwd", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, float scale, float dropout, "
                                "int seed, bool kvres) -> (Tensor, Tensor)")
def flash_fwd_op(q, k, v, scale, dropout, seed, kvres):
    """``torch.ops.buctd.flash_fwd``: the forward as one operator, so that
    ``torch.export`` records it as one opaque node (serving_export.py) and a
    loaded program launches the hand kernel.  CUDA tensors launch K1, or K1'
    where ``kvres``; CPU tensors run the plain version; any other device
    raises.  ``flash_attention`` checks the operands and calls it."""
    if not _on_cuda(q, "flash_attention"):
        return flash_attention_reference(q, k, v, scale, dropout, seed)
    if kvres:
        return flash_attention_kvres(q, k, v, scale, dropout, seed)
    out, lse = _launch_fwd("flash_fwd", q, k, v, scale, dropout, seed)
    _count(flash_attention, q, k, v)
    return out, lse


def _count(wrapper, q, k, v) -> None:
    """One launch on ``wrapper`` (K1 or K1'), and on the counter of the
    kernel that its C entry picked by the same rule: ``wgmma_launches`` or
    ``mma_launches`` for bf16 (``takes_wgmma``), ``f32_wgmma_launches`` or
    ``f32_mma_launches`` for f32 (``takes_wgmma_f32``)."""
    wrapper.launches += 1
    if q.dtype == torch.bfloat16:
        kind = "wgmma" if takes_wgmma(q, k, v) else "mma"
    else:
        kind = "f32_wgmma" if takes_wgmma_f32(q, k, v) else "f32_mma"
    name = f"{kind}_launches"
    setattr(wrapper, name, getattr(wrapper, name, 0) + 1)


@flash_fwd_op.register_fake
def _flash_fwd_shapes(q, k, v, scale, dropout, seed, kvres):
    bh, lq, d = q.shape
    return (q.new_empty((bh, lq, d), dtype=torch.float32),
            q.new_empty((bh, lq), dtype=torch.float32))


def flash_attention(q, k, v, scale: float, dropout: float = 0.0, seed: int = 0):
    """out f32 (BH, Lq, d), lse f32 (BH, Lq) of dropout(softmax(q k^T * scale)) @ v.

    q (BH, Lq, d), k/v (BH, Lk, d), one dtype (f32 or bf16), d <= 128,
    contiguous.  CUDA tensors launch K1, or K1' under ``BUCTD_FLASH_KVRES``;
    CPU tensors take the plain version; any other device raises.
    ``dropout`` p in [0, 1) with ``seed`` in [0, 2^32) picks the mask (see
    the module docstring).  Both go through ``torch.ops.buctd.flash_fwd``,
    which takes ``BUCTD_FLASH_KVRES`` as read here: a traced program keeps
    the kernel it was traced with.
    """
    _check(q, k, v)
    _check_dropout(dropout, seed)
    if _on_cuda(q, "flash_attention") and flash_attention.shapes is not None:
        flash_attention.shapes.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2]))
    return torch.ops.buctd.flash_fwd(q, k, v, float(scale), float(dropout), int(seed),
                                     kvres_enabled())


flash_attention.launches = flash_attention.wgmma_launches = flash_attention.mma_launches = 0
flash_attention.f32_wgmma_launches = flash_attention.f32_mma_launches = 0
# a list while utils/summary.py counts a forward's FLOPs: the (BH, Lq, Lk, d)
# of each CUDA call (K1 or K1'), whose products no torch FLOP counter sees
flash_attention.shapes = None


def flash_attention_kvres(q, k, v, scale: float, dropout: float = 0.0, seed: int = 0):
    """K1': ``flash_attention``'s function with K/V streamed through a deeper
    ring, on CUDA tensors (K1's kernels: equal to K1 bit for bit)."""
    _check(q, k, v)
    _check_dropout(dropout, seed)
    _require_cuda(q, "flash_attention_kvres", "flash_attention_reference")
    out, lse = _launch_fwd("flash_fwd_kvres", q, k, v, scale, dropout, seed)
    _count(flash_attention_kvres, q, k, v)
    return out, lse


flash_attention_kvres.launches = 0
flash_attention_kvres.wgmma_launches = flash_attention_kvres.mma_launches = 0
flash_attention_kvres.f32_wgmma_launches = flash_attention_kvres.f32_mma_launches = 0


def flash_attention_mma(q, k, v, scale: float, dropout: float = 0.0, seed: int = 0):
    """``flash_attention``'s function for CUDA tensors on the mma.sync kernel
    of their dtype at any shape (``flash_fwd_tf32_kernel`` of
    csrc/flash_fwd_tf32.cuh for f32, ``flash_fwd_tc_kernel`` of
    csrc/flash_fwd_tc.cuh for bf16), the forward before each dtype's wgmma
    kernel; kept for timing the two in turns, never on a path where the
    wgmma kernel takes the call."""
    _check(q, k, v)
    _check_dropout(dropout, seed)
    _require_cuda(q, "flash_attention_mma", "flash_attention_reference")
    out, lse = _launch_fwd("flash_fwd", q, k, v, scale, dropout, seed, "buctd_flash_fwd_mma")
    flash_attention_mma.launches += 1
    return out, lse


flash_attention_mma.launches = 0


def wgmma_waves(bh: int, lq: int, d: int, dropout: float = 0.0, kvres: bool = False,
                device=None, f32: bool = False) -> dict:
    """The grid of the bf16 (``f32``: the f32) wgmma forward kernel at (bh,
    lq, d) on a CUDA card: its blocks (128 query rows each), how many the
    card keeps resident on one SM (CUDA's occupancy calculator on the built
    kernel), the waves that makes, and for f32 its key tile and ring
    slots."""
    lib = "flash_fwd_kvres" if kvres else "flash_fwd"
    symbol = f"buctd_{lib}_tf32_blocks_per_sm" if f32 else f"buctd_{lib}_blocks_per_sm"
    per_sm = _fn(lib, symbol, (_I, _I))(d, int(dropout > 0.0))
    sms = torch.cuda.get_device_properties(device or 0).multi_processor_count
    blocks = -(-lq // WGMMA_ROWS) * bh
    grid = {"blocks": blocks, "blocks_per_sm": per_sm, "sms": sms,
            "waves": blocks / (sms * per_sm) if per_sm else float("inf")}
    if f32:   # the f32 kernel's key tile and ring slots at this d
        grid.update(key_tile=tf32_wgmma_key_tile(d), slots=tf32_wgmma_stages(d, kvres))
    return grid


def wgmma_bwd_waves(bh: int, l: int, d: int, dropout: float = 0.0, device=None,
                    f32: bool = False) -> dict:
    """The grids of the bf16 (``f32``: the f32) wgmma backward kernels at
    (bh, l, d) (L_q = L_k = l) on a CUDA card: for dq and dk/dv, their blocks
    (128 rows each in bf16; 64 a consumer warpgroup of the plan in f32), how
    many the card keeps resident on one SM, the waves that makes, and the
    looped tile (``wgmma_bwd_tiles``, ``tf32_wgmma_bwd_plan``)."""
    symbol = "buctd_flash_bwd_tf32_blocks_per_sm" if f32 else "buctd_flash_bwd_blocks_per_sm"
    fn = _fn("flash_bwd", symbol, (_I, _I, _I))
    sms = torch.cuda.get_device_properties(device or 0).multi_processor_count
    out = {}
    for kind in ("dq", "dkv"):
        if f32:
            consumers, tile = tf32_wgmma_bwd_plan(d, kind == "dq")
            rows = 64 * consumers
        else:
            rows, tile = WGMMA_BWD_ROWS, wgmma_bwd_tiles(d)[kind]
        blocks = -(-l // rows) * bh
        per_sm = fn(d, int(dropout > 0.0), int(kind == "dq"))
        out[kind] = {"blocks": blocks, "blocks_per_sm": per_sm, "sms": sms, "tile": tile,
                     "waves": blocks / (sms * per_sm) if per_sm else float("inf")}
    return out


def flash_attention_simt(q, k, v, scale: float, dropout: float = 0.0, seed: int = 0):
    """``flash_attention``'s function for f32 CUDA tensors on the CUDA cores'
    FMAs (``flash_fwd_kernel`` of csrc/flash_fwd.cu), the f32 forward before
    the 3xTF32 kernels; kept as the card tests' accuracy yardstick at long
    rows, never on a path."""
    _check(q, k, v)
    _check_dropout(dropout, seed)
    _require_cuda(q, "flash_attention_simt", "flash_attention_reference")
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention_simt takes f32 operands, got {q.dtype}")
    out, lse = _launch_fwd("flash_fwd", q, k, v, scale, dropout, seed,
                           "buctd_flash_fwd_simt")
    flash_attention_simt.launches += 1
    return out, lse


flash_attention_simt.launches = 0


def _k2_dout(q, dout):
    """do as the K2 and K2' kernels read it: f32 beside f32 q, and cast once
    to bf16 beside bf16 q (the tensor-core kernels' operand, JAX's MXU pass of
    do)."""
    return dout.to(torch.bfloat16) if q.dtype == torch.bfloat16 else dout


def _bwd_operands(wrapper, q, k, v, dout, lse, delta, dropout, seed):
    """The checked operands of a backward C entry, do as its kernels read
    it."""
    _check_bwd(q, k, v, dout, lse, delta, dropout, seed)
    _require_cuda(q, wrapper.__name__, "flash_attention_backward_reference")
    if q.dtype == torch.float32:
        _check_copyable(q, k, v, dout)
    return _k2_dout(q, dout)


def _count_bwd(wrapper, q, k, v, do, ab: bool) -> None:
    """One launch on a backward wrapper; on K2's and K2''s calls (not ``ab``,
    the mma.sync and SIMT A/B wrappers) also on the counter of the kernel
    that the C entry picked by the same rule: ``wgmma_launches`` or
    ``mma_launches`` for bf16 (``takes_wgmma_bwd``), ``f32_wgmma_launches``
    or ``f32_mma_launches`` for f32 (``takes_wgmma_bwd_f32``)."""
    wrapper.launches += 1
    if ab:
        return
    if q.dtype == torch.bfloat16:
        kind = "wgmma" if takes_wgmma_bwd(q, k, v, do) else "mma"
    else:
        kind = "f32_wgmma" if takes_wgmma_bwd_f32(q, k, v, do) else "f32_mma"
    name = f"{kind}_launches"
    setattr(wrapper, name, getattr(wrapper, name, 0) + 1)


def _bwd_dq(wrapper, lib: str, symbol: str, q, k, v, dout, lse, delta, scale, dropout,
            seed, ab: bool = False):
    """dq from the C entry ``symbol`` of csrc/<lib>.cu, counted on
    ``wrapper`` (and by kernel unless ``ab``, as ``_count_bwd``)."""
    do = _bwd_operands(wrapper, q, k, v, dout, lse, delta, dropout, seed)
    dq = _launch_dq(lib, symbol, q, k, v, do, lse, delta, scale, dropout, seed)
    _count_bwd(wrapper, q, k, v, do, ab)
    return dq


def _bwd_dkv(wrapper, lib: str, symbol: str, q, k, v, dout, lse, delta, scale, dropout,
             seed, ab: bool = False):
    """dk, dv from the C entry ``symbol`` of csrc/<lib>.cu, counted on
    ``wrapper`` (as ``_bwd_dq``)."""
    do = _bwd_operands(wrapper, q, k, v, dout, lse, delta, dropout, seed)
    dk, dv = _launch_dkv(lib, symbol, q, k, v, do, lse, delta, scale, dropout, seed)
    _count_bwd(wrapper, q, k, v, do, ab)
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, scale: float, dropout: float = 0.0,
                 seed: int = 0):
    """dq f32 (BH, Lq, d) of the attention above, from do, the forward's lse
    and delta = rowsum(do * out), on CUDA tensors (K2's dq kernel on the
    tensor cores: for f32, 3xTF32, the wgmma kernel where
    ``takes_wgmma_bwd_f32``, else the mma.sync one; for bf16, rounding as the
    plain backward, the wgmma kernel where ``takes_wgmma_bwd``, else the
    mma.sync one)."""
    return _bwd_dq(flash_bwd_dq, "flash_bwd", "buctd_flash_bwd_dq", q, k, v, dout, lse,
                   delta, scale, dropout, seed)


flash_bwd_dq.launches = flash_bwd_dq.wgmma_launches = flash_bwd_dq.mma_launches = 0
flash_bwd_dq.f32_wgmma_launches = flash_bwd_dq.f32_mma_launches = 0


def flash_bwd_dkv(q, k, v, dout, lse, delta, scale: float, dropout: float = 0.0,
                  seed: int = 0):
    """dk, dv f32 (BH, Lk, d), on CUDA tensors (K2's dk/dv kernel, as
    ``flash_bwd_dq``)."""
    return _bwd_dkv(flash_bwd_dkv, "flash_bwd", "buctd_flash_bwd_dkv", q, k, v, dout, lse,
                    delta, scale, dropout, seed)


flash_bwd_dkv.launches = flash_bwd_dkv.wgmma_launches = flash_bwd_dkv.mma_launches = 0
flash_bwd_dkv.f32_wgmma_launches = flash_bwd_dkv.f32_mma_launches = 0


def flash_bwd_dq_mma(q, k, v, dout, lse, delta, scale: float, dropout: float = 0.0,
                     seed: int = 0):
    """``flash_bwd_dq``'s function for CUDA tensors on the mma.sync kernel
    of their dtype at any shape (``flash_bwd_dq_tc_kernel`` of
    csrc/flash_bwd_tc.cuh for bf16, ``flash_bwd_dq_tf32_kernel`` of
    csrc/flash_bwd_tf32.cuh for f32), the dq kernel before each dtype's wgmma
    one; kept for timing the two in turns, never on a path where the wgmma
    kernel takes the call."""
    return _bwd_dq(flash_bwd_dq_mma, "flash_bwd", "buctd_flash_bwd_dq_mma", q, k, v, dout,
                   lse, delta, scale, dropout, seed, ab=True)


flash_bwd_dq_mma.launches = 0


def flash_bwd_dkv_mma(q, k, v, dout, lse, delta, scale: float, dropout: float = 0.0,
                      seed: int = 0):
    """``flash_bwd_dkv``'s function on the mma.sync kernel of the operands'
    dtype (``flash_bwd_dkv_tc_kernel``, ``flash_bwd_dkv_tf32_kernel``), as
    ``flash_bwd_dq_mma``."""
    return _bwd_dkv(flash_bwd_dkv_mma, "flash_bwd", "buctd_flash_bwd_dkv_mma", q, k, v, dout,
                    lse, delta, scale, dropout, seed, ab=True)


flash_bwd_dkv_mma.launches = 0


def flash_bwd_dq_simt(q, k, v, dout, lse, delta, scale: float, dropout: float = 0.0,
                      seed: int = 0):
    """``flash_bwd_dq``'s function for f32 CUDA tensors on the CUDA cores'
    FMAs (``flash_bwd_dq_kernel`` of csrc/flash_bwd.cu), the f32 dq kernel
    before the 3xTF32 one; kept for timing the two in turns, never on a
    path."""
    if q.dtype != torch.float32:
        raise TypeError(f"flash_bwd_dq_simt takes f32 operands, got {q.dtype}")
    return _bwd_dq(flash_bwd_dq_simt, "flash_bwd", "buctd_flash_bwd_dq_simt", q, k, v, dout,
                   lse, delta, scale, dropout, seed, ab=True)


flash_bwd_dq_simt.launches = 0


def flash_bwd_dkv_simt(q, k, v, dout, lse, delta, scale: float, dropout: float = 0.0,
                       seed: int = 0):
    """``flash_bwd_dkv``'s function on the CUDA cores (``flash_bwd_dkv_kernel``),
    as ``flash_bwd_dq_simt``."""
    if q.dtype != torch.float32:
        raise TypeError(f"flash_bwd_dkv_simt takes f32 operands, got {q.dtype}")
    return _bwd_dkv(flash_bwd_dkv_simt, "flash_bwd", "buctd_flash_bwd_dkv_simt", q, k, v,
                    dout, lse, delta, scale, dropout, seed, ab=True)


flash_bwd_dkv_simt.launches = 0


def flash_bwd_dq_kvres(q, k, v, dout, lse, delta, scale: float, dropout: float = 0.0,
                       seed: int = 0):
    """K2' dq: ``flash_bwd_dq``'s function with K/V streamed through a
    deeper ring (K2's kernels: equal to K2 bit for bit)."""
    return _bwd_dq(flash_bwd_dq_kvres, "flash_bwd_kvres", "buctd_flash_bwd_dq_kvres", q, k,
                   v, dout, lse, delta, scale, dropout, seed)


flash_bwd_dq_kvres.launches = 0
flash_bwd_dq_kvres.wgmma_launches = flash_bwd_dq_kvres.mma_launches = 0
flash_bwd_dq_kvres.f32_wgmma_launches = flash_bwd_dq_kvres.f32_mma_launches = 0


def flash_bwd_dkv_kvres(q, k, v, dout, lse, delta, scale: float, dropout: float = 0.0,
                        seed: int = 0):
    """K2' dk/dv: ``flash_bwd_dkv``'s function with q, do, lse and delta
    streamed through a deeper ring (K2's kernels: equal to K2 bit for
    bit)."""
    return _bwd_dkv(flash_bwd_dkv_kvres, "flash_bwd_kvres", "buctd_flash_bwd_dkv_kvres", q,
                    k, v, dout, lse, delta, scale, dropout, seed)


flash_bwd_dkv_kvres.launches = 0
flash_bwd_dkv_kvres.wgmma_launches = flash_bwd_dkv_kvres.mma_launches = 0
flash_bwd_dkv_kvres.f32_wgmma_launches = flash_bwd_dkv_kvres.f32_mma_launches = 0


def flash_attention_backward(q, k, v, out, lse, dout, scale: float,
                             dropout: float = 0.0, seed: int = 0):
    """dq, dk, dv in q's, k's and v's dtypes (the JAX ``.astype`` at :766).
    delta = rowsum(do * out) is computed here in torch, as JAX does (:698);
    CUDA tensors then launch K2's two kernels (K2' under
    ``BUCTD_FLASH_KVRES``), CPU tensors take the plain backward."""
    dout = dout.float().contiguous()
    delta = (dout * out).sum(-1)
    if not _on_cuda(q, "flash_attention_backward"):
        dq, dk, dv = flash_attention_backward_reference(q, k, v, dout, lse, delta,
                                                        scale, dropout, seed)
    elif kvres_enabled():
        dq = flash_bwd_dq_kvres(q, k, v, dout, lse, delta, scale, dropout, seed)
        dk, dv = flash_bwd_dkv_kvres(q, k, v, dout, lse, delta, scale, dropout, seed)
    else:
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, scale, dropout, seed)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, scale, dropout, seed)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionTrain(torch.autograd.Function):
    """out = dropout(softmax(q k^T * scale)) @ v with the flash backward; the
    masks regenerate from ``seed``, so neither the probabilities nor the
    masks are stored.  custom_fwd/custom_bwd let the backward see the
    forward's autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, scale, dropout, seed):
        out, lse = flash_attention(q, k, v, scale, dropout, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, dropout, seed)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, scale: float, dropout: float = 0.0, seed: int = 0):
    """Differentiable flash attention: out f32 (BH, Lq, d)."""
    return FlashAttentionTrain.apply(q, k, v, float(scale), float(dropout), int(seed))
