#!/usr/bin/env python3
"""Smoke run of buctd_tpu_torch on one NVIDIA GPU (H100): builds the CUDA
kernels, holds each against its plain PyTorch version, serves full-width
BUCTD-CoAM-W48 through PoseEstimator with 3 refinement rounds, trains it for a
few steps through the training entry point, evaluates it with the flip test
and 3 refinement rounds through the evaluation entry point, serves
full-width BUCTD-preNet-W48 with its preNet fused and not, and runs the
port's benchmarks of the fused basic block (K5) and exp throughput (K6).

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  0. build every kernel under buctd_tpu_torch/csrc/ with nvcc for sm_90a (one
     nvcc per source, all started together);
  1. kernels, serving shapes: K1 (flash-attention forward) vs its plain version
     at the CoAM-W48 shapes (16 crops, as predict_batch gives them, and 8) in
     f32 and bf16 plus a ragged case; kernel, plain and
     F.scaled_dot_product_attention times beside the card's bound;
  2. kernels, training shapes: K1 with dropout 0.1, K2 (flash backward: the dq
     and the dk/dv kernels) and K4 (rotated warp) vs their plain versions, and
     their times at the shapes a batch-32 train step gives them;
  3. serving: CoAM-W48 crowdpose 384x288 (14 joints, random weights from
     torch.manual_seed), ``predict`` on a 480x640 image with 4 condition poses
     and ``predict_batch`` on 3 images; finite outputs of the right shapes, the
     flash launch count of the run, one forward on the card vs the same module
     on the CPU, ms per image and crops/s; a profile of one predict_batch;
  4. training: ``buctd_tpu_torch.train.run`` on a synthetic CrowdPose-format
     set (seeded, in a temporary directory) at full width, batch 32, bf16
     autocast, attention dropout 0.1, the device loader; ms/step, images/s,
     data-wait per step, the launch counts of K1, K2 and K4 in that run; the
     loss over a repeated batch (finite, falling); a profile of one step;
  5. one f32 (TF32 off), dropout-0 train step at batch 1 on the card vs the
     same step on the CPU: loss, the gradients (all, and the position
     attention's alone), BN running statistics; the step's K2 calls vs
     float64 on their own inputs;
  6. kernels, kv-resident: K1' (flash_fwd_kvres) vs the plain version at the
     serving shapes, the eval shapes (64 = 2 x 32 flip-test crops) in f32 and
     bf16 and a ragged case, and vs K1; at the training shapes (BH 32), f32
     and bf16, dropout 0.1: K1' and K2' (dq, dk/dv) vs the plain versions
     (over BH chunks, each with its rows' dropout mask) and vs K1/K2; times of
     each beside K1's/K2's (A/B in turns: old, new, new, old), the plain
     version's, the bound and SDPA's;
  7. evaluation: ``buctd_tpu_torch.valid.run`` on a seeded synthetic
     CrowdPose test set (64 480x640 images x 4 people = 256 crops = 8 batches
     of 32) from a BU-prediction json, with N(0, 1/fan_in) weights saved as a
     .pth, full width, flip test, 3 refinement rounds: a results json with
     one entry per crop and a finite AP in [0, 1] each round, K1 and K4
     launched 2 per batch per round, crops/s per round; a profile of one
     validate step;
  8. the same evaluation, one round, under BUCTD_FLASH_KVRES=1: K1' launched 2
     per batch and K1 never; one batch's heatmaps from K1 and K1' agree; one
     validate step at batch 2 on the card vs the CPU;
  9. 3 training steps under BUCTD_FLASH_KVRES=1: K1', K2' dq and K2' dk/dv
     launched 2 per step, K1 and K2 never, the loss finite;
 10. K5 (the fused eval basic block) vs its plain version at the four W48
     branch geometries, batch 32, f32 and bf16, and on the benchmark's own
     batch-128 bf16 inputs; the plain version's time on those;
 11. K5 vs the port's trunk: one stage-4 BasicBlock per branch of a
     full-width preNet-W48 with random BN statistics, folded by
     models/fuse.py::fold_bn, f32 with TF32 off;
 12. K6 (exp/exp2 throughput) vs its plain version, all three variants: the
     full chain, and 1, 2 and 3 steps on inputs over [-100, 100];
 13. preNet-W48 serving (crowdpose 384x288, 14 joints, f32, 3 rounds) through
     PoseEstimator from one .pth of random weights, with TPU.FUSED_PRENET off
     and auto: fused vs unfused predictions, each forward on the card vs the
     CPU, crops/s, a profile of each;
 14. the port's tools, reduced (buctd_tpu_torch/tools/bench_block.py --fused,
     bench_exp2.py, bench_stem.py): K5's and K6's launch counts in that run,
     and the times of K5, cuDNN, K6 (device time) and the torch chains that
     the kernels line reports; K6 no faster than its SFU bound.

Prints the kernels' JSON line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result, where CUDA is absent.
"""

from __future__ import annotations

import copy
import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "experiments" / "crowdpose" / "buctd" / "coam_w48_384x288.yaml"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"float32": 67e12,      # f32 outside the tensor cores: the kernel's f32 path
            "bfloat16": 989e12}    # dense bf16 tensor cores
# kernel vs plain: both sum in f32, in another order, over up to 6912 keys
# (measured ~1e-6 on randn inputs); bf16 inputs widen exactly to f32 on both sides
KERNEL_ATOL = KERNEL_RTOL = 2e-5
# card vs CPU forward, f32 with TF32 off on the card: convolution algorithms
# and attention sums differ in order; relative to the heatmaps' peak
FORWARD_RTOL = 1e-4
# card vs CPU train step, f32 with TF32 off, batch 1: the loss is a mean over
# 96x72x14 values summed in another order (rel 1e-4).  The gradients are not
# compared tensor by tensor: at batch 1 BatchNorm's backward over batch
# statistics cancels in the low-resolution branches (12x9 values a channel),
# so the f32 step is about 1.5% (relative L2 of the whole gradient) from
# float64 on the CPU as on the card (measured on an H100), and kernels that
# sum in another order move single tensors by up to 25% of their max.  The
# card's f32 gradient is held to be no further from the float64 step than
# STEP_GRAD_RATIO x the CPU's own f32 gradient, over the whole model and over
# the CoAM position attention (where K1/K2 run) alone.  Each K2 call of the
# card's step is also held against float64 autograd on its own inputs: f32
# sums over up to 6912 terms, max error / max gradient <= STEP_K2_RTOL.  BN
# running statistics after the forward: rtol 1e-4, atol 1e-5 (means of O(1)
# activations).
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RATIO = 2.0
STEP_K2_RTOL = 1e-4
STEP_BN_RTOL = 1e-4
STEP_BN_ATOL = 1e-5
ROUNDS = 3
REPEATS = 5
# K1's (BH, Lq, Lk, d) on the main path: the CoAM position attention of branch
# 0 and branch 1, BH = the 16 crops of the serving phase's predict_batch
MAIN_CASES = [(16, 6912, 6912, 48), (16, 1728, 1728, 96)]
OTHER_CASES = [(8, 6912, 6912, 48), (8, 1728, 1728, 96), (3, 700, 300, 112)]
# the training path: batch 32, one head, bf16 operands under autocast
TRAIN_BATCH = 32
TRAIN_CASES = [(TRAIN_BATCH, 6912, 48), (TRAIN_BATCH, 1728, 96)]
# the plain versions hold (BH, L, L) f32 tensors: they are checked and timed
# in BH chunks of this size
PLAIN_BH = {6912: 2, 1728: 8}
DROPOUT = 0.1
# K2 vs its plain backward: dq/dk/dv sum p-weighted products over up to 6912
# keys or rows in f32, in another order (measured below 1e-6 on randn inputs)
BWD_ATOL = BWD_RTOL = 1e-4
# K4 vs its plain version on 0..255 images: two tent taps against the dense
# tent sum, both f32; a few ulps of 255
WARP_ATOL = 2e-3
WARP_BATCH = (TRAIN_BATCH, 512, 640)   # 480x640 images in their 512x640 bucket
TRAIN_STEPS = 10                        # one epoch of the synthetic set
SYNTH_IMAGES, SYNTH_PEOPLE = 80, 4      # 320 people = 10 batches of 32
# evaluation: TEST batch 32, flip test -> BH 64 in K1 (branch 0 and 1 shapes)
EVAL_BATCH = 32
EVAL_CASES = [(2 * EVAL_BATCH, 6912, 6912, 48), (2 * EVAL_BATCH, 1728, 1728, 96)]
EVAL_IMAGES = 64                        # x 4 people = 256 crops = 8 batches of 32
EVAL_ROUNDS = 3
KVRES_TRAIN_STEPS = 3
# K1 vs K1' heatmaps of one eval batch: the same sums in another tile order
KVRES_HM_RTOL = 1e-5
PRENET_CONFIG = ROOT / "experiments" / "crowdpose" / "buctd" / "prenet_w48_384x288.yaml"
# K5 vs its plain version at the W48 branch geometries, batch 32: f32 sums of
# 9C products in another order (measured <= 4.3e-6 on O(1) outputs); in bf16
# an f32 sum in another order can round the intermediate or the output one
# bf16 step (2^-7 relative) apart, so two steps, relative and absolute
K5_CHECK_BATCH = 32
K5_ATOL = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
# K5 vs the trunk's BasicBlock (f32, TF32 off): a float64 BN fold cast to f32
# against conv + BN in f32, summed in another order; relative to the max
K5_TRUNK_RTOL = 1e-4
# K6 vs its plain version, both expf/exp2f in f32: a few ulps.  The full
# chain contracts (slope ~0.03) to one fixed point whatever the input, so 1, 2
# and 3 steps on inputs over [-100, 100] (values 0.05..20) are checked too
K6_RTOL = 1e-5
# fused vs unfused preNet serving: an exact refactoring up to f32
# reassociation; the heatmaps of one forward within 1e-5 of their max, the
# decoded predictions (3 rounds) within 0.01 px
PRENET_FWD_RTOL = 1e-5
PRENET_PX_TOL = 0.01
# the tools' reduced runs: chained blocks, rounds, bench_stem's batch
TOOL_CHAIN, TOOL_ROUNDS, TOOL_STEM_BATCH = 5, 2, 32


def timed_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound_ms(bh, lq, lk, d, dtype) -> tuple:
    """Least time for softmax(q k^T) v on the card: operations (4 bh lq lk d,
    the CostEstimate of buctd_tpu/ops/flash_attention.py) over the peak rate for
    the inputs' type, or bytes (q, k, v read once, out and lse written once)
    over the memory rate, whichever is larger."""
    elt = 4 if dtype == "float32" else 2
    ops = 4.0 * bh * lq * lk * d
    nbytes = elt * bh * (lq + 2 * lk) * d + 4 * bh * lq * (d + 1)
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(torch, F, fa) -> dict:
    """K1 vs its plain version in f32 and bf16.  Returns the f32 sums over
    MAIN_CASES: the kernel's work in one forward of the serving phase's batch."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    main = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0}
    for bh, lq, lk, d in MAIN_CASES + OTHER_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q = torch.randn(bh, lq, d, device="cuda", generator=gen).to(dtype)
            k = torch.randn(bh, lk, d, device="cuda", generator=gen).to(dtype)
            v = torch.randn(bh, lk, d, device="cuda", generator=gen).to(dtype)
            scale = d ** -0.5
            out, lse = fa.flash_attention(q, k, v, scale)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_attention_reference(q, k, v, scale)
            torch.testing.assert_close(out, ref_out, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
            torch.testing.assert_close(lse, ref_lse, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
            err = max((out - ref_out).abs().max().item(), (lse - ref_lse).abs().max().item())
            worst = max(worst, err)
            ms = timed_ms(lambda: fa.flash_attention(q, k, v, scale), 20)
            plain_ms = timed_ms(lambda: fa.flash_attention_reference(q, k, v, scale), 5)
            q4, k4, v4 = q[:, None], k[:, None], v[:, None]   # (BH, 1 head, L, d)
            lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale),
                              10)
            bound, by = flash_bound_ms(bh, lq, lk, d, name)
            print(f"K1 flash_fwd ({bh}, {lq}, {lk}, {d}) {name}: max_abs_err {err:.3e} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({by}), "
                  f"{4.0 * bh * lq * lk * d / ms / 1e9:.2f} TFLOP/s", flush=True)
            if (bh, lq, lk, d) in MAIN_CASES and dtype == torch.float32:
                main["ms"] += ms
                main["plain_ms"] += plain_ms
                main["library_ms"] += lib_ms
                main["bound_ms"] += bound
                main["ops_ms"] += 4.0 * bh * lq * lk * d / PEAK_OPS[name] * 1e3
            del q, k, v, q4, k4, v4, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    main["max_abs_err"] = worst
    return main


def chunked(fn, bh: int, chunk: int, *tensors):
    """``fn`` over BH chunks of (BH, ...) tensors: the plain versions' memory
    stays bounded (their (chunk, L, L) f32 tensors) while they do all the work."""
    for i in range(0, bh, chunk):
        fn(*(t[i:i + chunk] for t in tensors))


# the L x L x d matrix products of each backward kernel (2 operations per
# multiply-add): dq recomputes s = q k^T and g = do v^T and forms ds k; dk/dv
# recompute s and g and form (p keep)^T do and ds^T q.  Outputs: f32 gradients.
BWD_PRODUCTS = {"dq": 3, "dkv": 4}
BWD_OUTPUTS = {"dq": 1, "dkv": 2}


def bwd_ops(bh, l, d, kind) -> float:
    return 2.0 * BWD_PRODUCTS[kind] * bh * l * l * d


def bwd_bound_ms(bh, l, d, elt, kind) -> tuple:
    """Least time of one backward kernel: its operations (``bwd_ops``) over
    the peak for the operands' type, or its bytes (q, k, v in their type; do,
    lse, delta read and the f32 gradients written) over the memory rate."""
    nbytes = 3 * elt * bh * l * d + 4 * bh * l * (d + 2) + 4 * BWD_OUTPUTS[kind] * bh * l * d
    peak = PEAK_OPS["float32" if elt == 4 else "bfloat16"]
    t_ops, t_bytes = bwd_ops(bh, l, d, kind) / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def warp_read_pixels(torch, tw, trans, hw, out_hw) -> int:
    """Source pixels the two-pass warp of ``trans`` (B, 2, 3) reads with a
    nonzero tent weight, summed over samples: per output pixel the two rows
    around its source y (pass 2) and, in each, the two columns around the
    pass-1 x of that row, inside the image.  This run's crops read only their
    own footprint, not the whole padded image."""
    oh, ow = out_hw
    oy = torch.arange(oh, dtype=torch.float32, device=trans.device)[:, None]
    ox = torch.arange(ow, dtype=torch.float32, device=trans.device)[None, :]
    total = 0
    for t in trans.float():
        transposed, t = tw._sample_affine(t)
        rows, cols = (hw[1], hw[0]) if transposed else hw
        (a, b, e), (c, d, f) = t
        y = d * oy + c * ox + f
        seen = torch.zeros(rows * cols, dtype=torch.bool, device=trans.device)
        for dy in (0.0, 1.0):
            r = torch.floor(y) + dy
            ok_r = (1.0 - (y - r).abs() > 0) & (r >= 0) & (r < rows)
            x = (a - b * c / d) * ox + (b / d) * r + (e - (b / d) * f)
            for dx in (0.0, 1.0):
                w = torch.floor(x) + dx
                ok = ok_r & (1.0 - (x - w).abs() > 0) & (w >= 0) & (w < cols)
                seen[(r * cols + w)[ok].long()] = True
        total += int(seen.sum())
    return total


def train_kernel_phase(torch, F, fa, tw) -> dict:
    """K1 with dropout, K2 and K4 at the training path's shapes.

    Checked against the plain versions at a smaller BH where those would not
    fit (f32 and bf16, dropout 0.1, the same seed: the kernels and the plain
    versions draw the same hash mask), then timed at BH 32 in bf16 (the
    autocast step's operands).  Library yardsticks: SDPA forward (K1) and
    forward+backward (K2) with dropout 0.1; F.grid_sample for K4, a one-pass
    bilinear warp, which is NOT the same function when rotated.
    """
    from buctd_tpu_torch.geometry import make_affine

    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {"fwd_err": 0.0, "dq_err": 0.0, "dkv_err": 0.0}
    seed = 1234
    for bh, lq, d in TRAIN_CASES:
        small = PLAIN_BH[lq]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(small, lq, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
            do = torch.randn(small, lq, d, device="cuda", generator=gen)
            scale = d ** -0.5
            out, lse = fa.flash_attention(q, k, v, scale, DROPOUT, seed)
            ref_out, ref_lse = fa.flash_attention_reference(q, k, v, scale, DROPOUT, seed)
            torch.testing.assert_close(out, ref_out, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
            torch.testing.assert_close(lse, ref_lse, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
            delta = (do * out).sum(-1)
            dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, DROPOUT, seed)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, DROPOUT, seed)
            torch.cuda.synchronize()
            ref = fa.flash_attention_backward_reference(q, k, v, do, lse, delta, scale,
                                                        DROPOUT, seed)
            for got, want in zip((dq, dk, dv), ref):
                torch.testing.assert_close(got, want, atol=BWD_ATOL, rtol=BWD_RTOL)
            res["fwd_err"] = max(res["fwd_err"], (out - ref_out).abs().max().item(),
                                 (lse - ref_lse).abs().max().item())
            res["dq_err"] = max(res["dq_err"], (dq - ref[0]).abs().max().item())
            res["dkv_err"] = max(res["dkv_err"], (dk - ref[1]).abs().max().item(),
                                 (dv - ref[2]).abs().max().item())
            print(f"K1+K2 check ({small}, {lq}, {d}) {str(dtype)[6:]} dropout {DROPOUT}: "
                  f"out {(out - ref_out).abs().max().item():.3e} "
                  f"dq {(dq - ref[0]).abs().max().item():.3e} "
                  f"dk {(dk - ref[1]).abs().max().item():.3e} "
                  f"dv {(dv - ref[2]).abs().max().item():.3e}", flush=True)
            del q, k, v, do, out, lse, ref_out, ref_lse, ref, dq, dk, dv
            torch.cuda.empty_cache()

    for name in ("fwd", "dq", "dkv"):
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms"):
            res[f"{name}_{key}"] = 0.0
    for bh, lq, d in TRAIN_CASES:
        q, k, v = (torch.randn(bh, lq, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        do = torch.randn(bh, lq, d, device="cuda", generator=gen)
        scale = d ** -0.5
        out, lse = fa.flash_attention(q, k, v, scale, DROPOUT, seed)
        delta = (do * out).sum(-1)
        small = PLAIN_BH[lq]
        t = {
            "fwd_ms": timed_ms(lambda: fa.flash_attention(q, k, v, scale, DROPOUT, seed), 10),
            "dq_ms": timed_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, scale,
                                                      DROPOUT, seed), 10),
            "dkv_ms": timed_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale,
                                                        DROPOUT, seed), 10),
            "fwd_plain_ms": timed_ms(lambda: chunked(
                lambda a, b, c: fa.flash_attention_reference(a, b, c, scale, DROPOUT, seed),
                bh, small, q, k, v), 2),
            "dq_plain_ms": timed_ms(lambda: chunked(
                lambda a, b, c, g, l, e: fa.flash_attention_backward_reference(
                    a, b, c, g, l, e, scale, DROPOUT, seed), bh, small, q, k, v, do, lse,
                delta), 2),
        }
        t["dkv_plain_ms"] = t["dq_plain_ms"]   # one plain backward makes dq, dk and dv
        q4, k4, v4 = (x[:, None].detach().clone().requires_grad_() for x in (q, k, v))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(q4, k4, v4, dropout_p=DROPOUT, scale=scale)

        def sdpa_fwd_bwd():
            q4.grad = k4.grad = v4.grad = None
            sdpa_fwd().backward(do[:, None].to(torch.bfloat16))

        with torch.no_grad():
            t["fwd_library_ms"] = timed_ms(sdpa_fwd, 10)
        t["dq_library_ms"] = t["dkv_library_ms"] = timed_ms(sdpa_fwd_bwd, 10)
        bound_f, by_f = flash_bound_ms(bh, lq, lq, d, "bfloat16")
        bound_q, by_q = bwd_bound_ms(bh, lq, d, 2, "dq")
        bound_kv, by_kv = bwd_bound_ms(bh, lq, d, 2, "dkv")
        ops = {"fwd": 4.0 * bh * lq * lq * d, "dq": bwd_ops(bh, lq, d, "dq"),
               "dkv": bwd_ops(bh, lq, d, "dkv")}
        t.update({"fwd_bound_ms": bound_f, "dq_bound_ms": bound_q, "dkv_bound_ms": bound_kv})
        t.update({f"{n}_ops_ms": o / PEAK_OPS["bfloat16"] * 1e3 for n, o in ops.items()})
        for key, val in t.items():
            res[key] += val
        f32core = {n: o / PEAK_OPS["float32"] * 1e3 for n, o in ops.items()}
        print(f"train kernels ({bh}, {lq}, {d}) bf16 dropout {DROPOUT}: "
              f"K1 {t['fwd_ms']:.4f} ms (plain {t['fwd_plain_ms']:.4f}, sdpa "
              f"{t['fwd_library_ms']:.4f}, bound {bound_f:.4f} {by_f}, f32-core bound "
              f"{f32core['fwd']:.4f}); K2 dq {t['dq_ms']:.4f} ms (bound {bound_q:.4f} "
              f"{by_q}, f32-core {f32core['dq']:.4f}), dkv {t['dkv_ms']:.4f} ms (bound "
              f"{bound_kv:.4f} {by_kv}, f32-core {f32core['dkv']:.4f}); plain backward "
              f"{t['dq_plain_ms']:.4f} ms; sdpa fwd+bwd {t['dq_library_ms']:.4f} ms",
              flush=True)
        del q, k, v, do, out, lse, delta, q4, k4, v4
        torch.cuda.empty_cache()

    B, H, W = WARP_BATCH
    images = torch.rand(B, H, W, 3, device="cuda", generator=gen) * 255.0
    centers = torch.rand(B, 2, device="cuda", generator=gen) * torch.tensor(
        [440.0, 280.0], device="cuda") + 100.0
    scales = torch.rand(B, 2, device="cuda", generator=gen) * 1.2 + 0.6
    rots = torch.rand(B, device="cuda", generator=gen) * 180.0 - 90.0   # both decompositions
    trans = make_affine(centers, scales, rots, (288, 384), inv=True).contiguous()
    got = tw.warp_affine_general(images, trans, (384, 288))
    torch.cuda.synchronize()
    want = tw.warp_affine_reference(images, trans, (384, 288))
    torch.testing.assert_close(got, want, atol=WARP_ATOL, rtol=0)
    res["warp_err"] = (got - want).abs().max().item()
    res["warp_ms"] = timed_ms(lambda: tw.warp_resample(images, trans, (384, 288)), 20)
    res["warp_plain_ms"] = timed_ms(lambda: tw.warp_affine_reference(images, trans,
                                                                     (384, 288)), 2)
    x_nchw = images.permute(0, 3, 1, 2).contiguous()
    # grid_sample's normalized grid from the same output->source affines:
    # theta = N_src @ T @ N_out^-1 in align_corners=False coordinates
    def norm(w, h):
        return torch.tensor([[2.0 / w, 0.0, 1.0 / w - 1.0], [0.0, 2.0 / h, 1.0 / h - 1.0],
                             [0.0, 0.0, 1.0]], device="cuda")
    t3 = torch.cat([trans, torch.tensor([[[0.0, 0.0, 1.0]]], device="cuda").expand(B, 1, 3)],
                   dim=1)
    theta = (norm(W, H) @ t3 @ torch.linalg.inv(norm(288, 384)))[:, :2]
    grid = torch.nn.functional.affine_grid(theta, (B, 3, 384, 288), align_corners=False)
    res["warp_library_ms"] = timed_ms(lambda: F.grid_sample(
        x_nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=False), 20)
    # bytes: the f32 source pixels the crops read (each once) and the output
    read = warp_read_pixels(torch, tw, trans, (H, W), (384, 288))
    res["warp_bound_ms"] = 4 * 3 * (read + B * 384 * 288) / HBM_BYTES_PER_S * 1e3
    full_ms = 4 * 3 * B * (H * W + 384 * 288) / HBM_BYTES_PER_S * 1e3
    print(f"K4 warp ({B}, {H}, {W}, 3) -> (384, 288), rotations -90..90: max_abs_err "
          f"{res['warp_err']:.3e} kernel {res['warp_ms']:.4f} ms, plain "
          f"{res['warp_plain_ms']:.4f} ms, grid_sample (one-pass, not the same function) "
          f"{res['warp_library_ms']:.4f} ms, bound {res['warp_bound_ms']:.4f} ms (bytes: "
          f"the crops read {read} source pixels, {100 * read / (B * H * W):.1f}% of the "
          f"images; whole-image bound {full_ms:.4f} ms)", flush=True)
    del images, got, want, x_nchw, grid
    torch.cuda.empty_cache()
    return res


def sample_request(np, rng, h=480, w=640, poses=4, joints=14):
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    centers = rng.uniform([80, 80], [w - 80, h - 80], (poses, 1, 2))
    xy = centers + rng.uniform(-70, 70, (poses, joints, 2))
    conds = np.concatenate([xy, np.ones((poses, joints, 1))], -1).astype(np.float32)
    return img, conds


def randomize(torch, model) -> None:
    """N(0, 1/fan_in) weights and BN statistics away from the identity, from
    torch's seeded generator (models/hrnet.py::random_init): heatmaps with
    real peaks, so the decode and the card-vs-CPU checks see decisive values."""
    from buctd_tpu_torch.models.hrnet import random_init

    random_init(model)


def serving_phase(torch, np, fa) -> dict:
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.serving import PoseEstimator

    cfg = default_config()
    update_config(cfg, types.SimpleNamespace(cfg=str(CONFIG), opts=[]))
    torch.manual_seed(0)
    est = PoseEstimator(cfg, refine_iters=ROUNDS)   # device="cuda"
    randomize(torch, est.model)
    joints = int(cfg.MODEL.NUM_JOINTS)
    print(f"serving: {cfg.MODEL.NAME} {tuple(cfg.MODEL.IMAGE_SIZE)} {joints} joints, "
          f"{sum(p.numel() for p in est.model.parameters())} parameters, "
          f"{ROUNDS} rounds; allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    rng = np.random.RandomState(0)
    img, conds = sample_request(np, rng)
    batch = [sample_request(np, rng) for _ in range(3)]
    images, poses = [b[0] for b in batch], [b[1] for b in batch]
    keep = float("-inf")   # random weights: keep every joint, whatever its confidence

    est.predict(img, conds, keep)                    # first calls: cuDNN set-up
    est.predict_batch(images, poses, keep)
    torch.cuda.synchronize()

    fa.flash_attention.launches = 0                  # the main path's run
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        out = est.predict(img, conds, keep)
    t1 = time.perf_counter()
    for _ in range(REPEATS):
        outs = est.predict_batch(images, poses, keep)
    t2 = time.perf_counter()
    launches = fa.flash_attention.launches

    if out.shape != (4, joints, 3) or not np.isfinite(out).all():
        raise AssertionError(f"predict gave {out.shape}, finite={np.isfinite(out).all()}")
    for o in outs:
        if o.shape != (4, joints, 3) or not np.isfinite(o).all():
            raise AssertionError(f"predict_batch gave {o.shape}")
    forwards = 2 * REPEATS   # predict: one forward per round; predict_batch: one chunk
    want = 2 * ROUNDS * forwards
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected 2 per forward x "
                             f"{ROUNDS} rounds x {forwards} forwards = {want}")
    ms_predict = (t1 - t0) / REPEATS * 1e3
    ms_batch = (t2 - t1) / REPEATS * 1e3
    print(f"predict: {ms_predict:.2f} ms/image (4 poses, {ROUNDS} rounds), "
          f"{4 * 1e3 / ms_predict:.2f} crops/s", flush=True)
    print(f"predict_batch (3 images x 4 poses, padded to 4 images): "
          f"{ms_batch / 3:.2f} ms/image, {12 * 1e3 / ms_batch:.2f} crops/s", flush=True)
    print(f"flash launches in the run: {launches} (= 2 x {ROUNDS} x {forwards})", flush=True)

    # one forward on the card vs the same module on the CPU
    x = torch.from_numpy(rng.randn(1, 6, 384, 288).astype(np.float32))
    with torch.inference_mode():
        got = est.model(x.cuda()).cpu()
        want_hm = copy.deepcopy(est.model).cpu()(x)
    err = (got - want_hm).abs().max().item()
    peak = want_hm.abs().max().item()
    print(f"forward card vs CPU: max_abs_err {err:.3e}, heatmap peak {peak:.3e}, "
          f"std {want_hm.std().item():.3e}, limit {FORWARD_RTOL:.0e} x peak", flush=True)
    if not err <= FORWARD_RTOL * peak:
        raise AssertionError("card forward disagrees with the CPU forward")
    return {"launches": launches, "ms_predict": ms_predict, "ms_batch": ms_batch,
            "est": est, "images": images, "poses": poses}


def write_synthetic_crowdpose(np, root: Path, n_images: int, people: int, seed: int = 0):
    """A CrowdPose-format training set made from a seed: random 480x640 JPEGs
    and ``people`` overlapping 14-joint persons per image (all joints
    visible, no condition poses: the trainer synthesizes them).  Returns the
    annotation file's path."""
    import cv2

    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n_images):
        name = f"im{i:04d}.jpg"
        cv2.imwrite(str(root / name), rng.randint(0, 256, (480, 640, 3), np.uint8))
        images.append({"id": i + 1, "file_name": name, "width": 640, "height": 480,
                       "crowdIndex": float(rng.uniform())})
        for k in range(people):
            x0, y0 = 20 + 140 * k + rng.uniform(-15, 15), rng.uniform(20, 120)
            w, h = rng.uniform(110, 160), rng.uniform(220, 330)
            pts = np.stack([rng.uniform(x0, x0 + w, 14), rng.uniform(y0, y0 + h, 14)], 1)
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1,
                         "iscrowd": 0, "num_keypoints": 14,
                         "keypoints": [float(c) for x, y in pts for c in (x, y, 2)],
                         "bbox": [float(x0), float(y0), float(w), float(h)],
                         "area": float(w * h)})
    ann_file = root / "crowdpose_train.json"
    ann_file.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "person", "supercategory": "person",
                        "keypoints": [f"k{j}" for j in range(14)], "skeleton": []}]}))
    return ann_file


def kernel_profile(torch, fn, label: str) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and the
    device's idle share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    ours = sum(e.self_device_time_total for e in events
               if any(n in e.key for n in ("flash_", "warp_pass"))) / 1e3
    print(f"profile {label}: kernels {total:.2f} ms in {wall:.2f} ms wall (profiled), "
          f"device idle {100 * max(0.0, 1 - total / wall):.1f}%; the port's kernels "
          f"{ours:.2f} ms = {100 * ours / total:.1f}% of kernel time; {len(events)} "
          f"kernel names, top by device time:", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")


def training_phase(torch, np, fa, tw) -> dict:
    """The trainer's main path at full width, then the repeated-batch loss and
    a profile of one step."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.train import run
    from buctd_tpu_torch.train.state import TrainStep, make_lr_schedule, make_optimizer

    with tempfile.TemporaryDirectory(prefix="buctd_train_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        ann = write_synthetic_crowdpose(np, root, SYNTH_IMAGES, SYNTH_PEOPLE)
        opts = ["TPU.DEVICE_PIPELINE", "True", "DATASET.TRAIN_IMAGE_DIR", str(root),
                "DATASET.TRAIN_ANNOTATION_FILE", str(ann), "OUTPUT_DIR", str(root / "out")]
        print(f"training: synthetic CrowdPose set of {SYNTH_IMAGES} images x "
              f"{SYNTH_PEOPLE} people written in {time.perf_counter() - t0:.1f} s", flush=True)

        for f in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv, tw.warp_resample):
            f.launches = 0                                   # the main path's run
        t0 = time.perf_counter()
        res = run.main(["--cfg", str(CONFIG), "--steps", str(TRAIN_STEPS), "--no-eval",
                        "--seed", "0", *opts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": fa.flash_attention.launches,
                    "flash_bwd_dq": fa.flash_bwd_dq.launches,
                    "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
                    "warp_resample": tw.warp_resample.launches}
        steps = res["steps"]
        stats = res["stats"][0]
        losses = [float(m["loss"]) for st in res["stats"] for m in st["metrics"]]
        want = {"flash_fwd": 2 * steps, "flash_bwd_dq": 2 * steps,
                "flash_bwd_dkv": 2 * steps, "warp_resample": 2 * steps}
        print(f"training run: {steps} steps of batch {TRAIN_BATCH} in {wall:.1f} s "
              f"(model build and data included); launches {launches}, expected {want} "
              f"(K1, dq, dkv: 2 per step; K4: 2 per batch)", flush=True)
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        if steps != TRAIN_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"{steps} steps, losses {losses}")
        per_step = [d + s for d, s in zip(stats["data_wait_s"], stats["step_s"])]
        warm = slice(2, None)
        ms_step = statistics.median(per_step[warm]) * 1e3
        data_ms = statistics.median(stats["data_wait_s"][warm]) * 1e3
        dispatch_ms = statistics.median(stats["step_s"][warm]) * 1e3
        print(f"training steps 3-{steps}: median {ms_step:.2f} ms/step "
              f"({TRAIN_BATCH * 1e3 / ms_step:.2f} images/s); data wait median "
              f"{data_ms:.2f} ms/step, step dispatch median {dispatch_ms:.2f} ms/step; "
              f"losses {[round(x, 6) for x in losses]}", flush=True)

        # the loss over a repeated batch, from the trained model
        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(CONFIG), opts=opts))
        loader = DeviceLoader(get_dataset(cfg, is_train=True), cfg, num_workers=4, seed=1)
        batch = next(iter(loader))
        loader.close()
        model = res["model"]
        optimizer = make_optimizer(cfg, model)
        step = TrainStep(cfg, model, optimizer, make_lr_schedule(cfg, optimizer, 1000),
                         torch.Generator().manual_seed(1))
        rep = [step(batch)["loss"] for _ in range(10)]
        rep = [float(x) for x in rep]
        print(f"repeated batch, 10 steps: losses {[round(x, 6) for x in rep]}", flush=True)
        if not (np.isfinite(rep).all() and rep[-1] < rep[0]):
            raise AssertionError(f"loss did not fall over a repeated batch: {rep}")
        t0 = time.perf_counter()
        for _ in range(5):
            step(batch)
        torch.cuda.synchronize()
        device_ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"train step on a resident batch (no data wait): {device_ms:.2f} ms/step "
              f"({TRAIN_BATCH * 1e3 / device_ms:.2f} images/s)", flush=True)
        kernel_profile(torch, lambda: step(batch), f"one train step (batch {TRAIN_BATCH}, bf16)")
    return {"launches": launches, "ms_step": ms_step, "data_ms": data_ms,
            "resident_ms": device_ms}


def dense_attention_grads(q, k, v, dout, scale):
    """dq, dk, dv of softmax(q k^T * scale) v by autograd in float64."""
    import torch

    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    out = torch.softmax(q @ k.transpose(1, 2) * scale, dim=-1) @ v
    return torch.autograd.grad(out, (q, k, v), dout.double())


def card_vs_cpu_step(torch, np, fa) -> None:
    """One f32 (TF32 off), dropout-0 train step at batch 1 on the card vs the
    same step on the CPU, from the reference init the trainer starts from,
    with the CPU's float64 step as exact arithmetic: the loss, the BN running
    statistics after the forward, the gradients (see STEP_GRAD_RATIO), over
    the whole model and over the CoAM position attention alone, and each K2
    call of the card's step against float64 on its own inputs."""
    from torch import nn

    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.core.loss import make_loss
    from buctd_tpu_torch.models import get_model

    cfg = default_config()
    update_config(cfg, types.SimpleNamespace(cfg=str(CONFIG),
                                             opts=["TPU.COMPUTE_DTYPE", "float32"]))
    torch.manual_seed(3)
    model = get_model(cfg)                                  # device="cuda"
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    cpu = copy.deepcopy(model).cpu()
    f64 = copy.deepcopy(cpu).double()
    rng = np.random.RandomState(5)
    x = np.concatenate([rng.randn(1, 3, 384, 288), rng.uniform(0, 255, (1, 3, 384, 288))], 1)
    tgt = (rng.rand(1, 14, 96, 72) > 0.995)
    tw = rng.rand(1, 14) > 0.2
    loss_fn = make_loss(cfg)
    backward, k2_calls = fa.flash_attention_backward, []

    def recording_backward(q, k, v, out, lse, dout, *args):
        grads = backward(q, k, v, out, lse, dout, *args)
        k2_calls.append([t.detach().cpu() for t in (q, k, v, dout, *grads)] + [args[0]])
        return grads

    res = {}
    for name, m, dev, dt in (("card", model, "cuda", torch.float32),
                             ("cpu", cpu, "cpu", torch.float32),
                             ("f64", f64, "cpu", torch.float64)):
        m.train()
        loss = loss_fn(m(torch.from_numpy(x).to(dev, dt)),
                       torch.from_numpy(tgt).to(dev, dt), torch.from_numpy(tw).to(dev, dt))
        fa.flash_attention_backward = recording_backward if name == "card" else backward
        try:
            loss.backward()
        finally:
            fa.flash_attention_backward = backward
        res[name] = (loss.item(),
                     {k: p.grad.detach().cpu().double() for k, p in m.named_parameters()},
                     {k: b.detach().cpu().double() for k, b in m.named_buffers()
                      if "running" in k})

    # the CoAM position attention: the parameters whose gradient goes through
    # K1/K2 in this step (fc_k.bias left out: the softmax is invariant to it,
    # so its exact gradient is 0)
    every = list(res["cpu"][1])
    att = [k for k in every if "position_attention_module" in k
           and not k.endswith("fc_k.bias")]

    def dist(a, b, keys):   # relative L2 distance of the gradient vector over keys
        num = sum(((res[a][1][k] - res[b][1][k]) ** 2).sum().item() for k in keys)
        return (num / sum((res[b][1][k] ** 2).sum().item() for k in keys)) ** 0.5

    l_card, l_cpu = res["card"][0], res["cpu"][0]
    d_card, d_cpu, d_both = (dist("card", "f64", every), dist("cpu", "f64", every),
                             dist("card", "cpu", every))
    a_card, a_cpu = dist("card", "f64", att), dist("cpu", "f64", att)
    bn_ok = all(torch.allclose(res["card"][2][k], res["cpu"][2][k], rtol=STEP_BN_RTOL,
                               atol=STEP_BN_ATOL) for k in res["cpu"][2])
    bn_err = max((res["card"][2][k] - res["cpu"][2][k]).abs().max().item()
                 for k in res["cpu"][2])
    k2_err = 0.0
    for q, k, v, dout, dq, dk, dv, scale in k2_calls:
        for got, want in zip((dq, dk, dv), dense_attention_grads(q, k, v, dout, scale)):
            k2_err = max(k2_err, (got.double() - want).abs().max().item()
                         / want.abs().max().item())
    print(f"train step card vs CPU (f32, TF32 off, batch 1, dropout 0, reference init): "
          f"loss {l_card:.8f} vs {l_cpu:.8f} (rel {abs(l_card - l_cpu) / abs(l_cpu):.2e}, "
          f"limit {STEP_LOSS_RTOL:.0e}); gradient distance (relative L2) to float64 over "
          f"all {len(every)} tensors: card {d_card:.3e}, CPU {d_cpu:.3e}, card to CPU "
          f"{d_both:.3e}; over the {len(att)} position-attention tensors: card "
          f"{a_card:.3e}, CPU {a_cpu:.3e} (limit card <= {STEP_GRAD_RATIO:g} x CPU on "
          f"both); the step's {len(k2_calls)} K2 calls vs float64 on their inputs: "
          f"max |err| / max |grad| {k2_err:.2e} (limit {STEP_K2_RTOL:.0e}); BN running "
          f"stats max |card - CPU| {bn_err:.2e} (rtol {STEP_BN_RTOL:.0e}, atol "
          f"{STEP_BN_ATOL:.0e})", flush=True)
    if len(k2_calls) != 2:
        raise AssertionError(f"{len(k2_calls)} flash backward calls in the step, not 2")
    if not (abs(l_card - l_cpu) <= STEP_LOSS_RTOL * abs(l_cpu)
            and d_card <= STEP_GRAD_RATIO * d_cpu and a_card <= STEP_GRAD_RATIO * a_cpu
            and k2_err <= STEP_K2_RTOL and bn_ok):
        raise AssertionError("the card's train step disagrees with the CPU's")


def ab_ms(old, new, iters: int) -> tuple:
    """Device times of two versions of one function in turns (old, new, new,
    old), each the mean of ``iters`` launches: the A/B inside one call."""
    a1, b1, b2, a2 = (timed_ms(f, iters) for f in (old, new, new, old))
    return (a1 + a2) / 2, (b1 + b2) / 2


def check_chunked(torch, got, plain, bh: int, chunk: int, *tensors,
                  atol=KERNEL_ATOL, rtol=KERNEL_RTOL) -> list:
    """``got`` (a tuple of (BH, ...) kernel outputs) against the plain
    version ``plain(bh0, *rows)`` over BH chunks starting at row bh0 (the
    plain versions hold (chunk, L, L) f32 tensors; bh0 gives them the dropout
    mask of their rows), to atol/rtol; returns the largest |got - plain| of
    each output."""
    worst = [0.0] * len(got)
    for i in range(0, bh, chunk):
        want = plain(i, *(t[i:i + chunk] for t in tensors))
        for j, (g, w) in enumerate(zip(got, want)):
            torch.testing.assert_close(g[i:i + chunk], w, atol=atol, rtol=rtol)
            worst[j] = max(worst[j], (g[i:i + chunk] - w).abs().max().item())
    return worst


def kvres_kernel_phase(torch, F, fa) -> dict:
    """K1' and K2' vs their plain versions and vs K1/K2, and their times.

    K1': MAIN_CASES, EVAL_CASES and a ragged case in f32 and bf16, checked
    against the plain version (KERNEL_ATOL/RTOL) and K1; timed at EVAL_CASES
    beside K1 (the eval path's sums are the f32 ones).  At TRAIN_CASES (BH 32,
    the training path's shapes) in f32 and bf16 with dropout 0.1: K1' (out,
    lse) against the plain version and K1 (KERNEL_ATOL/RTOL), and K2' (dq,
    dk, dv, from K1''s lse) against the plain backward and K2 (BWD_ATOL/RTOL),
    the plain versions over BH chunks; K2' timed at BH 32 bf16 beside K2."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    res = {k: 0.0 for k in ("fwd_err", "dq_err", "dkv_err", "fwd_k1_gap", "bwd_k2_gap")}
    for key in ("fwd", "k1", "fwd_plain", "fwd_library", "fwd_bound", "fwd_ops"):
        res[f"{key}_ms"] = 0.0
    for bh, lq, lk, d in MAIN_CASES + EVAL_CASES + [(3, 700, 300, 112)]:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q = torch.randn(bh, lq, d, device="cuda", generator=gen).to(dtype)
            k = torch.randn(bh, lk, d, device="cuda", generator=gen).to(dtype)
            v = torch.randn(bh, lk, d, device="cuda", generator=gen).to(dtype)
            scale = d ** -0.5
            out, lse = fa.flash_attention_kvres(q, k, v, scale)
            torch.cuda.synchronize()
            chunk = PLAIN_BH.get(lq, bh)
            err = max(check_chunked(torch, (out, lse), lambda i, a, b, c:
                                    fa.flash_attention_reference(a, b, c, scale),
                                    bh, chunk, q, k, v))
            k1_out, k1_lse = fa.flash_attention(q, k, v, scale)
            torch.testing.assert_close(out, k1_out, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
            torch.testing.assert_close(lse, k1_lse, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
            gap = max((out - k1_out).abs().max().item(), (lse - k1_lse).abs().max().item())
            print(f"K1' flash_fwd_kvres ({bh}, {lq}, {lk}, {d}) {name}: max_abs_err vs "
                  f"plain {err:.3e}, vs K1 {gap:.3e}", flush=True)
            res["fwd_err"] = max(res["fwd_err"], err)
            res["fwd_k1_gap"] = max(res["fwd_k1_gap"], gap)
            if (bh, lq, lk, d) in EVAL_CASES:
                k1_ms, kv_ms = ab_ms(lambda: fa.flash_attention(q, k, v, scale),
                                     lambda: fa.flash_attention_kvres(q, k, v, scale), 10)
                plain_ms = timed_ms(lambda: chunked(
                    lambda a, b, c: fa.flash_attention_reference(a, b, c, scale),
                    bh, chunk, q, k, v), 2)
                q4, k4, v4 = q[:, None], k[:, None], v[:, None]
                lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, scale=scale), 10)
                bound, by = flash_bound_ms(bh, lq, lk, d, name)
                print(f"  eval shape {name}: K1' {kv_ms:.4f} ms, K1 {k1_ms:.4f} ms "
                      f"(K1'/K1 {kv_ms / k1_ms:.3f}), plain {plain_ms:.4f} ms, sdpa "
                      f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}), K1' "
                      f"{4.0 * bh * lq * lk * d / kv_ms / 1e9:.2f} TFLOP/s", flush=True)
                if dtype == torch.float32:
                    for key, val in (("fwd", kv_ms), ("k1", k1_ms), ("fwd_plain", plain_ms),
                                     ("fwd_library", lib_ms), ("fwd_bound", bound),
                                     ("fwd_ops", 4.0 * bh * lq * lk * d
                                      / PEAK_OPS[name] * 1e3)):
                        res[f"{key}_ms"] += val
                del q4, k4, v4
            del q, k, v, out, lse, k1_out, k1_lse
            torch.cuda.empty_cache()

    seed = 4321
    for bh, lq, d in TRAIN_CASES:
        chunk = PLAIN_BH[lq]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(bh, lq, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
            do = torch.randn(bh, lq, d, device="cuda", generator=gen)
            scale = d ** -0.5
            out, lse = fa.flash_attention_kvres(q, k, v, scale, DROPOUT, seed)
            delta = (do * out).sum(-1)
            dq = fa.flash_bwd_dq_kvres(q, k, v, do, lse, delta, scale, DROPOUT, seed)
            dk, dv = fa.flash_bwd_dkv_kvres(q, k, v, do, lse, delta, scale, DROPOUT, seed)
            torch.cuda.synchronize()
            fwd_errs = check_chunked(torch, (out, lse), lambda i, a, b, c:
                                     fa.flash_attention_reference(a, b, c, scale, DROPOUT,
                                                                  seed, bh0=i),
                                     bh, chunk, q, k, v)
            k1 = fa.flash_attention(q, k, v, scale, DROPOUT, seed)
            for got, old in zip((out, lse), k1):
                torch.testing.assert_close(got, old, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
            fwd_gap = max((g - w).abs().max().item() for g, w in zip((out, lse), k1))
            errs = check_chunked(torch, (dq, dk, dv), lambda i, a, b, c, g, l, e:
                                 fa.flash_attention_backward_reference(
                                     a, b, c, g, l, e, scale, DROPOUT, seed, bh0=i),
                                 bh, chunk, q, k, v, do, lse, delta,
                                 atol=BWD_ATOL, rtol=BWD_RTOL)
            k2 = (fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, DROPOUT, seed),
                  *fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, DROPOUT, seed))
            for got, old in zip((dq, dk, dv), k2):
                torch.testing.assert_close(got, old, atol=BWD_ATOL, rtol=BWD_RTOL)
            gaps = [(g - w).abs().max().item() for g, w in zip((dq, dk, dv), k2)]
            res["fwd_err"] = max(res["fwd_err"], *fwd_errs)
            res["fwd_k1_gap"] = max(res["fwd_k1_gap"], fwd_gap)
            res["dq_err"] = max(res["dq_err"], errs[0])
            res["dkv_err"] = max(res["dkv_err"], errs[1], errs[2])
            res["bwd_k2_gap"] = max(res["bwd_k2_gap"], *gaps)
            print(f"K1'+K2' check ({bh}, {lq}, {d}) {str(dtype)[6:]} dropout {DROPOUT}: vs "
                  f"plain out {fwd_errs[0]:.3e} lse {fwd_errs[1]:.3e} dq {errs[0]:.3e} dk "
                  f"{errs[1]:.3e} dv {errs[2]:.3e}; K1' vs K1 {fwd_gap:.3e}, K2' vs K2 "
                  f"{max(gaps):.3e}", flush=True)
            del q, k, v, do, out, lse, delta, dq, dk, dv, k1, k2
            torch.cuda.empty_cache()

    for name in ("dq", "dkv"):
        for key in ("ms", "k2_ms", "bound_ms", "ops_ms"):
            res[f"{name}_{key}"] = 0.0
    for bh, lq, d in TRAIN_CASES:
        q, k, v = (torch.randn(bh, lq, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        do = torch.randn(bh, lq, d, device="cuda", generator=gen)
        scale = d ** -0.5
        out, lse = fa.flash_attention(q, k, v, scale, DROPOUT, seed)
        delta = (do * out).sum(-1)
        args = (q, k, v, do, lse, delta, scale, DROPOUT, seed)
        k2_dq, kv_dq = ab_ms(lambda: fa.flash_bwd_dq(*args),
                             lambda: fa.flash_bwd_dq_kvres(*args), 5)
        k2_dkv, kv_dkv = ab_ms(lambda: fa.flash_bwd_dkv(*args),
                               lambda: fa.flash_bwd_dkv_kvres(*args), 5)
        bounds = {}
        for kind, kv_ms, k2_ms in (("dq", kv_dq, k2_dq), ("dkv", kv_dkv, k2_dkv)):
            bounds[kind], _ = bwd_bound_ms(bh, lq, d, 2, kind)
            res[f"{kind}_ms"] += kv_ms
            res[f"{kind}_k2_ms"] += k2_ms
            res[f"{kind}_bound_ms"] += bounds[kind]
            res[f"{kind}_ops_ms"] += bwd_ops(bh, lq, d, kind) / PEAK_OPS["bfloat16"] * 1e3
        print(f"K2' ({bh}, {lq}, {d}) bf16 dropout {DROPOUT}: dq {kv_dq:.4f} ms (K2 "
              f"{k2_dq:.4f}, K2'/K2 {kv_dq / k2_dq:.3f}, bound {bounds['dq']:.4f}), dkv "
              f"{kv_dkv:.4f} ms (K2 {k2_dkv:.4f}, K2'/K2 {kv_dkv / k2_dkv:.3f}, bound "
              f"{bounds['dkv']:.4f}); plain backward and sdpa fwd+bwd: the train kernels "
              f"line", flush=True)
        del q, k, v, do, out, lse, delta, args
        torch.cuda.empty_cache()
    print(f"A/B sums: K1' {res['fwd_ms']:.4f} ms vs K1 {res['k1_ms']:.4f} ms (f32, eval "
          f"shapes); K2' dq {res['dq_ms']:.4f} vs K2 {res['dq_k2_ms']:.4f} ms, dkv "
          f"{res['dkv_ms']:.4f} vs {res['dkv_k2_ms']:.4f} ms (bf16, training shapes); "
          f"largest gap to K1 {res['fwd_k1_gap']:.3e}, to K2 {res['bwd_k2_gap']:.3e}",
          flush=True)
    return res


def write_bu_predictions(np, ann_file: Path, image_dir: Path, seed: int = 1) -> Path:
    """A BU-prediction json beside ``ann_file``: one entry per image
    ({'preds', 'scores', 'image_paths'}), each person's GT joints jittered by
    N(0, 6 px) with confidences in [0.3, 1], about 1 joint in 8 zeroed (not
    detected)."""
    gt = json.loads(ann_file.read_text())
    rng = np.random.RandomState(seed)
    out = []
    for img in gt["images"]:
        preds, scores = [], []
        for a in gt["annotations"]:
            if a["image_id"] != img["id"]:
                continue
            kp = np.array(a["keypoints"], np.float64).reshape(-1, 3)
            kp[:, :2] += rng.randn(len(kp), 2) * 6.0
            kp[:, 2] = rng.uniform(0.3, 1.0, len(kp))
            kp[rng.rand(len(kp)) < 0.125] = 0.0
            preds.append(kp.tolist())
            scores.append(float(rng.uniform(0.5, 1.0)))
        out.append({"preds": preds, "scores": scores,
                    "image_paths": [str(image_dir / img["file_name"])]})
    path = ann_file.with_name("bu_predictions.json")
    path.write_text(json.dumps(out))
    return path


def eval_phase(torch, np, fa, tw) -> dict:
    """Evaluation at full width through ``valid.run.main`` (3 rounds), the
    same for one round under BUCTD_FLASH_KVRES=1, K1 vs K1' heatmaps on one
    batch, a profile of one validate step, and one batch-2 validate step on
    the card vs the CPU."""
    import os

    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.core.function import make_validate_step
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.valid import run as valid_run

    res = {}
    with tempfile.TemporaryDirectory(prefix="buctd_eval_") as tmp:
        root = Path(tmp)
        ann = write_synthetic_crowdpose(np, root, EVAL_IMAGES, SYNTH_PEOPLE, seed=11)
        bu = write_bu_predictions(np, ann, root)
        torch.manual_seed(5)
        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(CONFIG), opts=[]))
        model = get_model(cfg)
        randomize(torch, model)
        weights = root / "random_weights.pth"
        torch.save(model.state_dict(), weights)
        del model
        opts = ["TPU.DEVICE_PIPELINE", "True", "DATASET.TEST_IMAGE_DIR", str(root),
                "DATASET.TEST_ANNOTATION_FILE", str(ann), "TEST.COCO_BBOX_FILE", str(bu),
                "TEST.BATCH_SIZE_PER_GPU", str(EVAL_BATCH), "TEST.MODEL_FILE", str(weights),
                "TEST.FLIP_TEST", "True", "TEST.POST_PROCESS", "True",
                "TEST.SHIFT_HEATMAP", "True", "PRINT_FREQ", "100"]
        print(f"evaluation: synthetic CrowdPose test set of {EVAL_IMAGES} images x "
              f"{SYNTH_PEOPLE} people, BU predictions {bu.name}, weights {weights.name}",
              flush=True)

        counted = (fa.flash_attention, fa.flash_attention_kvres, tw.warp_resample)
        for f in counted:
            f.launches = 0                                   # the main path's run
        t0 = time.perf_counter()
        out = valid_run.main(["--cfg", str(CONFIG), *opts, "OUTPUT_DIR", str(root / "out"),
                              "TEST.REFINE_ITERS", str(EVAL_ROUNDS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": fa.flash_attention.launches,
                    "flash_fwd_kvres": fa.flash_attention_kvres.launches,
                    "warp_resample": tw.warp_resample.launches}
        batches = -(-EVAL_IMAGES * SYNTH_PEOPLE // EVAL_BATCH)
        want = {"flash_fwd": 2 * batches * EVAL_ROUNDS, "flash_fwd_kvres": 0,
                "warp_resample": 2 * batches * EVAL_ROUNDS}
        print(f"evaluation run: {EVAL_ROUNDS} rounds in {wall:.1f} s (model build and "
              f"data included); launches {launches}, expected {want} (K1 and K4: 2 per "
              f"batch of {EVAL_BATCH} crops, {batches} batches a round)", flush=True)
        for it, r in enumerate(out["rounds"]):
            rows = json.loads(Path(r["results"]).read_text())
            print(f"  round {it}: AP {r['AP']!r}, {r['crops']} crops, results json "
                  f"{len(rows)} entries; eval loop {r['loop_s']:.3f} s = "
                  f"{r['crops'] / r['loop_s']:.2f} crops/s (host clock, to the results "
                  f"on the host), evaluate {r['evaluate_s']:.3f} s; loss {r['loss']:.6f} "
                  f"acc {r['acc']:.3f}", flush=True)
            if len(rows) != r["crops"] or r["crops"] != EVAL_IMAGES * SYNTH_PEOPLE:
                raise AssertionError(f"round {it}: {len(rows)} results for "
                                     f"{r['crops']} crops")
            if not (np.isfinite(r["AP"]) and 0.0 <= r["AP"] <= 1.0):
                raise AssertionError(f"round {it}: AP {r['AP']}")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        res["launches"] = launches
        model = out["model"]

        # the same evaluation, one round, under BUCTD_FLASH_KVRES=1
        os.environ["BUCTD_FLASH_KVRES"] = "1"
        try:
            for f in counted:
                f.launches = 0
            kv = valid_run.main(["--cfg", str(CONFIG), *opts,
                                 "OUTPUT_DIR", str(root / "out_kvres")])
            kv_launches = {"flash_fwd": fa.flash_attention.launches,
                           "flash_fwd_kvres": fa.flash_attention_kvres.launches}
        finally:
            del os.environ["BUCTD_FLASH_KVRES"]
        r = kv["rounds"][0]
        print(f"evaluation under BUCTD_FLASH_KVRES=1, one round: AP {r['AP']!r} (K1's "
              f"round 0: {out['rounds'][0]['AP']!r}), {r['crops'] / r['loop_s']:.2f} "
              f"crops/s; launches {kv_launches}", flush=True)
        if kv_launches != {"flash_fwd": 0, "flash_fwd_kvres": 2 * batches}:
            raise AssertionError(f"kv-resident eval launches {kv_launches}")
        res["kvres_launches"] = kv_launches["flash_fwd_kvres"]
        del kv

        # the evaluation protocol on a known answer: the BU predictions (GT +
        # 6 px noise, 1 joint in 8 missing) as the predictions score a high AP
        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(CONFIG), opts=opts))
        ds = get_dataset(cfg, is_train=False)
        preds = np.stack([np.concatenate([r["cond_joints"][:, :2],
                                          r["cond_joints_vis"][:, :1]], 1) for r in ds.db])
        boxes = np.array([[*r["center"], *r["scale"], np.prod(r["scale"] * 200), r["score"],
                           -1] for r in ds.db])
        _, bu_ap = ds.evaluate(cfg, preds, str(root / "bu_eval"), boxes,
                               [r["image"] for r in ds.db])
        print(f"evaluate on the BU predictions themselves ({len(ds.db)} poses): AP "
              f"{bu_ap!r} (limit > 0.3)", flush=True)
        if not bu_ap > 0.3:
            raise AssertionError(f"AP {bu_ap} of near-GT predictions")

        # one batch: K1 vs K1' heatmaps, a profile, the card vs the CPU
        loader = DeviceLoader(ds, cfg, num_workers=4)
        batch = next(iter(loader))
        loader.close()
        step = make_validate_step(cfg, model, ds.flip_pairs, ds.kpt_colors)
        hm_k1 = step(batch)[5]
        os.environ["BUCTD_FLASH_KVRES"] = "1"
        try:
            hm_kv = step(batch)[5]
        finally:
            del os.environ["BUCTD_FLASH_KVRES"]
        peak = hm_k1.abs().max().item()
        gap = (hm_kv - hm_k1).abs().max().item()
        print(f"one eval batch ({EVAL_BATCH} crops, flip test): heatmaps K1' vs K1 max "
              f"|diff| {gap:.3e}, peak {peak:.3e}, limit {KVRES_HM_RTOL:.0e} x peak",
              flush=True)
        if not gap <= KVRES_HM_RTOL * peak:
            raise AssertionError("K1' heatmaps disagree with K1's")
        kernel_profile(torch, lambda: step(batch),
                       f"one validate step (batch {EVAL_BATCH}, flip test: 64 crops, f32)")

        small = {k: v[:2] for k, v in batch.items()}
        cpu_model = copy.deepcopy(model).cpu()
        hm_card = step(small)[5].cpu()
        cpu_small = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in small.items()}
        hm_cpu = make_validate_step(cfg, cpu_model, ds.flip_pairs, ds.kpt_colors)(
            cpu_small)[5]
        err = (hm_card - hm_cpu).abs().max().item()
        peak = hm_cpu.abs().max().item()
        print(f"validate step, batch 2, card vs CPU: heatmaps max |diff| {err:.3e}, peak "
              f"{peak:.3e}, limit {FORWARD_RTOL:.0e} x peak", flush=True)
        if not err <= FORWARD_RTOL * peak:
            raise AssertionError("the card's validate step disagrees with the CPU's")
    return res


def kvres_training_phase(torch, np, fa) -> dict:
    """KVRES_TRAIN_STEPS trainer steps under BUCTD_FLASH_KVRES=1: K1' and K2'
    only, a finite loss."""
    import os

    from buctd_tpu_torch.train import run

    counted = {"flash_fwd": fa.flash_attention, "flash_bwd_dq": fa.flash_bwd_dq,
               "flash_bwd_dkv": fa.flash_bwd_dkv, "flash_fwd_kvres": fa.flash_attention_kvres,
               "flash_bwd_dq_kvres": fa.flash_bwd_dq_kvres,
               "flash_bwd_dkv_kvres": fa.flash_bwd_dkv_kvres}
    with tempfile.TemporaryDirectory(prefix="buctd_kvres_train_") as tmp:
        root = Path(tmp)
        ann = write_synthetic_crowdpose(np, root, 24, SYNTH_PEOPLE, seed=3)
        for f in counted.values():
            f.launches = 0
        os.environ["BUCTD_FLASH_KVRES"] = "1"
        try:
            res = run.main(["--cfg", str(CONFIG), "--steps", str(KVRES_TRAIN_STEPS),
                            "--no-eval", "--seed", "1", "TPU.DEVICE_PIPELINE", "True",
                            "DATASET.TRAIN_IMAGE_DIR", str(root),
                            "DATASET.TRAIN_ANNOTATION_FILE", str(ann),
                            "OUTPUT_DIR", str(root / "out")])
            torch.cuda.synchronize()
        finally:
            del os.environ["BUCTD_FLASH_KVRES"]
    launches = {k: f.launches for k, f in counted.items()}
    losses = [float(m["loss"]) for st in res["stats"] for m in st["metrics"]]
    n = 2 * KVRES_TRAIN_STEPS
    want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_fwd_kvres": n,
            "flash_bwd_dq_kvres": n, "flash_bwd_dkv_kvres": n}
    print(f"training under BUCTD_FLASH_KVRES=1: {res['steps']} steps, losses "
          f"{[round(x, 6) for x in losses]}; launches {launches}, expected {want}",
          flush=True)
    if launches != want or res["steps"] != KVRES_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"kv-resident training: launches {launches}, losses {losses}")
    return launches


def fused_block_phase(torch, fb) -> dict:
    """(a) K5 vs its plain version at the four W48 branch geometries: batch
    K5_CHECK_BATCH in f32 and bf16, and the benchmark's own inputs (batch 128,
    bf16, bench_block's scales and seed: the tensors the tools phase times);
    the plain version's time on those, summed over the branches.  K5's and
    cuDNN's times come from the tools phase."""
    from buctd_tpu_torch.tools import bench_block as bb

    gen = torch.Generator(device="cuda").manual_seed(6)
    res = {"err_f32": 0.0, "err_bf16": 0.0, "plain_ms": 0.0}

    def check(label, args, tol, key):
        got = fb.fused_basic_block(*args)
        torch.cuda.synchronize()
        want = fb.fused_basic_block_plain(*args)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        err = (got.float() - want.float()).abs().max().item()
        res[key] = max(res[key], err)
        print(f"K5 fused_block {label}: max_abs_err {err:.3e} (output max "
              f"{want.float().abs().max().item():.3f}, limit atol = rtol = {tol:.3g}), "
              f"{(got != want).float().mean().item() * 100:.3f}% of outputs differ", flush=True)

    for _, h, w, c in bb.BRANCHES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = torch.randn(K5_CHECK_BATCH, h, w, c, device="cuda", generator=gen)
            ws = [torch.randn(3, 3, c, c, device="cuda", generator=gen) / (3 * c ** 0.5)
                  for _ in range(2)]
            bs = [torch.randn(c, device="cuda", generator=gen) * 0.1 for _ in range(2)]
            check(f"({K5_CHECK_BATCH}, {h}, {w}, {c}) {name}",
                  [t.to(dtype) for t in (x, *ws, *bs)], K5_ATOL[name],
                  "err_f32" if dtype == torch.float32 else "err_bf16")
            del x, ws, bs
    gen = torch.Generator(device="cuda").manual_seed(0)       # bench_block's default seed
    for _, h, w, c in bb.BRANCHES:
        args = bb.branch_inputs(gen, bb.BATCH, h, w, c)
        check(f"({bb.BATCH}, {h}, {w}, {c}) bfloat16, the benchmark's inputs", args,
              K5_ATOL["bfloat16"], "err_bf16")
        plain_ms = timed_ms(lambda: fb.fused_basic_block_plain(*args), 3)
        print(f"  K5 plain version ({bb.BATCH}, {h}, {w}, {c}) bf16: {plain_ms:.4f} ms",
              flush=True)
        res["plain_ms"] += plain_ms
        del args
    torch.cuda.empty_cache()
    return res


def fused_block_vs_trunk(torch, np, fb) -> float:
    """(b) K5 vs the port's trunk, f32, TF32 off: one stage-4 BasicBlock per
    branch of a full-width preNet-W48 with random weights, BN affine and BN
    running statistics, folded with models/fuse.py::fold_bn; K5's output vs the
    module's eval forward within K5_TRUNK_RTOL x the output's max."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.models.fuse import fold_bn

    cfg = default_config()
    update_config(cfg, types.SimpleNamespace(cfg=str(PRENET_CONFIG), opts=[]))
    torch.manual_seed(8)
    model = get_model(cfg)
    randomize(torch, model)
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = 0.0
    with torch.inference_mode():
        for i, branch in enumerate(model.stage4[0].branches):
            blk = branch[0]
            c = blk.conv1.in_channels
            h, w = (96 >> i, 72 >> i) if i < 3 else (12, 9)
            x = torch.relu(torch.randn(K5_CHECK_BATCH, c, h, w, device="cuda", generator=gen))
            want = blk(x)
            (w1, b1), (w2, b2) = fold_bn(blk.conv1, blk.bn1), fold_bn(blk.conv2, blk.bn2)
            got = fb.fused_basic_block(x.permute(0, 2, 3, 1).contiguous(),
                                       w1.permute(2, 3, 1, 0).contiguous(),
                                       w2.permute(2, 3, 1, 0).contiguous(), b1, b2)
            got = got.permute(0, 3, 1, 2)
            rel = ((got - want).abs().max() / want.abs().max()).item()
            worst = max(worst, rel)
            print(f"K5 vs stage4.0.branches.{i}.0 ({K5_CHECK_BATCH}, {c}, {h}, {w}) f32, "
                  f"folded BN: max |diff| / max {rel:.3e} (limit {K5_TRUNK_RTOL:.0e})",
                  flush=True)
            if not rel <= K5_TRUNK_RTOL:
                raise AssertionError(f"K5 disagrees with the trunk's BasicBlock {i}")
    del model
    torch.cuda.empty_cache()
    return worst


def exp_phase(torch, ex) -> dict:
    """(c) K6 vs its plain version, the three variants, rtol K6_RTOL: OUTER
    chained launches of the full chain (every value ends at the chain's fixed
    point), and single launches of 1, 2 and 3 steps on inputs spread over
    [-100, 100] (where the input and the step count still show); the plain
    chains' device time (replayed from a CUDA graph), summed over the variants.
    K6's and the torch chains' times come from the tools phase."""
    from buctd_tpu_torch.tools import bench_exp2 as be

    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.rand(be.ROWS, be.COLS, device="cuda", generator=gen) + 0.5
    wide = torch.rand(be.ROWS, be.COLS, device="cuda", generator=gen) * 200 - 100
    res = {"err": 0.0, "plain_ms": 0.0}

    def chained(f, v):
        y = x
        for _ in range(be.OUTER):
            y = f(y, v)
        return y

    def check(got, want):
        torch.testing.assert_close(got, want, atol=0, rtol=K6_RTOL)
        err = (got - want).abs().max().item()
        res["err"] = max(res["err"], err)
        return err

    for v in ex.VARIANTS:
        got = chained(ex.exp_chain, v)
        torch.cuda.synchronize()
        err = check(got, chained(ex.exp_chain_plain, v))
        short = []
        for inner in (1, 2, 3):
            one = ex.exp_chain(wide, v, inner)
            torch.cuda.synchronize()
            short.append(f"{inner} step{'s' if inner > 1 else ''} "
                         f"{check(one, ex.exp_chain_plain(wide, v, inner)):.3e} "
                         f"({one.min().item():.4g}..{one.max().item():.4g})")
        plain = functools.partial(chained, ex.exp_chain_plain, v)
        plain_ms = be.events_ms(be.captured(plain).replay)
        res["plain_ms"] += plain_ms
        print(f"K6 exp_throughput {v} ({be.ROWS}, {be.COLS}): {ex.INNER} steps x {be.OUTER}: "
              f"max_abs_err {err:.3e} (values {got.min().item():.6f}..{got.max().item():.6f}); "
              f"on [-100, 100]: {', '.join(short)}; rtol {K6_RTOL:.0e}; plain version "
              f"{plain_ms:.4f} ms device time", flush=True)
    return res


def prenet_serving_phase(torch, np) -> dict:
    """(d) preNet-W48 serving at full width through PoseEstimator, from one
    .pth of random weights, with TPU.FUSED_PRENET off and auto: finite
    predictions, fused within PRENET_PX_TOL px of unfused, each forward on the
    card vs the CPU, crops/s of predict_batch, a profile of each."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.serving import PoseEstimator

    def config(knob):
        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(PRENET_CONFIG),
                                                 opts=["TPU.FUSED_PRENET", knob]))
        return cfg

    res = {}
    rng = np.random.RandomState(12)
    img, conds = sample_request(np, rng)
    batch = [sample_request(np, rng) for _ in range(3)]
    images, poses = [b[0] for b in batch], [b[1] for b in batch]
    x = torch.from_numpy(rng.randn(1, 6, 384, 288).astype(np.float32))
    keep = float("-inf")
    with tempfile.TemporaryDirectory(prefix="buctd_prenet_") as tmp:
        torch.manual_seed(11)
        model = get_model(config("off"))
        randomize(torch, model)
        weights = Path(tmp) / "prenet_random.pth"
        torch.save(model.state_dict(), weights)
        print(f"preNet-W48 serving: {model.__class__.__name__} "
              f"{sum(p.numel() for p in model.parameters())} parameters, weights "
              f"{weights.name}, {ROUNDS} rounds", flush=True)
        del model
        for knob in ("off", "auto"):
            est = PoseEstimator(config(knob), checkpoint=str(weights), refine_iters=ROUNDS)
            if est.model.fused_prenet != (knob == "auto"):
                raise AssertionError(f"FUSED_PRENET {knob}: fused_prenet "
                                     f"{est.model.fused_prenet}")
            est.predict(img, conds, keep)                       # cuDNN set-up
            est.predict_batch(images, poses, keep)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(REPEATS):
                out = est.predict(img, conds, keep)
            t1 = time.perf_counter()
            for _ in range(REPEATS):
                outs = est.predict_batch(images, poses, keep)
            t2 = time.perf_counter()
            for o in [out, *outs]:
                if o.shape != (4, 14, 3) or not np.isfinite(o).all():
                    raise AssertionError(f"preNet {knob}: prediction {o.shape}")
            with torch.inference_mode():
                got = est.model(x.cuda()).cpu()
                want = copy.deepcopy(est.model).cpu()(x)
            err, peak = (got - want).abs().max().item(), want.abs().max().item()
            ms_predict = (t1 - t0) / REPEATS * 1e3
            ms_batch = (t2 - t1) / REPEATS * 1e3
            print(f"preNet FUSED_PRENET {knob}: predict {ms_predict:.2f} ms/image "
                  f"({4 * 1e3 / ms_predict:.2f} crops/s); predict_batch (3 images x 4 poses, "
                  f"padded to 4) {ms_batch / 3:.2f} ms/image, {12 * 1e3 / ms_batch:.2f} "
                  f"crops/s; forward card vs CPU max_abs_err {err:.3e}, peak {peak:.3e}, "
                  f"limit {FORWARD_RTOL:.0e} x peak", flush=True)
            if not err <= FORWARD_RTOL * peak:
                raise AssertionError(f"preNet {knob}: the card forward disagrees with the CPU")
            kernel_profile(torch, lambda: est.predict_batch(images, poses, keep),
                           f"preNet-W48 predict_batch, FUSED_PRENET {knob} "
                           f"(3 images x 4 poses, 3 rounds)")
            res[knob] = {"predict": out, "batch": outs, "ms_predict": ms_predict,
                         "ms_batch": ms_batch, "heatmaps": got}
            del est
            torch.cuda.empty_cache()
    gap_px = max(np.abs(a[..., :2] - b[..., :2]).max() for a, b in zip(
        [res["off"]["predict"], *res["off"]["batch"]],
        [res["auto"]["predict"], *res["auto"]["batch"]]))
    hm_gap = ((res["off"]["heatmaps"] - res["auto"]["heatmaps"]).abs().max()
              / res["off"]["heatmaps"].abs().max()).item()
    print(f"preNet fused vs unfused: predictions max |diff| {gap_px:.3e} px (limit "
          f"{PRENET_PX_TOL} px), one forward's heatmaps max |diff| / max {hm_gap:.3e}",
          flush=True)
    if not (gap_px <= PRENET_PX_TOL and hm_gap <= PRENET_FWD_RTOL):
        raise AssertionError("the fused preNet disagrees with the unfused")
    return res


def tools_phase(torch, fb, ex) -> dict:
    """(e) The three port tools, reduced: bench_block --fused, bench_exp2 and
    bench_stem; the launch counts of K5 and K6 over these runs (their main
    path)."""
    from buctd_tpu_torch.tools import bench_block, bench_exp2, bench_stem

    fb.fused_basic_block.launches = 0                    # the main path's run
    ex.exp_chain.launches = 0
    block = bench_block.main(["--fused", "--chain", str(TOOL_CHAIN), "--rounds",
                              str(TOOL_ROUNDS)])
    exp = bench_exp2.main(["--rounds", str(TOOL_ROUNDS)])
    launches = {"fused_basic_block": fb.fused_basic_block.launches,
                "exp_throughput": ex.exp_chain.launches}
    stem = bench_stem.main([str(TOOL_STEM_BATCH), "--steps", "3", "--rounds",
                            str(TOOL_ROUNDS)])
    want = {"fused_basic_block": 4 * (TOOL_CHAIN * TOOL_ROUNDS + 1),
            "exp_throughput": len(ex.VARIANTS) * bench_exp2.OUTER * (2 * TOOL_ROUNDS + 2)}
    print(f"tools: launches {launches}, expected {want} (K5: 4 branches x (chain x rounds "
          f"+ warm-up); K6: 3 variants x {bench_exp2.OUTER} x (2 timings x rounds + "
          f"2 to take the host's issue time))", flush=True)
    if launches != want:
        raise AssertionError(f"tool launch counts {launches} != {want}")
    # every step is one MUFU.EX2 at least, and the bound takes the card's
    # highest SM clock: a chain faster than the bound skipped steps
    fast = {v: exp[v]["ms"] for v in ex.VARIANTS if not exp[v]["ms"] >= exp["bound_ms"]}
    if fast:
        raise AssertionError(f"K6 faster than its SFU bound {exp['bound_ms']:.4f} ms: {fast}")
    ratio = {k: round(v["cudnn_ms"] / v["fused_ms"], 4) for k, v in block.items()}
    print(f"tools: cuDNN/K5 by branch {ratio}; bench_stem b{TOOL_STEM_BATCH}: preNet "
          f"{stem[TOOL_STEM_BATCH]['prenet_ms']:.4f} -> fused "
          f"{stem[TOOL_STEM_BATCH]['fused_prenet_ms']:.4f} ms, forward "
          f"{stem[TOOL_STEM_BATCH]['forward_ms']:.4f} -> "
          f"{stem[TOOL_STEM_BATCH]['fused_forward_ms']:.4f} ms", flush=True)
    if not stem[TOOL_STEM_BATCH]["rel_gap"] <= PRENET_FWD_RTOL:
        raise AssertionError("bench_stem: fused forward disagrees with the canonical one")
    return {"launches": launches, "block": block, "exp": exp, "stem": stem}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from buctd_tpu_torch import _build
    from buctd_tpu_torch.ops import exp_throughput as ex
    from buctd_tpu_torch.ops import flash_attention as fa
    from buctd_tpu_torch.ops import fused_block as fb
    from buctd_tpu_torch.ops import warp as tw

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    start = t0 = time.perf_counter()
    names = _build.build_all()
    print(f"built {names} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in names:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    k1 = kernel_phase(torch, F, fa)
    tk = train_kernel_phase(torch, F, fa, tw)
    kv = kvres_kernel_phase(torch, F, fa)
    serving = serving_phase(torch, np, fa)
    est = serving["est"]
    kernel_profile(torch, lambda: est.predict_batch(serving["images"], serving["poses"],
                                                    float("-inf")),
                   "predict_batch (3 images x 4 poses, 3 rounds)")
    serving_launches = serving["launches"]
    del est
    del serving
    torch.cuda.empty_cache()
    train = training_phase(torch, np, fa, tw)
    card_vs_cpu_step(torch, np, fa)
    torch.cuda.empty_cache()
    ev = eval_phase(torch, np, fa, tw)
    torch.cuda.empty_cache()
    kv_train = kvres_training_phase(torch, np, fa)
    torch.cuda.empty_cache()
    k5 = fused_block_phase(torch, fb)
    k5_trunk = fused_block_vs_trunk(torch, np, fb)
    k6 = exp_phase(torch, ex)
    prenet_serving_phase(torch, np)
    tools = tools_phase(torch, fb, ex)

    def bound_by(ops_ms, bound_ms):
        return "operations" if ops_ms >= bound_ms else "bytes"

    def entry(name, source, replaces, launches, err, key):
        bound, ops = tk[f"{key}_bound_ms"], tk.get(f"{key}_ops_ms", 0.0)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": tk[f"{key}_ms"],
                "plain_ms": tk[f"{key}_plain_ms"], "bound_ms": bound,
                "bound_by": bound_by(ops, bound), "library_ms": tk[f"{key}_library_ms"]}

    def kv_bwd_entry(kind, replaces):
        return {"name": f"flash_bwd_{kind}_kvres", "route": "cuda",
                "source": "buctd_tpu_torch/csrc/flash_bwd_kvres.cu",
                "replaces": f"buctd_tpu/ops/flash_attention.py:{replaces}",
                "launches": kv_train[f"flash_bwd_{kind}_kvres"],
                "max_abs_err": kv[f"{kind}_err"], "ms": kv[f"{kind}_ms"],
                # one plain backward, and one SDPA forward+backward, give dq, dk
                # and dv: timed in the training kernel phase at the same shapes
                "plain_ms": tk[f"{kind}_plain_ms"], "bound_ms": kv[f"{kind}_bound_ms"],
                "bound_by": bound_by(kv[f"{kind}_ops_ms"], kv[f"{kind}_bound_ms"]),
                "library_ms": tk[f"{kind}_library_ms"]}

    # K5: ms per block summed over the 4 branches, from bench_block's chained,
    # interleaved medians; K6: OUTER launches summed over the 3 variants, from
    # bench_exp2's device-time medians
    block = tools["block"].values()
    k5.update({key: sum(r[src] for r in block) for key, src in (
        ("ms", "fused_ms"), ("library_ms", "cudnn_ms"), ("bound_ms", "bound_ms"),
        ("ops_ms", "bf16_ms"))})
    exp = tools["exp"]
    k6.update({key: sum(exp[v][key] for v in ex.VARIANTS) for key in ("ms", "library_ms")})
    k6.update(bound_ms=len(ex.VARIANTS) * exp["bound_ms"], bound_by=exp["bound_by"])
    print(f"K5 sums over the 4 branches at b128 bf16: kernel {k5['ms']:.4f} ms, plain "
          f"{k5['plain_ms']:.4f}, cuDNN {k5['library_ms']:.4f}, bound {k5['bound_ms']:.4f}; "
          f"max err f32 {k5['err_f32']:.3e}, bf16 {k5['err_bf16']:.3e}; vs the trunk "
          f"{k5_trunk:.3e} of the max", flush=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "buctd_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "buctd_tpu/ops/flash_attention.py:86",
         "launches": (serving_launches + train["launches"]["flash_fwd"]
                      + ev["launches"]["flash_fwd"]),
         "max_abs_err": max(k1["max_abs_err"], tk["fwd_err"]),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": bound_by(k1["ops_ms"], k1["bound_ms"]),
         "library_ms": k1["library_ms"]},
        {"name": "flash_fwd_kvres", "route": "cuda",
         "source": "buctd_tpu_torch/csrc/flash_fwd_kvres.cu",
         "replaces": "buctd_tpu/ops/flash_attention.py:139",
         "launches": ev["kvres_launches"] + kv_train["flash_fwd_kvres"],
         "max_abs_err": kv["fwd_err"], "ms": kv["fwd_ms"], "plain_ms": kv["fwd_plain_ms"],
         "bound_ms": kv["fwd_bound_ms"], "bound_by": bound_by(kv["fwd_ops_ms"],
                                                              kv["fwd_bound_ms"]),
         "library_ms": kv["fwd_library_ms"]},
        entry("flash_bwd_dq", "buctd_tpu_torch/csrc/flash_bwd.cu",
              "buctd_tpu/ops/flash_attention.py:212", train["launches"]["flash_bwd_dq"],
              tk["dq_err"], "dq"),
        entry("flash_bwd_dkv", "buctd_tpu_torch/csrc/flash_bwd.cu",
              "buctd_tpu/ops/flash_attention.py:363", train["launches"]["flash_bwd_dkv"],
              tk["dkv_err"], "dkv"),
        kv_bwd_entry("dq", 245),
        kv_bwd_entry("dkv", 295),
        entry("warp_resample", "buctd_tpu_torch/csrc/warp_resample.cu",
              "buctd_tpu/ops/pallas_warp.py:30",
              train["launches"]["warp_resample"] + ev["launches"]["warp_resample"],
              tk["warp_err"], "warp"),
        {"name": "fused_basic_block", "route": "cuda",
         "source": "buctd_tpu_torch/csrc/fused_block.cu",
         "replaces": "buctd_tpu/ops/pallas_block.py:106",
         "launches": tools["launches"]["fused_basic_block"],
         "max_abs_err": max(k5["err_f32"], k5["err_bf16"]),
         "ms": k5["ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
         "bound_by": bound_by(k5["ops_ms"], k5["bound_ms"]), "library_ms": k5["library_ms"]},
        {"name": "exp_throughput", "route": "cuda",
         "source": "buctd_tpu_torch/csrc/exp_throughput.cu",
         "replaces": "tools/bench_exp2.py:34",
         "launches": tools["launches"]["exp_throughput"], "max_abs_err": k6["err"],
         "ms": k6["ms"], "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"],
         "bound_by": k6["bound_by"], "library_ms": k6["library_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
