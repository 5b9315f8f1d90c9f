#!/usr/bin/env python3
"""Smoke run of buctd_tpu_torch on one NVIDIA GPU (H100): builds the CUDA
kernels, holds each against its plain PyTorch version, serves full-width
BUCTD-CoAM-W48 and BUCTD-TransPose-H through PoseEstimator with 3 refinement
rounds, trains both for a few steps through the training entry point,
evaluates CoAM-W48 with the flip test and 3 refinement rounds and
TransPose-H for one round through the evaluation entry point, serves
full-width BUCTD-preNet-W48 with its preNet fused and not, serves and
evaluates each family in bf16 as well (TPU.EVAL_DTYPE bfloat16), serves,
evaluates and trains pose_resnet-50 with the preNet, runs the lambda sweep,
the OCHuman and animal evaluation rounds and the standalone inference entry,
trains and evaluates on the host cv2 Loader (the JAX default data path),
runs the AP-parity runner on an orbax checkpoint, and runs the port's
benchmarks of the fused basic block (K5) and exp throughput (K6).

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  0. build every kernel under buctd_tpu_torch/csrc/ with nvcc for sm_90a (one
     nvcc per source, all started together); in the SASS (cuobjdump) of the
     four flash libraries and K5's, HMMA in every tensor-core kernel (K5's
     ``fused_block_tc_kernel`` and ``fused_block_tf32_kernel``, one a tile
     plan) and in no SIMT one, and TF32 HMMA in every f32 mma.sync kernel of
     K1, K1', K2, K2' and K5, and wgmma (HGMMA) and TMA loads (UTMALDG) in
     every instantiation of bf16 K1's and K1''s wgmma kernel and of bf16 K2's
     and K2''s wgmma pair, and TF32 HGMMA and UTMALDG (and no HMMA) in every
     instantiation of f32 K1's and K1''s wgmma kernel (F32_K1_KERNEL) and of
     f32 K2's and K2''s wgmma pair (F32_K2_KERNELS); a NaN in q reaches f32
     K1's and K2's (their wgmma kernels and their mma.sync kernels), K1''s
     and K2''s outputs (at d = 48, 96 and 112), and a NaN in x K5's (both
     dtypes, tensor cores and SIMT), where it reaches the plain versions'
     (``nan_phase``);
  1. kernels, serving and evaluation shapes: K1 (flash-attention forward on
     the tensor cores: f32 in 3xTF32 on TMA + wgmma, flash_fwd_tf32_wgmma.cuh,
     bf16) vs its plain version at the
     CoAM-W48 shapes (16 crops, as predict_batch gives them, 64 as a
     flip-test validate batch of 32 gives them, and 8) and at TransPose-H's
     d = 112 (TP_F32_CASES: BH 16 and 32, L 6912) in f32 and bf16, plus a
     ragged case and d = 47; f32 with dropout 0 and 0.1 at
     KERNEL_ATOL/RTOL, where the one-pass tf32 control must miss at the
     evaluation shapes, and f32 K2 at the ragged case and d = 47 (its wgmma
     pair and its mma.sync pair, by the dispatch) at BWD_ATOL/RTOL;
     bf16 against the plain forward that rounds where it
     does, within K1_BF16_RTOL, and against the rounding at the kernel's
     running tile max, within K1_BF16_TILED_RMS, which p left unrounded
     misses; kernel, plain and F.scaled_dot_product_attention times beside
     the card's bound; f32 K1 (its wgmma kernel), the mma.sync kernel it
     replaced and SDPA's f32 forward timed in turns, with the wgmma grid's
     waves; bf16 K1 at dropout 0 (the bf16 serving and evaluation paths: the
     TMA + wgmma kernel, flash_fwd_wgmma.cuh), the mma.sync kernel it
     replaced and SDPA's bf16 forward timed in turns, with the wgmma grid's
     waves, summed over the same serving and evaluation shapes for the
     kernels line;
  2. kernels, training shapes: K1 and K2 (flash backward: the dq and the dk/dv
     kernels; on the tensor cores and TMA + wgmma, f32 in 3xTF32,
     flash_bwd_tf32_wgmma.cuh, bf16 flash_bwd_wgmma.cuh, which the dispatch
     must pick and the counters show) at the shapes a batch-32
     train step gives them, f32 and bf16, dropout 0 and 0.1, vs their plain
     versions over BH chunks (f32 K2's one-pass tf32 control must miss the
     gate; bf16 against the plain versions that round where they do, K2's
     distance to the f32 plain version printed, and rows of exp(s' - lse)
     from bf16 K1 summing to 1), and K4 (rotated warp: the fused kernel vs
     the plain version, bit for bit vs the two-pass form it replaced and
     timed against it in turns; the uint8 source with mask rectangles (the
     loaders' input) vs the plain version of the f32 masked images and bit for
     bit vs the f32 warp of them; at rotation 0 and the evaluation scales
     vs F.grid_sample, the same function there; the loader's work before the
     render, the former cast-mask-warp chain vs the fused read); their bf16 times
     beside (K1) the mma.sync kernel and SDPA's forward and (K2, at dropout
     0.1 and 0) the mma.sync kernels and SDPA's backward alone in turns, the
     wgmma grids, the tensor-core, MUFU and dropout-hash floors; then the same bf16
     checks and times of K1 and K2 at TransPose-H's training shape
     (TP_TRAIN_CASES, d = 112), their ratios to SDPA beside those at
     TRAIN_CASES, f32 K1 and K2 there at the f32 gates (dropout 0 and 0.1),
     and ptxas's registers and spills of f32 K1 by head dim and of every
     instantiation of bf16 and f32 K2;
  3. serving: CoAM-W48 crowdpose 384x288 (14 joints, random weights from
     torch.manual_seed), ``predict`` on a 480x640 image with 4 condition poses
     and ``predict_batch`` on 3 images; finite outputs of the right shapes, the
     flash launch count of the run, one forward on the card vs the same module
     on the CPU, ms per image and crops/s; a profile of one predict_batch,
     with K1's f32 wgmma kernel's time and share, the share with the
     mma.sync kernel's time at those shapes beside it, and no SIMT or
     mma.sync forward; the same
     for TransPose-H (coco 384x288, 17 joints, 6 encoder layers of one
     d = 112 head: 6 K1 launches a forward); after each, the same model in
     bf16 (TPU.EVAL_DTYPE bfloat16, ``bf16_serving_phase``) beside the f32
     estimator of the same weights: the bf16 run's K1 launches, predict and
     predict_batch timed in turns with f32 (medians), a profile of each
     dtype (bf16 K1's wgmma kernel by name and launches, no mma.sync, SIMT
     or 3xTF32 forward; the convolutions' share of kernel time), one round's
     bf16 vs f32 keypoints within one heatmap pixel (a report), the decode
     drift of the warp and render on TF32 operands against exact (median
     within WARP_DRIFT_PX), one bf16 forward card vs CPU (every module's
     output dtype equal, the nn.Upsample control apart; BF16_FORWARD_RATIO),
     the TF32 flags unchanged by the calls.  Every estimator serves through
     per-bucket CUDA graphs (serving.py, graphs.py, PR 16): a bucket's first
     call runs two eager warm-ups, the capture and a replay, later calls a
     replay; the kernels' counters count the warm-ups and each replay (the
     launches the capture recorded), not the capture.  After CoAM-W48's
     bf16 serving, ``graph_serving_phase``: CoAM-W48 with
     ``precompile=GRAPH_PRECOMPILE`` in f32 and bf16, replays bit for bit
     equal to eager ``refine``, K1 by name in a profiled replay, eager and
     replayed ms/image in turns with the device's idle share, a call past
     ``max_compiles`` padded up, and a ``torch.export`` program a dtype
     exported, loaded and held to the live estimator (EXPORT_ATOL);
  4. training: ``buctd_tpu_torch.train.run`` on a synthetic CrowdPose-format
     set (seeded, in a temporary directory) at full width, batch 32, bf16
     autocast, attention dropout 0.1, the device loader; ms/step, images/s,
     data-wait per step, the launch counts of K1, K2 and K4 (one per batch)
     in that run; the
     loss over a repeated batch (finite, falling); a profile of one step,
     which must name K1's and K2's wgmma kernels and no mma.sync or SIMT K1
     or K2 kernel, and every bf16 K2 launch counted on the wgmma kernels
     (here and on every bf16 training path below); the same for TransPose-H
     on a synthetic COCO-format set whose people carry ``cond_kpts`` (the
     yaml trains from them, SYNTHESIS_POSE false), K1, K2 dq and K2 dk/dv
     launched 6 times a step; then
     TPU.DEVICE_SYNTHESIS (``synthesis_phase``): plan_sample's host time a
     sample, split into the host sampler and the rest, the card sampler's
     device time a batch of 32, its CUDA kernel launches and its wall time
     with the copy back, its mode rates against the host sampler's within
     SYNTH_RATE_ATOL; CoAM-W48's 10-step run again with the sampler on the
     card (ms/step, data wait, dispatch, resident step, the same launch
     gates); and 3-step CoAM-W48 runs with each of OPTIONS (cutmix, mixup,
     GRAD_ACCUM_STEPS 2, REMAT, FUSED_OPTIMIZER; ``options_phase``): finite
     losses, the launch gates, and for REMAT the resident step's ms, peak
     memory and K1/K2 launches with and without remat;
  5. one f32 (TF32 off), dropout-0 train step at batch 1 on the card vs the
     same step on the CPU: loss, the gradients (all, and the position
     attention's alone), BN running statistics; the step's K2 calls (3xTF32)
     vs float64 on their own inputs; f32 K2's launches in that step, every
     one on its wgmma pair (flash_bwd_tf32_wgmma.cuh);
  6. kernels, kv-resident: K1' (flash_fwd_kvres) vs the plain version at the
     serving shapes, the eval shapes (64 = 2 x 32 flip-test crops) in f32 and
     bf16, a ragged case and d = 47, and vs K1; at the training shapes (BH
     32), f32 and bf16, dropout 0.1: K1' and K2' (dq, dk/dv) vs the plain
     versions (over BH chunks, each with its rows' dropout mask; K1's and
     K2's gates) and vs K1/K2 (bit for bit in both dtypes: the same
     tensor-core kernels with a deeper ring); an odd head dim in bf16 under
     BUCTD_FLASH_KVRES=1; times of each beside K1's/K2's (A/B in turns: old,
     new, new, old), the plain version's, the bound and SDPA's; f32 K2'
     beside f32 K2 in turns at the training shapes; K2' counted on its
     dtype's wgmma kernels;
  7. evaluation: ``buctd_tpu_torch.valid.run`` on a seeded synthetic
     CrowdPose test set (64 480x640 images x 4 people = 256 crops = 8 batches
     of 32) from a BU-prediction json, with N(0, 1/fan_in) weights saved as a
     .pth, full width, flip test, 3 refinement rounds: a results json with
     one entry per crop and a finite AP in [0, 1] each round, K1 launched 2
     and K4 1 per batch per round, crops/s per round; a profile of one
     validate step, with K1's f32 wgmma kernel's time and share (and the
     share with the mma.sync kernel) and no SIMT or mma.sync forward, and the
     convolutions' share;
  8. the same evaluation, one round, under BUCTD_FLASH_KVRES=1: K1' launched 2
     per batch and K1 never; one batch's heatmaps from K1 and K1' agree; one
     validate step at batch 2 on the card vs the CPU; one bf16 round
     (TPU.EVAL_DTYPE bfloat16: K1 2, K4 1 a batch, AP in [0, 1], crops/s) and
     one under BUCTD_FLASH_KVRES=1 whose results json equals K1's; one
     batch's bf16 heatmaps against f32's, printed, K1' bit for bit K1 in
     bf16, and a profile of the bf16 step (K1's tensor-core kernel, the
     convolutions' share); then one TransPose-H
     evaluation round (``transpose_eval_phase``: 64 synthetic COCO crops
     from a BU json, the yaml's batch 32 without the flip test, AP in
     [0, 1], K1 launched 6 times a batch) and a profile of its validate
     step, then the same round and profile in bf16;
  9. 3 training steps under BUCTD_FLASH_KVRES=1: K1', K2' dq and K2' dk/dv
     launched 2 per step, K1 and K2 never, the loss finite;
 10. K5 (the fused eval basic block) vs its plain version at the four W48
     branch geometries, batch 32, f32 and bf16 (the tensor-core kernels, f32
     in 3xTF32, and the SIMT kernel of the A/B in both), where f32's
     one-pass tf32 control must miss the f32 gate at every branch, and on the
     benchmark's own batch-128 bf16 inputs; the long-K check at C = 384
     against float64 in both dtypes (K5_LONG_K); the plain version's time;
 11. K5 vs the port's trunk: one stage-4 BasicBlock per branch of a
     full-width preNet-W48 with random BN statistics, folded by
     models/fuse.py::fold_bn, f32 with TF32 off;
 12. K6 (exp/exp2 throughput) vs its plain version, all three variants: the
     full chain, and 1, 2 and 3 steps on inputs over [-100, 100];
 13. preNet-W48 serving (crowdpose 384x288, 14 joints, f32, 3 rounds) through
     PoseEstimator from one .pth of random weights, with TPU.FUSED_PRENET off
     and auto: fused vs unfused predictions, each forward on the card vs the
     CPU, crops/s, a profile of each; then each knob in bf16
     (``bf16_serving_phase``, the card-vs-CPU forward with the knob off);
 14. the port's tools, reduced (buctd_tpu_torch/tools/bench_block.py --simt
     in bf16 and f32, bench_flash_bwd.py --dtype float32, bench_exp2.py,
     bench_stem.py): K5's (both dtypes), K5's SIMT A/B's and K6's launch
     counts in that run, and the times of K5 (tensor cores and SIMT, both
     dtypes), cuDNN (bf16, f32 with TF32 off), f32 K2 (its wgmma pair, PR
     9's mma.sync pair and the SIMT kernels in turns, SDPA's f32 backward, at
     the training shapes and TransPose-H's d = 112), K6 (device time) and the
     torch chains that the kernels line reports; K5 faster than its SIMT
     kernel at every branch in both dtypes, f32 K2 faster than its SIMT
     kernels; K6 no faster than its SFU bound.

 15. (phases 15-18 run after phase 9) pose_resnet-50 with the preNet
     (``resnet_phase``: the preNet-W48 yaml with
     MODEL.NAME pose_resnet, CrowdPose 384x288, 14 joints, one .pth of random
     weights): predict_batch in f32 and bf16 in turns, FUSED_PRENET off and
     auto, each f32 forward card vs CPU (FORWARD_RTOL), fused vs unfused
     within PRENET_PX_TOL px, a profile; one evaluation round of 64 crops and
     3 training steps; K1 launched 0 times, K4 once a batch;
 16. TEST.LAMBDA_SWEEP (``lambda_phase``): rounds of CoAM-W48 on
     eval_phase's set and weights in f32 and bf16, a plain round and a swept one:
     the sweep's K1 launched 4 and K4 once a batch (lambda 0 and 1), the _l0,
     _l1 and _merged jsons, merged AP in [0, 1], crops/s beside the plain
     round's; validate_lambda over 6 lambdas on 2 batches of preNet-W48 with
     the lambda head;
 17. ``datasets_phase``: one round of 32 crops through valid.run with
     CoAM-W48 on synthetic OCHuman (COCO-17, the coco yaml), fish (7 joints),
     multimouse (12) and marmosets (15): AP in [0, 1], K1 2 and K4 1 a batch;
 18. ``inference_phase``: buctd_tpu_torch.tools.inference's run_ctd_inference
     on one 480x640 image with 4 poses, refine_iters 1 and 3, CoAM-W48 in
     the yaml's TPU.COMPUTE_DTYPE (bf16) and in f32, K1 2 a round, the card
     against the CPU's f32 run (the share within one heatmap pixel,
     INFERENCE_PX_SHARE in f32), ms/image; cpu_nms and gpu_nms on 2000
     boxes against ops/nms.py::nms; analysis.bin_evaluate on eval_phase's
     round-0 results.
 19. ``host_loader_phase`` (after phase 18): the JAX default data
     path, TPU.DEVICE_PIPELINE False with no override, on CoAM-W48 (batch
     32): train.run 4 steps on the host cv2 ``Loader`` with the host
     sampler, then 10 with TPU.DEVICE_SYNTHESIS on it and on the device loader
     (ms/step, data wait, dispatch; K1 and K2 2 a step, K4 never on the host
     Loader); a 3-step run with PRINT_FREQ 1, BUCTD_PROFILE_DIR and
     DEBUG.DEBUG (one train_loss line a step in metrics.jsonl, a Chrome
     trace, epoch 0's debug images, the summary's parameters and GFLOPs a
     crop); one eval round of 256 crops through valid.run on each loader
     (crops/s, AP; f32 K1 2 a batch); one eval batch's input from both
     loaders against each other on noise images and on smooth ones
     (tests/test_device_pipeline.py's eval limits), the host crops against
     numpy's bilinear at the installed OpenCV's sampling (exact, or 1/32
     px), and the host Loader's batch on the card against the CPU's;
     TPU.WARP_ENGINE matmul at K4's draw against K4's
     plain version (WARP_MATMUL_ATOL), timed beside K4, its peak memory.
     Every entry point logs the model summary, whose forward launches K1
     (2 for CoAM-W48, 6 for TransPose-H): each launch gate counts them.
 20. ``multicard_phase`` (last): the multi-card paths on the one card,
     CoAM-W48 at full width: (a) the DDP step at NCCL world size 1 in the
     yaml's bf16 bit for bit equal to the step without DDP; (b) two
     processes of this script (``--multicard-child``) on the one card over
     gloo, the f32 DDP step with global-batch BatchNorm on a global batch of
     32, against one process on the 32 rows (losses at JAX's tolerance),
     ms/step of both, and a profile of the one process's step (f32 K2's
     wgmma pair by name and its share of the kernel time, no mma.sync K2);
     (c) PoseEstimator(mesh=) with two replicas on cuda:0 against the
     one-device estimator; K1/K2 counted in each, by kernel.
 21. ``orbax_phase`` (after phase 20): the orbax reader over the system's
     libzstd on the committed fixtures (JAX's save_params): CoAM-W48 at
     full width (tests/fixtures/orbax_coam_w48) read and timed, every leaf
     against expected.json, libzstd's MB/s; PoseEstimator(checkpoint=<dir>)
     in f32 and bf16 at the main path's shapes bit for bit the estimator
     from a .pth of the same state_dict, K1 counted exactly; a narrow CoAM
     (tests/fixtures/orbax_coam_tiny) against expected.json, valid.run and
     train.run with TEST.MODEL_FILE <dir>; K1, K2 and K4 counted.
 22. ``parity_phase`` (after phase 21): the AP-parity runner
     (buctd_tpu_torch/tools/parity_eval.py) through its ``main``: CoAM-W48
     at full width from the orbax fixture of phase 21, f32, 3 refinement
     rounds of 32 synthetic CrowdPose crops (one batch a round) through the
     host cv2 Loader: exit code 1 and FAIL against the README's 78.5 at
     random weights, the table row, the last JSON line (its ap the
     trajectory's last, 3 finite APs in [0, 100], pass as delta says), 32
     results a round and round 1's centers moved; K1 launched 2 a round plus
     the summary forward's, K1' and K4 never; the orbax read's seconds and
     each round's crops/s.

On every main path, each f32 K1 and K1' launch must have run the f32 wgmma
kernel (``f32_k1_wgmma``: the launches less the bf16 kernels' equal the
wgmma kernel's, the mma.sync kernel's are 0), recorded by path in
F32_WGMMA_PATHS for the kernels line.

Prints the kernels' JSON line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result, where CUDA is absent.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import os
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
PEAK_OPS = {"float32": 67e12,      # f32 outside the tensor cores (the SIMT kernels)
            "tf32": 494.7e12,      # dense TF32 tensor cores: the f32 kernels, 3 passes
            "bfloat16": 989e12}    # dense bf16 tensor cores
# kernel vs plain: both sum in f32, in another order, over up to 6912 keys
# (measured ~1e-6 on randn inputs).  f32 K1 and K1' take their products in
# 3xTF32, as close to f32 as the SIMT kernel (the card test
# test_f32_forward_long_rows_as_accurate_as_simt); one tf32 pass lands further
# than the gate, which must refuse it (TF32_CONTROL_PASSES).  The lse of bf16
# K1 takes this gate too: its sum l is never rounded
KERNEL_ATOL = KERNEL_RTOL = 2e-5
# bf16 K1 (the wgmma kernel, or the mma.sync kernel where the dispatch picks
# it) vs the plain forward that rounds q' and p * keep * c where it does: out
# within K1_BF16_RTOL x max |out|, for f32 sums in another order and
# one-bf16-step flips of a rounded p * keep * c where exp2 and exp, or the
# kernel's running row max over its key tiles and the plain version's final
# one, differ.  The last dominates: every p of a tile seen before the row's
# final max is rounded independently of the plain version's, a relative 2^-9
# each, so the error is about 1.6e-3 of the rms of out at any L, and its max
# about that of max |out| (measured by this script on an H100 with the wgmma
# kernel, two runs: 7.09e-4 to 2.00e-3 at the serving, eval and training
# shapes, dropout 0 and 0.1; 1.02e-3 to 2.12e-3 with the mma.sync kernel
# before).
# That leaves the rounding itself ungated: a kernel that skipped it would land
# as far from the dense plain version.  The tile is that of the kernel the
# dispatch picks (ops/flash_attention.py::fwd_key_tile): the wgmma kernel's
# 128 keys up to d = 64 and 96 above, the mma.sync kernel's 64 and 32
K1_BF16_RTOL = 4e-3
# so bf16 K1 and K1' are also held to forward_tile_rounded, which rounds p at the
# kernel's running tile max: the rms of out - that, relative to its rms, within
# K1_BF16_TILED_RMS (f32 sums in another order, and one-step flips where exp2
# rounds differently).  Its control, the same with p unrounded, must miss by
# more at every check, so the gate tells the rounding from its absence
# (measured by this script on an H100 at every bf16 K1/K1' check with the
# wgmma kernel, two runs: the kernels 2.59e-5 to 4.28e-5, the control
# 1.369e-3 to 1.657e-3; with the mma.sync kernel before, two runs: 1.64e-5
# to 4.05e-5 and 1.338e-3 to 1.668e-3)
K1_BF16_TILED_RMS = 2e-4
# rows of exp(s' - lse), s' = q' k^T the logits K2 recomputes and lse from bf16
# K1 or K1', sum to 1 within ROWSUM_ATOL: s' summed in f32 in another order on
# both sides (the forward that rounded nothing missed by 1.7e-3 to 4.6e-3 on
# the CPU)
ROWSUM_ATOL = 1e-4
# card vs CPU forward, f32 with TF32 off on the card: convolution algorithms
# and attention sums differ in order; relative to the heatmaps' peak
FORWARD_RTOL = 1e-4
# TransPose-H's first encoder layer takes the trunk's tokens unnormalised
# (post-norm), and under random_init's BN statistics they reach |x| ~ 650, so
# its attention logits reach ~1e4: f32 itself is then far from exact (on the
# CPU, layer 0's attention output lies 6.3e-4 and the heatmaps 6.6e-5 of
# their max from float64), and two f32 forwards that sum in another order
# differ by up to ~1e-3 of the peak (measured 8.6e-4 card vs CPU on an H100).
# So its card forward is held against the CPU's float64 forward: no further
# than FORWARD_F64_RATIO x the CPU's own f32 forward
FORWARD_F64_RATIO = 2.0
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
REPEATS = 4
# K1's (BH, Lq, Lk, d) on the main path: the CoAM position attention of branch
# 0 and branch 1, BH = the 16 crops of the serving phase's predict_batch
MAIN_CASES = [(16, 6912, 6912, 48), (16, 1728, 1728, 96)]
# and a ragged case, and d = 47: f32 rows of 188 bytes, which K1's kernels
# load through registers
OTHER_CASES = [(8, 6912, 6912, 48), (8, 1728, 1728, 96), (3, 700, 300, 112),
               (8, 1728, 1728, 47)]
# the training path: batch 32, one head, bf16 operands under autocast
TRAIN_BATCH = 32
TRAIN_CASES = [(TRAIN_BATCH, 6912, 48), (TRAIN_BATCH, 1728, 96)]
# the plain versions hold (BH, L, L) f32 tensors: they are checked and timed
# in BH chunks of this size
PLAIN_BH = {6912: 2, 1728: 8}
DROPOUT = 0.1
# K2 vs its plain backward.  f32 (3xTF32 on the tensor cores): dq/dk/dv sum
# p-weighted products over up to 6912 keys or rows in f32, in another order
# (the SIMT kernels measured below 1e-6 on randn inputs); one tf32 pass
# (ops/flash_attention.py::backward_tf32, TF32_CONTROL_PASSES) lands further
# and must miss.  bf16 (the tensor-core kernels) against the
# plain backward that rounds q * scale, do, ds and p * keep * c where they do:
# within K2_BF16_RTOL x max |grad|, for f32 sums in another order and
# one-bf16-step flips of a rounded ds or p * keep * c where exp2 and exp
# differ in the last bit (measured 3.2e-4 to 1.42e-3 of the max on an H100 at
# the training shapes)
BWD_ATOL = BWD_RTOL = 1e-4
K2_BF16_RTOL = 2e-3
# K1' vs K1 and K2' vs K2, f32 and bf16: the same tensor-core kernels with a
# deeper ring, which changes no arithmetic: bit for bit (max |gap|
# KVRES_GAP)
KVRES_GAP = 0.0
# what else bounds a backward kernel, besides its products and bytes:
# one MUFU.EX2 per (row, key) pair, 16 a clock on each SM, and with dropout
# the hash of csrc/dropout_hash.cuh, about HASH_INT_OPS integer operations a
# pair at 64 a clock on each SM; at nvidia-smi's clocks.max.sm
SMS, EX2_PER_SM_CLOCK, INT_PER_SM_CLOCK, HASH_INT_OPS = 132, 16, 64, 10
# K4 vs its plain version on 0..255 images: two tent taps against the dense
# tent sum, both f32; a few ulps of 255.  The fused kernel vs the two-pass
# form, and the uint8 source with its mask vs the f32 masked images: bit for
# bit (the same tent arithmetic on the same values)
WARP_ATOL = 2e-3
WARP_BATCH = (TRAIN_BATCH, 512, 640)   # 480x640 images in their 512x640 bucket
# K4 vs F.grid_sample (align_corners=False, zeros) at rotation 0, where both
# are the same bilinear warp: grid_sample takes the source coordinate through
# the normalised grid, ((g + 1) W - 1) / 2 with g in [-1, 1] in f32, so each
# coordinate carries a few ulps of 2^10 (~1e-4 px) that the kernel's a x + e
# does not; on 0..255 noise a pixel step is up to 255, so about 0.03 at most
WARP_GRID_ATOL = 3e-2
# the evaluation loader's scales (x, in units of 200 px): the synthetic
# set's boxes (110-160 x 220-330 px) at 288:384 and 1.25 padding
WARP_EVAL_SCALES = (1.0, 1.6)
TRAIN_STEPS = 10                        # one epoch of the synthetic set
SYNTH_IMAGES, SYNTH_PEOPLE = 80, 4      # 320 people = 10 batches of 32
# evaluation: TEST batch 32, flip test -> BH 64 in K1 (branch 0 and 1 shapes)
EVAL_BATCH = 32
EVAL_CASES = [(2 * EVAL_BATCH, 6912, 6912, 48), (2 * EVAL_BATCH, 1728, 1728, 96)]
# the control of the f32 gate: the kernel's arithmetic in one tf32 pass
# (ops/flash_attention.py::forward_tf32, passes=1) must miss
# KERNEL_ATOL/RTOL at EVAL_CASES, where three passes meet it
TF32_CONTROL_PASSES = 1
EVAL_IMAGES = 64                        # x 4 people = 256 crops = 8 batches of 32
EVAL_ROUNDS = 3
KVRES_TRAIN_STEPS = 3
# odd head dim for the bf16 kv-resident check under BUCTD_FLASH_KVRES=1: rows of
# 94 bytes, which the bf16 kernels load through registers
KVRES_ODD_CASE = (8, 1728, 47)
# K1 vs K1' heatmaps of one eval batch: the same sums in another tile order
KVRES_HM_RTOL = 1e-5
PRENET_CONFIG = ROOT / "experiments" / "crowdpose" / "buctd" / "prenet_w48_384x288.yaml"
TRANSPOSE_CONFIG = ROOT / "experiments" / "coco" / "buctd" / "transpose_h_384x288.yaml"
# TransPose-H's self-attention: one head of d = 112 (DIM_MODEL 96 + 16
# condition channels) over the 96 x 72 = 6912 tokens, once per encoder layer.
# f32 K1 at the serving phase's predict_batch (16 crops) and at an evaluation
# batch of 32 (the yaml's TEST.FLIP_TEST is false); bf16 K1 and K2 with
# dropout at a training batch of 32
TP_LAYERS = 6
TP_F32_CASES = {"tp_serving": (16, 6912, 6912, 112), "tp_eval": (32, 6912, 6912, 112)}
TP_TRAIN_CASES = [(TRAIN_BATCH, 6912, 112)]
TP_EVAL_IMAGES = 16                     # x 4 people = 64 crops = 2 batches of 32
# the synthetic sets' joint layouts: CrowdPose's 14, COCO's 17
SYNTH_JOINTS = {"crowdpose": 14, "coco": 17, "ochuman": 17, "fish": 7, "multimouse": 12,
                "marmosets": 15}
# pose_resnet-50 with the preNet: the preNet-W48 yaml with the ResNet named
RESNET_OPTS = ["MODEL.NAME", "pose_resnet", "MODEL.EXTRA.NUM_LAYERS", "50",
               "MODEL.EXTRA.USE_PRE_NET", "True"]
RESNET_EVAL_IMAGES = 16                 # x 4 people = 64 crops = 2 batches of 32
RESNET_TRAIN_STEPS = 3
COCO_CONFIG = ROOT / "experiments" / "coco" / "buctd" / "coam_w48_384x288.yaml"
# the datasets of this round's eval phase, each with CoAM-W48 of its layout
DATASETS = {"ochuman": COCO_CONFIG, "fish": CONFIG, "multimouse": CONFIG,
            "marmosets": CONFIG}
DATASET_IMAGES = 8                      # x 4 people = 32 crops = 1 batch of 32
# inference on the card vs the CPU in f32: the share of joints within one
# heatmap pixel (random weights; the f32 forwards differ by ~1e-5 relative)
INFERENCE_PX_SHARE = 0.9
# K5 vs its plain version at the W48 branch geometries, batch 32: f32 sums of
# 9C products in another order (the SIMT kernel measured <= 4.3e-6 on O(1)
# outputs; f32 K5 takes its products in 3xTF32, and one tf32 pass,
# ops/fused_block.py::fused_block_tf32 with TF32_CONTROL_PASSES, must miss
# the f32 gate); in bf16 an f32 sum in another order can round the
# intermediate or the output one bf16 step (2^-7 relative) apart, so two
# steps, relative and absolute
K5_CHECK_BATCH = 32
K5_ATOL = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
# K5's long-K check: C = 384 (K = 3456 terms a conv) at (batch, H, W, C),
# the tensor-core kernel's and the SIMT kernel's outputs against a float64
# chain on the same operands (the intermediate rounded where the kernels
# round it): the tensor-core kernel's max and rms error, and in bf16 its
# share of outputs off the float64 chain rounded to bf16, at most
# K5_LONG_K_RATIO x the SIMT kernel's (the tensor cores' accumulator is not
# an f32 add), in both dtypes
K5_LONG_K = (32, 12, 9, 384)
K5_LONG_K_RATIO = 2.0
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
# TPU.DEVICE_SYNTHESIS: the card sampler's mode rates (good, jitter, far,
# zero by distance from GT) against the host sampler's on the same records,
# within the JAX package's device-vs-host tolerance
# (tests/test_pose_synthesis.py); SYNTH_HOST_REPS passes of the host sampler
# and SYNTH_CARD_REPS batches of the card's over TRAIN_BATCH records
SYNTH_RATE_ATOL = 0.05
SYNTH_HOST_REPS, SYNTH_CARD_REPS = 4, 16
# bf16 serving and evaluation (TPU.EVAL_DTYPE bfloat16), beside the f32
# estimator of the same weights: predict and predict_batch, one call a turn
# (f32, bf16, bf16, f32), BF16_REPEATS turns; the medians of each dtype's
# calls and their range are printed.  The decode's drift from the warp and
# render on TF32 operands (the bf16 path's default on the card) against them
# exact, over the joints of one round: the median within WARP_DRIFT_PX, the
# drift JAX measured (tools/bench_precision.py: 0.00 px); its p99 and max are
# printed (an argmax at a near-tie moves a joint by whole pixels).  One bf16
# forward on the card against the CPU's bf16 forward on the same input:
# every module's output dtype the same on both (CUDA autocast rounds where
# CPU autocast, and so JAX, rounds), with a control that must miss: the fuse
# layers' nn.Upsample put back (F7, which CUDA autocast runs in f32); and the
# heatmaps within BF16_FORWARD_RATIO x the distance of the CPU's bf16 forward
# from its f32 one (bf16's own noise on that input; convolution algorithms
# sum in another order, and the attention amplifies what reaches it), both
# printed in bf16 steps of the peak, and the control's distance beside them.
# The CPU's bf16 forward takes the flash path's plain version where
# the card takes K1 (``card_attention_rule``): K1 rounds p to bf16 as JAX's
# kernel does, the batched-matmul path does not.  Measured by this script on
# an H100: CoAM-W48 6.03-6.66 steps against the CPU's 5.01-5.30 (1.14-1.33x).
# TransPose-H 34.58-35.49 steps against 10.26-10.50 (3.3-3.5x): its first
# encoder layer takes the trunk's unnormalised tokens (|x| ~ 960 under random
# BN statistics), whose attention logits of ~1e4 are near an argmax, so the
# trunk's few-step differences at the tokens move that layer's attention
# output by many more (both printed); hence its own ratio.  BUCTD_FLASH_KVRES=1's bf16 eval heatmaps equal K1's
# bit for bit.
BF16_REPEATS = 2
WARP_DRIFT_PX = 0.05
# host_loader_phase: steps of the checks run (metrics, trace, debug dumps);
# the matmul engine vs K4's plain version, tests/test_torch_port_warp_matmul.py's
# 1e-4 on [0, 1) images on 0..255 ones; the host Loader's RGB input card vs
# CPU: the same uint8 crops, (x / 255 - mean) / std in f32 on each device
HOST_CHECK_STEPS = 2
# host_loader_phase's first trainer run: the host sampler takes ~3 s a step
# at batch 32, so 4 steps (the median of steps 3-4); the turns with
# TPU.DEVICE_SYNTHESIS keep TRAIN_STEPS, one epoch, after which the device
# loader prefetches no further batch, so K4 counts one a step
HOST_SAMPLER_STEPS = 4
# eval samples whose host crops are held to numpy's bilinear sampling
HOST_CROP_CHECKS = 8
WARP_MATMUL_ATOL = 1e-4 * 255
HOST_CARD_RGB_ATOL = 1e-5
BF16_FORWARD_RATIO = {"pose_hrnet_coam": 2.0, "pose_hrnet": 2.0, "transpose_h": 7.0}
BF16_STEP = 2.0 ** -8
# graph_serving_phase: CoAM-W48 served through per-bucket CUDA graphs
# (serving.py, graphs.py).  ``precompile`` admits these two buckets at
# start-up, within a budget of two; a replay must equal ``est.refine`` run
# eagerly on the same padded inputs bit for bit (the same kernels on the
# same inputs), in f32 and bf16.  The exported programs run
# GRAPH_EXPORT_ROUNDS rounds (a trace's length grows with the rounds); they
# are held to the live estimator of the same rounds within EXPORT_ATOL
# (pixels and confidences): the same ATen ops and the same K1, so bit for
# bit is expected, and the limit only leaves room for an ATen op that
# torch.export decomposes into another kernel.
GRAPH_PRECOMPILE = [(480, 640, 4), (3, 480, 640, 4)]
GRAPH_KEYS = {(512, 640, 4), (4, 512, 640, 4)}
GRAPH_TURNS = 2
# one program a dtype, each at a bucket the live estimator admits: a trace and
# a load take tens of seconds at full width
GRAPH_EXPORT = {"float32": (480, 640, 4), "bfloat16": (4, 480, 640, 4)}
GRAPH_EXPORT_ROUNDS = 1
EXPORT_ATOL = 1e-3
# kernel names that are convolutions or the layout transposes around them
CONV_NAMES = ("conv", "fprop", "fft", "flip_filter", "cf32", "inograd", "nchwToNhwc",
              "nhwcToNchw")
# the trainer's step options, OPTION_STEPS steps of CoAM-W48 each, beside a
# run with none of them (the same length, the same set); REMAT's resident
# step with and without remat in REMAT_ROUNDS turns (off, on, on, off)
# multicard_phase: (a) DDP at NCCL world size 1 in the yaml's bf16,
# MC_NCCL_BATCH rows, 2 steps, bit for bit the steps without DDP; (b) two
# processes on the one card over gloo, MC_GLOBAL_BATCH rows (half a process)
# in f32 with the attention dropout at 0, SGD (JAX's own 2-process test:
# Adam's first step is lr * sign(g), which the order of the sums flips on
# near-zero gradients) at MC_LR, 2 steps against one process on the same
# rows at JAX's tolerance, then MC_TIMED_STEPS timed steps each; (c) mesh=
# serving, two replicas on cuda:0, predict_batch of MC_SERVE_IMAGES against
# the one-device estimator within EXPORT_ATOL.  MC_LR: at 0.01 the first
# step takes the random-weight loss from 14.8 to 7.7, and the f32 rounding
# of that step (cuDNN's algorithms differ by batch size and run) moved the
# one process's own second loss 5.2e-4 between two runs on an H100 80GB
# HBM3 at 700 W, against a gate of 7.8e-4 there; at 1e-3 the step, and that
# rounding with it, is ten times smaller, while a wrong gradient reduction
# still moves the second loss by a share of the step's whole change
MC_LR = "0.001"
MC_NCCL_BATCH = 8
MC_GLOBAL_BATCH = 32
MC_TIMED_STEPS = 2
MC_LOSS_ATOL, MC_LOSS_RTOL = 1e-5, 1e-4
MC_SERVE_IMAGES = 4
OPTION_STEPS = 3
REMAT_ROUNDS = 4
OPTIONS = {"plain": [], "cutmix": ["TRAIN.MIX", "cutmix"], "mixup": ["TRAIN.MIX", "mixup"],
           "grad_accum_2": ["TRAIN.GRAD_ACCUM_STEPS", "2"],
           "remat": ["TPU.REMAT", "True"], "fused_optimizer": ["TPU.FUSED_OPTIMIZER", "True"]}


# the flash libraries and their SIMT (f32, CUDA-core) kernels: every other
# kernel in them runs on the tensor cores, the bf16 ones (``_tc_kernel``) and
# the 3xTF32 f32 ones (``_tf32_kernel``).  flash_fwd and flash_bwd keep their
# SIMT kernels for the A/B only; K1' and K2' have none
FLASH_SIMT = {"flash_fwd": ("flash_fwd_kernel",),
              "flash_bwd": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
              "flash_fwd_kvres": (),
              "flash_bwd_kvres": ()}
# bf16 K1's and K1''s kernel on every model path (d = 48, 96, 112; the dispatch
# of ops/flash_attention.py::takes_wgmma): TMA loads and wgmma, one
# instantiation a head-dim case and dropout or not in each of the two
# libraries; the mma.sync ``flash_fwd_tc_kernel`` takes the other bf16 calls
BF16_K1_KERNEL = "flash_fwd_wgmma_kernel"
# and bf16 K2's and K2''s pair (the dispatch of takes_wgmma_bwd), the mma.sync
# flash_bwd_{dq,dkv}_tc_kernel taking the other bf16 calls
BF16_K2_KERNELS = ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel")
# each library's wgmma kernels and their instantiations (a head-dim case and
# dropout or not, for each kernel)
WGMMA_LIBS = {"flash_fwd": ((BF16_K1_KERNEL,), 16), "flash_fwd_kvres": ((BF16_K1_KERNEL,), 16),
              "flash_bwd": (BF16_K2_KERNELS, 32), "flash_bwd_kvres": (BF16_K2_KERNELS, 32)}
# f32 K1's and K1''s kernel on every model path (d = 48, 96, 112; the dispatch
# of ops/flash_attention.py::takes_wgmma_f32): TMA loads and wgmma in 3xTF32,
# one instantiation a head-dim case and dropout or not in each of the two
# libraries; the mma.sync ``flash_fwd_tf32_kernel`` takes the other f32 calls
F32_K1_KERNEL = "flash_fwd_tf32_wgmma_kernel"
F32_WGMMA_LIBS = {"flash_fwd": 16, "flash_fwd_kvres": 16}
# f32 K2's and K2''s wgmma pair: dq and dk/dv at 8 head dims, with dropout
# and without
F32_K2_KERNELS = ("flash_bwd_dq_tf32_wgmma_kernel", "flash_bwd_dkv_tf32_wgmma_kernel")
F32_K2_LIBS = {"flash_bwd": 32, "flash_bwd_kvres": 32}
# their names, and the f32 mma.sync pair's, in ptxas's log
F32_K2_KINDS = ("_tf32_wgmma_kernel", "_tf32_kernel")
# the K1 and K1' launch counters: all launches, and by kernel (bf16: the wgmma
# and mma.sync kernels; f32: likewise)
K1_COUNTS = ("launches", "wgmma_launches", "mma_launches", "f32_wgmma_launches",
             "f32_mma_launches")
# f32 K1's and K1''s launches on each main path of this run, all and on the
# f32 wgmma kernel, by label (``f32_k1_wgmma``): the kernels line's entry of
# that kernel
F32_WGMMA_PATHS: dict = {}
# the mma.sync kernel's time over the f32 wgmma kernel's at each f32 group of
# the kernel phase (in turns), by group ("main", "eval", "tp_serving",
# "tp_eval"): what K1's profiled share would be with the kernel it replaced
K1_MMA_RATIO: dict = {}
# K5's library: the tensor-core kernels (``fused_block_tc_kernel`` bf16,
# ``fused_block_tf32_kernel`` f32, one instantiation a tile plan) and the
# SIMT kernels (f32 and bf16, for the A/B)
K5_SIMT = {"fused_block": ("fused_block_kernel",)}


def tf32_kernels_expected(lib: str) -> int:
    """How many f32 (``_tf32_kernel``) instantiations a library holds: one a
    head-dim case of the forward (8), of dq and of dk/dv (16), one a tile
    plan of K5."""
    from buctd_tpu_torch.ops.fused_block import TF32_PLANS

    return {"fused_block": len(TF32_PLANS)}.get(lib, 16 if "bwd" in lib else 8)


def sass_counts() -> dict:
    """(library, "" or "TF32") -> HMMA counts by kernel, of every flash
    library and of K5's, (library, "HGMMA" or "UTMALDG") -> wgmma and TMA
    load counts of the libraries of K1, K1', K2 and K2', and (library,
    "HGMMA_TF32") -> tf32 wgmma counts of K1's, K1''s, K2's and K2''s: one disassembly a
    library (cuobjdump, ~7 s each), all at once, on the host while the NaN phase
    uses the card (main waits for them before the timed kernel phases)."""
    from concurrent.futures import ThreadPoolExecutor

    from buctd_tpu_torch._build import op_counts, sass

    libs = list({**FLASH_SIMT, **K5_SIMT})
    with ThreadPoolExecutor(len(libs)) as pool:
        texts = dict(zip(libs, pool.map(sass, libs)))
    found = {}
    for lib, text in texts.items():
        found[(lib, "")] = op_counts(text, "HMMA")
        found[(lib, "TF32")] = op_counts(text, "HMMA", "TF32")
        if lib in WGMMA_LIBS:
            for op in ("HGMMA", "UTMALDG"):
                found[(lib, op)] = op_counts(text, op)
        if lib in F32_WGMMA_LIBS or lib in F32_K2_LIBS:
            found[(lib, "HGMMA_TF32")] = op_counts(text, "HGMMA", "TF32")
    return found


def check_sass(counts: dict) -> None:
    """In every flash library and in K5's (``counts`` from sass_counts), HMMA
    in each tensor-core kernel and in none of the SIMT ones; TF32 HMMA in
    every f32 kernel (one a head-dim case of K1, K1', K2 and K2', one a tile
    plan of K5); one bf16 K5 kernel a tile plan; HGMMA and UTMALDG in every
    instantiation of bf16 K1's and K1''s wgmma kernel and of bf16 K2's and
    K2''s wgmma pair; TF32 HGMMA and UTMALDG, and no HMMA, in every
    instantiation of f32 K1's and K1''s wgmma kernel (F32_K1_KERNEL) and of
    f32 K2's and K2''s wgmma pair (F32_K2_KERNELS)."""
    from buctd_tpu_torch.ops.fused_block import TC_PLANS

    libs = {**FLASH_SIMT, **K5_SIMT}
    for lib, simt_names in libs.items():
        hmma = counts[(lib, "")]
        tc = {f: n for f, n in hmma.items()
              if "_tc_kernel" in f or "_tf32_kernel" in f}
        simt = {f: n for f, n in hmma.items() if any(k in f for k in simt_names)
                and f not in tc}
        tf32 = {f: n for f, n in counts[(lib, "TF32")].items() if "_tf32_kernel" in f}
        print(f"{lib} SASS: {len(tc)} tensor-core kernels, HMMA {min(tc.values(), default=0)}-"
              f"{max(tc.values(), default=0)} each; {len(tf32)} f32 kernels, TF32 "
              f"HMMA {min(tf32.values(), default=0)}-{max(tf32.values(), default=0)} each; "
              f"{len(simt)} SIMT kernels, HMMA {sum(simt.values())} in all", flush=True)
        if (not tc or min(tc.values()) == 0 or bool(simt) != bool(simt_names)
                or sum(simt.values())):
            raise AssertionError(f"{lib}'s SASS: tensor-core kernels {tc}, SIMT kernels {simt}")
        if len(tf32) != tf32_kernels_expected(lib) or min(tf32.values()) == 0:
            raise AssertionError(f"{lib}'s SASS: TF32 HMMA of the f32 kernels {tf32}")
        if lib in K5_SIMT and len(tc) != len(TC_PLANS) + len(tf32):
            raise AssertionError(f"{lib}'s SASS: {len(tc)} tensor-core kernels, not "
                                 f"{len(TC_PLANS)} + {len(tf32)}")
    # the wgmma kernels of bf16 K1, K1', K2 and K2': HGMMA and TMA loads
    # (UTMALDG) in every instantiation
    for lib, (names, n) in WGMMA_LIBS.items():
        got = {op: {f: c for f, c in counts[(lib, op)].items() if any(k in f for k in names)}
               for op in ("HGMMA", "UTMALDG")}
        print(f"{lib} SASS: {len(got['HGMMA'])} {' and '.join(names)} instantiations, HGMMA "
              f"{min(got['HGMMA'].values(), default=0)}-{max(got['HGMMA'].values(), default=0)} "
              f"and UTMALDG {min(got['UTMALDG'].values(), default=0)}-"
              f"{max(got['UTMALDG'].values(), default=0)} each", flush=True)
        if any(len(g) != n or min(g.values()) == 0 for g in got.values()):
            raise AssertionError(f"{lib}'s SASS: the wgmma kernel's HGMMA and UTMALDG {got}")
    # f32 K1's and K1''s wgmma kernel: TF32 HGMMA and TMA loads in every
    # instantiation, no HMMA (mma.sync) in any
    for lib, n in F32_WGMMA_LIBS.items():
        got = {op: {f: c for f, c in counts[(lib, op)].items() if F32_K1_KERNEL in f}
               for op in ("HGMMA_TF32", "UTMALDG", "")}
        print(f"{lib} SASS: {len(got['HGMMA_TF32'])} {F32_K1_KERNEL} instantiations, TF32 "
              f"HGMMA {min(got['HGMMA_TF32'].values(), default=0)}-"
              f"{max(got['HGMMA_TF32'].values(), default=0)} and UTMALDG "
              f"{min(got['UTMALDG'].values(), default=0)}-"
              f"{max(got['UTMALDG'].values(), default=0)} each, HMMA "
              f"{sum(got[''].values())} in all", flush=True)
        if (any(len(got[op]) != n or min(got[op].values()) == 0
                for op in ("HGMMA_TF32", "UTMALDG")) or sum(got[""].values())):
            raise AssertionError(f"{lib}'s SASS: the f32 wgmma kernel's TF32 HGMMA, UTMALDG "
                                 f"and HMMA {got}")
    # f32 K2's and K2''s wgmma pair: the same, in every instantiation
    for lib, n in F32_K2_LIBS.items():
        got = {op: {f: c for f, c in counts[(lib, op)].items()
                    if any(k in f for k in F32_K2_KERNELS)}
               for op in ("HGMMA_TF32", "UTMALDG", "")}
        print(f"{lib} SASS: {len(got['HGMMA_TF32'])} {' and '.join(F32_K2_KERNELS)} "
              f"instantiations, TF32 HGMMA {min(got['HGMMA_TF32'].values(), default=0)}-"
              f"{max(got['HGMMA_TF32'].values(), default=0)} and UTMALDG "
              f"{min(got['UTMALDG'].values(), default=0)}-"
              f"{max(got['UTMALDG'].values(), default=0)} each, HMMA "
              f"{sum(got[''].values())} in all", flush=True)
        if (any(len(got[op]) != n or min(got[op].values()) == 0
                for op in ("HGMMA_TF32", "UTMALDG")) or sum(got[""].values())):
            raise AssertionError(f"{lib}'s SASS: the f32 wgmma pair's TF32 HGMMA, UTMALDG and "
                                 f"HMMA {got}")


def nan_phase(torch, fa, fb) -> None:
    """A NaN operand reaches every f32 tensor-core kernel's output (the 3xTF32
    split's lo carries it: f32 K1's and K2's wgmma kernels, where the
    dispatch sends these shapes, and their mma.sync kernels, through
    flash_attention_mma, flash_bwd_dq_mma and flash_bwd_dkv_mma) and
    K5's in both dtypes (relu keeps it): the
    entries that are not finite are those of the plain version's output,
    at small shapes, dropout 0 (a dropped entry is 0 by selection in the
    kernels, NaN times 0 in the plain version)."""
    from buctd_tpu_torch.tools import bench_block_variants as bv

    def alike(label, got, want):
        for g, w in zip(got, want):
            bad = ~torch.isfinite(w)
            if not (bad.any() and torch.equal(~torch.isfinite(g), bad)):
                raise AssertionError(f"{label}: {(~torch.isfinite(g)).sum().item()} entries "
                                     f"not finite, the plain version {bad.sum().item()}")

    gen = torch.Generator("cuda").manual_seed(17)
    for bh, l, d in ((2, 128, 48), (1, 100, 96), (1, 100, 112)):
        q, k, v, dout = (torch.randn(bh, l, d, device="cuda", generator=gen) for _ in range(4))
        q[-1, l // 2, d // 3] = float("nan")
        scale = d ** -0.5
        out, lse = fa.flash_attention_reference(q, k, v, scale)
        args = (q, k, v, dout, lse, (dout * out).sum(-1), scale)
        want = fa.flash_attention_backward_reference(*args)
        for tag, fwd, dq, dkv in (
                ("K1/K2", fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv),
                ("K1'/K2'", fa.flash_attention_kvres, fa.flash_bwd_dq_kvres,
                 fa.flash_bwd_dkv_kvres)):
            alike(f"f32 {tag} forward ({bh}, {l}, {d})", fwd(q, k, v, scale), (out, lse))
            alike(f"f32 {tag} backward ({bh}, {l}, {d})", (dq(*args), *dkv(*args)), want)
        # K1's and K2's f32 mma.sync kernels, which the wgmma kernels took
        # over at these d
        alike(f"f32 K1 mma.sync kernel ({bh}, {l}, {d})", fa.flash_attention_mma(q, k, v, scale),
              (out, lse))
        alike(f"f32 K2 mma.sync kernels ({bh}, {l}, {d})",
              (fa.flash_bwd_dq_mma(*args), *fa.flash_bwd_dkv_mma(*args)), want)
    for b, h, w, c in ((2, 24, 18, 48), (2, 12, 9, 384)):
        for dtype in (torch.float32, torch.bfloat16):
            args = bv.random_block(gen, b, h, w, c, dtype=dtype)
            args[0][1, h // 2, 0, c // 2] = float("nan")
            want = fb.fused_basic_block_plain(*args)
            for fn in (fb.fused_basic_block, fb.fused_basic_block_simt):
                alike(f"K5 {fn.__name__} ({b}, {h}, {w}, {c}) {dtype}", [fn(*args)], [want])
    print("NaN operands: f32 K1 and K2 (their wgmma and mma.sync kernels), K1', K2' and K5 "
          "(both dtypes, tensor cores and SIMT) not finite where the plain versions are",
          flush=True)


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


def turns_ms(fns: dict, iters: int) -> dict:
    """Device times of several versions of one function in turns, in order
    and then reversed (a, b, c, c, b, a), each the mean of ``iters`` launches:
    the A/B of more than two inside one call."""
    names = list(fns)
    got = {n: [] for n in names}
    for n in names + names[::-1]:
        got[n].append(timed_ms(fns[n], iters))
    return {n: sum(v) / len(v) for n, v in got.items()}


def wgmma_grid(fa, bh, lq, d, dropout=0.0, f32=False) -> str:
    """The wgmma kernel's grid at (bh, lq, d) (``f32``: the f32 one's):
    blocks, blocks an SM, waves."""
    g = fa.wgmma_waves(bh, lq, d, dropout, f32=f32)
    tiles = f", {g['key_tile']}-key tiles, {g['slots']} slots" if f32 else ""
    return f"{g['blocks']} blocks, {g['blocks_per_sm']} an SM, {g['waves']:.2f} waves{tiles}"


def flash_bound_ms(bh, lq, lk, d, dtype, clock_hz: float | None = None) -> tuple:
    """Least time for softmax(q k^T) v on the card: operations (4 bh lq lk d,
    the CostEstimate of buctd_tpu/ops/flash_attention.py) over the peak rate for
    the inputs' type, or bytes (q, k, v read once, out and lse written once)
    over the memory rate, whichever is larger.  f32 runs on the tensor cores
    in 3xTF32: three passes of the operations at the dense TF32 rate, or, if
    larger, one MUFU.EX2 per (row, key) pair at ``clock_hz`` (16 a clock on
    each SM)."""
    elt = 4 if dtype == "float32" else 2
    ops = 4.0 * bh * lq * lk * d
    nbytes = elt * bh * (lq + 2 * lk) * d + 4 * bh * lq * (d + 1)
    if dtype == "float32":
        if not clock_hz:
            raise ValueError("the f32 bound needs the SM clock for its MUFU floor")
        t_ops = max(3.0 * ops / PEAK_OPS["tf32"],
                    bh * lq * lk / (EX2_PER_SM_CLOCK * SMS * clock_hz))
    else:
        t_ops = ops / PEAK_OPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def f32_core_ms(bh, lq, lk, d) -> float:
    """The same operations on the CUDA cores' f32 FMAs (the SIMT kernels'
    bound), ms."""
    return 4.0 * bh * lq * lk * d / PEAK_OPS["float32"] * 1e3


def kernel_phase(torch, F, fa) -> dict:
    """K1 vs its plain version in f32 and bf16, at MAIN_CASES, EVAL_CASES,
    TransPose-H's TP_F32_CASES (d = 112) and OTHER_CASES, and f32 K2 at
    OTHER_CASES with dropout 0 and 0.1 (``k2_case_check``).  f32 (3xTF32: the
    TMA + wgmma kernel, F32_K1_KERNEL, where the dispatch takes the call,
    the mma.sync kernel at d = 47) with dropout 0 and 0.1 at
    KERNEL_ATOL/RTOL; at EVAL_CASES the one-pass control
    (TF32_CONTROL_PASSES) must miss that gate, and the kernels SDPA launches
    in f32 are named.  Times at MAIN_CASES, EVAL_CASES and TP_F32_CASES: f32
    K1, the mma.sync kernel it replaced (``flash_attention_mma``) and SDPA's
    f32 forward in turns, with the wgmma grid; the plain version beside them.
    Returns the f32 sums over MAIN_CASES (one forward of the serving phase's
    batch), over EVAL_CASES (one validate step's forward) and at each
    TP_F32_CASES shape (one TransPose-H encoder layer), the bf16 sums, the
    worst error and the f32 wgmma kernel's worst; K1_MMA_RATIO takes each
    f32 group's mma.sync / wgmma time."""
    from buctd_tpu_torch.tools.bench_exp2 import sm_clock_hz

    clock = sm_clock_hz()
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, control, k2_worst = 0.0, float("inf"), 0.0
    keys = ("ms", "mma_ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "core_ms")
    f32_wgmma_err = 0.0
    groups = {"main": MAIN_CASES, "eval": EVAL_CASES,
              **{name: [case] for name, case in TP_F32_CASES.items()}}
    sums = {case: {key: 0.0 for key in keys} for case in groups}
    # bf16 at dropout 0: the bf16 serving and evaluation paths' K1 (the wgmma
    # kernel), the mma.sync kernel it replaced and SDPA's bf16 forward in turns
    bf16_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "mma_ms", "err", "rel",
                 "tiled")
    bf16 = {case: {key: 0.0 for key in bf16_keys} for case in groups}
    for bh, lq, lk, d in [c for cases in groups.values() for c in cases] + OTHER_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q = torch.randn(bh, lq, d, device="cuda", generator=gen).to(dtype)
            k = torch.randn(bh, lk, d, device="cuda", generator=gen).to(dtype)
            v = torch.randn(bh, lk, d, device="cuda", generator=gen).to(dtype)
            scale = d ** -0.5
            chunk = PLAIN_BH.get(lq, bh)
            notes = []
            for p in ((0.0, DROPOUT) if dtype == torch.float32 else (0.0,)):
                out, lse = fa.flash_attention(q, k, v, scale, p, 7)
                torch.cuda.synchronize()
                errs, note = check_fwd_chunked(torch, fa, (out, lse), q, k, v, scale, p, 7, chunk)
                errs_note = note
                worst = max(worst, *errs)
                if fa.takes_wgmma_f32(q, k, v):
                    f32_wgmma_err = max(f32_wgmma_err, *errs)
                notes.append(f"dropout {p}: out {errs[0]:.3e} lse {errs[1]:.3e}"
                             f"{note.get('text', '')}")
                if dtype == torch.float32 and (bh, lq, lk, d) in OTHER_CASES:
                    text, err = k2_case_check(torch, fa, gen, q, k, v, out, lse, scale, p, chunk)
                    k2_worst = max(k2_worst, err)
                    notes.append(text)
                del out, lse
            if dtype == torch.float32 and (bh, lq, lk, d) in EVAL_CASES:
                miss = tf32_control_miss(torch, fa, q, k, v, scale, chunk)
                control = min(control, miss)
                notes.append(f"{TF32_CONTROL_PASSES}-pass control exceeds the gate by "
                             f"{miss:.3e} (must be > 0)")
            case = next((g for g, cases in groups.items() if (bh, lq, lk, d) in cases), None)
            q4, k4, v4 = q[:, None], k[:, None], v[:, None]   # (BH, 1 head, L, d)
            mma_ms = None
            if case:
                # the wgmma kernel of the dtype, the mma.sync kernel it
                # replaced and SDPA's forward in turns
                t3 = turns_ms({"wgmma": lambda: fa.flash_attention(q, k, v, scale),
                               "mma": lambda: fa.flash_attention_mma(q, k, v, scale),
                               "sdpa": lambda: F.scaled_dot_product_attention(
                                   q4, k4, v4, scale=scale)}, 10)
                ms, mma_ms = t3["wgmma"], t3["mma"]
                notes.append(f"mma.sync kernel in turns {mma_ms:.4f} ms; wgmma grid "
                             f"{wgmma_grid(fa, bh, lq, d, f32=dtype == torch.float32)}")
            else:
                ms = timed_ms(lambda: fa.flash_attention(q, k, v, scale), 20)
            plain_ms = timed_ms(lambda: chunked(
                lambda a, b, c: fa.flash_attention_reference(a, b, c, scale), bh, chunk,
                q, k, v), 2)
            lib_ms = (t3["sdpa"] if mma_ms is not None else
                      timed_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale),
                               10))
            if dtype == torch.float32 and case == "eval":
                notes.append("SDPA's kernels " + ", ".join(cuda_kernel_names(
                    torch, lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))))
            bound, by = flash_bound_ms(bh, lq, lk, d, name, clock)
            core = f32_core_ms(bh, lq, lk, d)
            print(f"K1 flash_fwd ({bh}, {lq}, {lk}, {d}) {name}: {'; '.join(notes)}; kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}; CUDA-core f32 {core:.4f}), "
                  f"{4.0 * bh * lq * lk * d / ms / 1e9:.2f} TFLOP/s", flush=True)
            if dtype == torch.float32 and case:
                ops_ms = (bound if by == "operations" else 0.0)
                for key, val in zip(keys, (ms, mma_ms, plain_ms, lib_ms, bound, ops_ms, core)):
                    sums[case][key] += val
            elif case:
                t = bf16[case]
                for key, val in zip(bf16_keys[:6], (ms, plain_ms, lib_ms, bound,
                                                    bound if by == "operations" else 0.0,
                                                    mma_ms)):
                    t[key] += val
                t["err"] = max(t["err"], errs[0])
                t["rel"] = max(t["rel"], errs_note["rel"])
                t["tiled"] = max(t["tiled"], errs_note["tiled"])
            del q, k, v, q4, k4, v4
    torch.cuda.empty_cache()
    for case, label in groups.items():
        t = sums[case]
        K1_MMA_RATIO[case] = t["mma_ms"] / t["ms"]
        print(f"K1 f32 over {label} at SM clock {clock / 1e6:.0f} MHz: wgmma kernel "
              f"{t['ms']:.4f} ms, mma.sync kernel {t['mma_ms']:.4f} ms, sdpa "
              f"{t['library_ms']:.4f} ms in turns (wgmma / mma.sync "
              f"{t['ms'] / t['mma_ms']:.3f}, wgmma / sdpa {t['ms'] / t['library_ms']:.3f}), "
              f"bound {t['bound_ms']:.4f} ms ({t['ms'] / t['bound_ms']:.2f}x), CUDA-core bound "
              f"{t['core_ms']:.4f} ms", flush=True)
        t = bf16[case]
        print(f"K1 bf16, dropout 0, over {label}: wgmma kernel {t['ms']:.4f} ms, mma.sync "
              f"kernel {t['mma_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms in turns (wgmma / "
              f"sdpa {t['ms'] / t['library_ms']:.3f}, wgmma / mma.sync "
              f"{t['ms'] / t['mma_ms']:.3f}), plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['ms'] / t['bound_ms']:.2f}x); out within "
              f"{t['rel']:.3e} of max, {t['tiled']:.3e} rms of the tile rounding", flush=True)
    return {**sums, "bf16": bf16, "max_abs_err": worst, "control": control,
            "f32_wgmma_err": f32_wgmma_err, "f32_k2_err": k2_worst}


def cuda_kernel_names(torch, fn) -> list:
    """The CUDA kernels one call of ``fn`` launches (torch.profiler), by name:
    which of SDPA's f32 paths the library call takes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:80] for e in prof.key_averages() if e.device_type == DeviceType.CUDA})


def tf32_control_miss(torch, fa, q, k, v, scale, chunk) -> float:
    """How far the one-pass control (fa.forward_tf32, TF32_CONTROL_PASSES)
    lands outside KERNEL_ATOL + KERNEL_RTOL |plain| of the plain f32 forward,
    over BH chunks: the largest excess, > 0 where it misses."""
    miss = float("-inf")
    for i in range(0, q.shape[0], chunk):
        rows = slice(i, i + chunk)
        want, _ = fa.flash_attention_reference(q[rows], k[rows], v[rows], scale)
        got, _ = fa.forward_tf32(q[rows], k[rows], v[rows], scale, TF32_CONTROL_PASSES)
        miss = max(miss, ((got - want).abs() - KERNEL_ATOL - KERNEL_RTOL * want.abs())
                   .max().item())
        del want, got
    if not miss > 0.0:
        raise AssertionError(f"the {TF32_CONTROL_PASSES}-pass tf32 control meets the f32 gate "
                             f"(excess {miss:.3e}): the gate cannot tell it from 3xTF32")
    return miss


def k2_case_check(torch, fa, gen, q, k, v, out, lse, scale, p, chunk) -> tuple:
    """f32 K2 at one of OTHER_CASES, dropout p, against the plain backward
    over BH chunks at BWD_ATOL/RTOL, on the kernels its dispatch picks (the
    wgmma pair where takes_wgmma_bwd_f32; the mma.sync pair at d = 47),
    which the counters must show.  Returns (text, the largest error)."""
    do = torch.randn(q.shape, device="cuda", generator=gen)
    delta = (do * out).sum(-1)
    before = k2_by_kernel(fa)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, p, 7)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, p, 7)
    torch.cuda.synchronize()
    kind = "f32_wgmma" if fa.takes_wgmma_bwd_f32(q, k, v, do) else "f32_mma"
    moved = {key: n - before[key] for key, n in k2_by_kernel(fa).items()}
    if moved != {f"flash_bwd_{x}_{k}": int(k == kind) for x in ("dq", "dkv") for k in K2_KINDS}:
        raise AssertionError(f"f32 K2 at {tuple(q.shape)}: launches by kernel {moved}")

    def plain(i, a, b, c, g, l, e):
        return fa.flash_attention_backward_reference(a, b, c, g, l, e, scale, p, 7, bh0=i)

    err = check_chunked(torch, (dq, dk, dv), plain, q.shape[0], chunk, q, k, v, do, lse, delta,
                        atol=BWD_ATOL, rtol=BWD_RTOL)
    return (f"K2 on the {kind} kernels: dq {err[0]:.3e} dk {err[1]:.3e} dv {err[2]:.3e} "
            f"(atol = rtol = {BWD_ATOL:.0e})"), max(err)


def k2_control_miss(torch, fa, chunk, q, k, v, do, lse, delta, scale, p, seed) -> float:
    """How far f32 K2's arithmetic in one tf32 pass (fa.backward_tf32,
    TF32_CONTROL_PASSES) lands outside BWD_ATOL + BWD_RTOL |plain| of the
    plain backward, on the first BH chunk: the largest excess over dq, dk and
    dv, > 0 where it misses."""
    rows = slice(0, chunk)
    args = [t[rows] for t in (q, k, v, do, lse, delta)]
    want = fa.flash_attention_backward_reference(*args, scale, p, seed)
    keep = fa.dropout_multiplier(seed, *args[0].shape[:2], k.shape[1], p, q.device) \
        if p > 0.0 else None
    got = fa.backward_tf32(*args, scale, TF32_CONTROL_PASSES, keep)
    miss = max(((g - w).abs() - BWD_ATOL - BWD_RTOL * w.abs()).max().item()
               for g, w in zip(got, want))
    if not miss > 0.0:
        raise AssertionError(f"the {TF32_CONTROL_PASSES}-pass tf32 K2 control meets the f32 "
                             f"gate (excess {miss:.3e}): the gate cannot tell it from 3xTF32")
    return miss


def chunked(fn, bh: int, chunk: int, *tensors):
    """``fn`` over BH chunks of (BH, ...) tensors: the plain versions' memory
    stays bounded (their (chunk, L, L) f32 tensors) while they do all the work."""
    for i in range(0, bh, chunk):
        fn(*(t[i:i + chunk] for t in tensors))


# the L x L x d matrix products of each flash kernel (2 operations per
# multiply-add): the forward forms s = q k^T and p v; dq recomputes s and
# g = do v^T and forms ds k; dk/dv recompute s and g and form (p keep)^T do and
# ds^T q.  Backward outputs: f32 gradients.
FLASH_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}
BWD_OUTPUTS = {"dq": 1, "dkv": 2}


def flash_ops(bh, l, d, kind) -> float:
    return 2.0 * FLASH_PRODUCTS[kind] * bh * l * l * d


def bwd_bound_ms(bh, l, d, elt, kind) -> tuple:
    """Least time of one backward kernel: its operations (``flash_ops``) over
    the peak for the operands' type (f32: three passes at the TF32 peak, the
    3xTF32 kernels), or its bytes (q, k, v in their type; do, lse, delta read
    and the f32 gradients written) over the memory rate."""
    nbytes = 3 * elt * bh * l * d + 4 * bh * l * (d + 2) + 4 * BWD_OUTPUTS[kind] * bh * l * d
    t_ops = (3 * flash_ops(bh, l, d, kind) / PEAK_OPS["tf32"] if elt == 4
             else flash_ops(bh, l, d, kind) / PEAK_OPS["bfloat16"])
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cv2_sampling_reference(np, img, trans, out_wh, sub=None):
    """``cv2.warpAffine(img, trans, out_wh, INTER_LINEAR)`` (border 0) of a
    uint8 (H, W, 3) image, in numpy and float64: the inverse map as OpenCV
    inverts ``trans``, then the bilinear blend at the exact source point
    (``sub`` None: OpenCV 5's float path), or at the point rounded to
    1/``sub`` px the way OpenCV 4's fixed-point remap tables place it (sub
    32: coordinates in 1/1024 px, AB_BITS 10, plus half a table step), then
    rounded to uint8.  Either is within one level of its build's crop."""
    m = np.asarray(trans, np.float64).reshape(-1)
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det else 0.0
    a, b, c, d = m[4] * det, -m[1] * det, -m[3] * det, m[0] * det
    inv = ((a, b, -a * m[2] - b * m[5]), (c, d, -c * m[2] - d * m[5]))
    xs = np.arange(out_wh[0], dtype=np.float64)
    ys = np.arange(out_wh[1], dtype=np.float64)[:, None]

    def source(r):
        if sub is None:
            return r[0] * xs + r[1] * ys + r[2]
        step = 1024 // sub
        fixed = np.rint(r[0] * xs * 1024) + np.rint((r[1] * ys + r[2]) * 1024) + step // 2
        return np.floor(fixed / step) / sub

    sx, sy = source(inv[0]), source(inv[1])
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    H, W = img.shape[:2]
    src = img.astype(np.float64)

    def at(yy, xx):
        ok = ((xx >= 0) & (xx < W) & (yy >= 0) & (yy < H))[..., None]
        return np.where(ok, src[yy.clip(0, H - 1), xx.clip(0, W - 1)], 0.0)

    v = ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x0 + 1))
         + fy * ((1 - fx) * at(y0 + 1, x0) + fx * at(y0 + 1, x0 + 1)))
    return np.floor(v + 0.5).clip(0, 255).astype(np.uint8)


def cv2_sampling(np, crops, images, transes, out_wh) -> dict:
    """Which of ``cv2_sampling_reference``'s two samplings the installed
    OpenCV reproduces on these (crop, source image, forward affine) triples:
    per sampling the largest gap in uint8 levels and the share of equal
    values; 'match' is the sampling within one level of every crop, or None
    where neither is (a crop off its affine, or a third sampling)."""
    res = {}
    for name, sub in (("exact", None), ("1/32 px", 32)):
        gaps = [np.abs(c.astype(np.int64) - cv2_sampling_reference(np, im, t, out_wh, sub))
                for c, im, t in zip(crops, images, transes)]
        res[name] = {"max": int(max(g.max() for g in gaps)),
                     "equal": float(np.mean([np.mean(g == 0) for g in gaps]))}
    fits = [k for k, v in res.items() if v["max"] <= 1 and v["equal"] >= 0.99]
    res["match"] = fits[0] if fits else None
    return res


def warp_read_pixels(torch, tw, trans, hw, out_hw, mask_box=None) -> int:
    """Source pixels the two-pass warp of ``trans`` (B, 2, 3) reads with a
    nonzero tent weight, summed over samples: per output pixel the two rows
    around its source y (pass 2) and, in each, the two columns around the
    pass-1 x of that row, inside the image and, given ``mask_box`` (B, 4),
    inside the sample's mask rectangle (the kernel loads no pixel outside
    it).  This run's crops read only their own footprint, not the whole
    padded image."""
    oh, ow = out_hw
    oy = torch.arange(oh, dtype=torch.float32, device=trans.device)[:, None]
    ox = torch.arange(ow, dtype=torch.float32, device=trans.device)[None, :]
    inside = None if mask_box is None else tw.mask_inside(mask_box.float(), *hw)
    total = 0
    for i, t in enumerate(trans.float()):
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
        if inside is not None:   # (rows, cols) in the decomposition's order
            seen &= (inside[i].t() if transposed else inside[i]).reshape(-1)
        total += int(seen.sum())
    return total


def flash_floors_ms(bh, l, d, kind, clock_hz: float, dropout: float,
                    dtype: str = "bfloat16") -> dict:
    """The floors of one flash kernel, ms: its products at the bf16
    tensor-core peak (f32: three passes at the TF32 peak), its exp2s at the
    MUFU rate and, with dropout, its hashes at the integer rate (one of each
    per (row, key) pair)."""
    pairs = bh * l * l
    tensor = (3 * flash_ops(bh, l, d, kind) / PEAK_OPS["tf32"] if dtype == "float32"
              else flash_ops(bh, l, d, kind) / PEAK_OPS["bfloat16"])
    return {"tensor": tensor * 1e3,
            "mufu": pairs / (EX2_PER_SM_CLOCK * SMS * clock_hz) * 1e3,
            "hash": (HASH_INT_OPS * pairs / (INT_PER_SM_CLOCK * SMS * clock_hz) * 1e3
                     if dropout > 0.0 else 0.0)}


def k1_k2_checks(torch, fa, gen, cases, dtypes, dropouts) -> dict:
    """K1 and K2 at ``cases`` (BH, L, d), in ``dtypes``, at ``dropouts``, on
    operands from ``gen``, against the plain versions over BH chunks (the
    kernels and the plain versions draw the same hash mask): f32 K1 and K2 at
    KERNEL_ATOL/RTOL and BWD_ATOL/RTOL, where K2's one-pass tf32 control
    (``k2_control_miss``) must miss; bf16 K1 (check_fwd_chunked) and K2 (the
    wgmma kernels, which the dispatch must pick: within K2_BF16_RTOL x max
    |grad|) against the plain versions that round where they do, K2's
    distance to the f32 plain version printed.  Returns the worst errors."""
    res = {"fwd_err": 0.0, "dq_err": 0.0, "dkv_err": 0.0, "bf16_rel": 0.0, "f32_gap": 0.0,
           "fwd_bf16_rel": 0.0, "fwd_bf16_err": 0.0, "rowsum": 0.0, "tiled": 0.0,
           "control": float("inf"),
           "k2_control": float("inf"), "f32_k2_err": 0.0, "f32_k2_plain_ms": 0.0}
    seed = 1234
    for bh, lq, d in cases:
        chunk = PLAIN_BH[lq]
        for dtype in dtypes:
            q, k, v = (torch.randn(bh, lq, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
            do = torch.randn(bh, lq, d, device="cuda", generator=gen)
            scale = d ** -0.5
            for p in dropouts:
                out, lse = fa.flash_attention(q, k, v, scale, p, seed)
                fwd, fnote = check_fwd_chunked(torch, fa, (out, lse), q, k, v, scale, p, seed,
                                               chunk)
                res["fwd_bf16_rel"] = max(res["fwd_bf16_rel"], fnote.get("rel", 0.0))
                if dtype == torch.bfloat16:
                    res["fwd_bf16_err"] = max(res["fwd_bf16_err"], fwd[0])
                res["rowsum"] = max(res["rowsum"], fnote.get("rowsum", 0.0))
                res["tiled"] = max(res["tiled"], fnote.get("tiled", 0.0))
                res["control"] = min(res["control"], fnote.get("control", float("inf")))
                delta = (do * out).sum(-1)
                before = k2_by_kernel(fa)
                dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, p, seed)
                dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, p, seed)
                torch.cuda.synchronize()
                # each dtype (d = 48, 96, 112) on its wgmma kernels
                moved = {key: n - before[key] for key, n in k2_by_kernel(fa).items()}
                low = int(dtype == torch.bfloat16)
                if moved != k2_wgmma_want(low, f32=1 - low):
                    raise AssertionError(f"K2 ({bh}, {lq}, {d}) {dtype}: launches by kernel "
                                         f"{moved}")

                def plain(i, a, b, c, g, l, e, widen=False):
                    if widen:
                        a, b, c = a.float(), b.float(), c.float()
                    return fa.flash_attention_backward_reference(a, b, c, g, l, e, scale, p,
                                                                 seed, bh0=i)

                args = (bh, chunk, q, k, v, do, lse, delta)
                if dtype == torch.float32:
                    err = check_chunked(torch, (dq, dk, dv), plain, *args, atol=BWD_ATOL,
                                        rtol=BWD_RTOL)
                    miss = k2_control_miss(torch, fa, chunk, q, k, v, do, lse, delta, scale, p,
                                           seed)
                    res["k2_control"] = min(res["k2_control"], miss)
                    res["f32_k2_err"] = max(res["f32_k2_err"], *err)
                    if p == DROPOUT:   # the plain f32 backward (dq, dk, dv) at the path's p
                        res["f32_k2_plain_ms"] += timed_ms(lambda: chunked(
                            functools.partial(plain, 0), bh, chunk, q, k, v, do, lse, delta), 1)
                    note = f"dq {err[0]:.3e} dk {err[1]:.3e} dv {err[2]:.3e} (atol = rtol = " \
                           f"{BWD_ATOL:.0e}; the one-pass control misses by {miss:.3e})"
                else:
                    err, top = chunk_errors((dq, dk, dv), plain, *args)
                    rel = [e / t for e, t in zip(err, top)]
                    e32, t32 = chunk_errors((dq, dk, dv), functools.partial(plain, widen=True),
                                          *args)
                    gap = max(e / t for e, t in zip(e32, t32))
                    res["bf16_rel"] = max(res["bf16_rel"], *rel)
                    res["f32_gap"] = max(res["f32_gap"], gap)
                    note = (f"dq {rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e} of max |grad| "
                            f"(limit {K2_BF16_RTOL:.0e}); vs the f32 plain version "
                            f"{gap:.3e} of max (not asserted)")
                    if max(rel) > K2_BF16_RTOL:
                        raise AssertionError(f"bf16 K2 vs the rounding plain backward: {rel}")
                res["fwd_err"] = max(res["fwd_err"], *fwd)
                res["dq_err"] = max(res["dq_err"], err[0])
                res["dkv_err"] = max(res["dkv_err"], err[1], err[2])
                print(f"K1+K2 check ({bh}, {lq}, {d}) {str(dtype)[6:]} dropout {p}: out "
                      f"{fwd[0]:.3e}{fnote.get('text', '')} lse {fwd[1]:.3e}; K2 vs plain "
                      f"{note}", flush=True)
                del out, lse, delta, dq, dk, dv
            del q, k, v, do
            torch.cuda.empty_cache()

    return res


def k1_k2_times(torch, F, fa, gen, cases, clock: float) -> dict:
    """bf16 K1 and K2 (the autocast step's operands) at ``cases`` (BH, L, d),
    on operands from ``gen``, summed over the cases: at dropout DROPOUT the
    kernels and the plain versions, K1's wgmma kernel, the mma.sync kernel it
    replaced and SDPA's forward in turns, and K2's wgmma kernels, the mma.sync
    kernels they replaced and SDPA's backward alone (dq, dk and dv: the
    function of K2's two kernels) in turns; K2's three again at dropout 0
    (``*_p0_*``), where the hash drops out; the tensor-core, MUFU and
    dropout-hash floors of each at ``clock``, and the wgmma grids."""
    seed = 1234
    res = {"fwd_mma_ms": 0.0, "k2_p0_library_ms": 0.0}
    for name in ("fwd", "dq", "dkv"):
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "mma_ms"):
            res[f"{name}_{key}"] = 0.0
        for floor in ("tensor", "mufu", "hash"):
            res[f"{name}_{floor}_ms"] = 0.0
    for name in ("dq", "dkv"):
        for key in ("ms", "mma_ms", "bound_ms", "ops_ms"):
            res[f"{name}_p0_{key}"] = 0.0
    for bh, lq, d in cases:
        q, k, v = (torch.randn(bh, lq, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        do = torch.randn(bh, lq, d, device="cuda", generator=gen)
        scale = d ** -0.5
        small = PLAIN_BH[lq]
        q4, k4, v4 = (x[:, None].detach().clone().requires_grad_() for x in (q, k, v))
        do4 = do[:, None].to(torch.bfloat16)

        def sdpa_fwd(p):
            return F.scaled_dot_product_attention(q4, k4, v4, dropout_p=p, scale=scale)

        def sdpa_fwd_alone():
            with torch.no_grad():
                return sdpa_fwd(DROPOUT)

        def k2_turns(p):
            """K2's wgmma kernels, its mma.sync kernels and SDPA's backward
            alone at dropout p, in turns"""
            out, lse = fa.flash_attention(q, k, v, scale, p, seed)
            args = (q, k, v, do, lse, (do * out).sum(-1), scale, p, seed)
            out4 = sdpa_fwd(p)
            got = turns_ms({"dq": lambda: fa.flash_bwd_dq(*args),
                            "dkv": lambda: fa.flash_bwd_dkv(*args),
                            "dq_mma": lambda: fa.flash_bwd_dq_mma(*args),
                            "dkv_mma": lambda: fa.flash_bwd_dkv_mma(*args),
                            "sdpa": lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                                retain_graph=True)}, 5)
            return got, args

        t3 = turns_ms({"wgmma": lambda: fa.flash_attention(q, k, v, scale, DROPOUT, seed),
                       "mma": lambda: fa.flash_attention_mma(q, k, v, scale, DROPOUT, seed),
                       "sdpa": sdpa_fwd_alone}, 5)
        k2, args = k2_turns(DROPOUT)
        k2_p0, _ = k2_turns(0.0)
        t = {
            "fwd_ms": t3["wgmma"], "fwd_mma_ms": t3["mma"], "fwd_library_ms": t3["sdpa"],
            "dq_ms": k2["dq"], "dkv_ms": k2["dkv"], "dq_mma_ms": k2["dq_mma"],
            "dkv_mma_ms": k2["dkv_mma"],
            "dq_library_ms": k2["sdpa"], "dkv_library_ms": k2["sdpa"],
            "dq_p0_ms": k2_p0["dq"], "dkv_p0_ms": k2_p0["dkv"],
            "dq_p0_mma_ms": k2_p0["dq_mma"], "dkv_p0_mma_ms": k2_p0["dkv_mma"],
            "k2_p0_library_ms": k2_p0["sdpa"],
            "fwd_plain_ms": timed_ms(lambda: chunked(
                lambda a, b, c: fa.flash_attention_reference(a, b, c, scale, DROPOUT, seed),
                bh, small, q, k, v), 2),
            "dq_plain_ms": timed_ms(lambda: chunked(
                lambda a, b, c, g, l, e: fa.flash_attention_backward_reference(
                    a, b, c, g, l, e, scale, DROPOUT, seed), bh, small, *args[:6]), 2),
        }
        t["dkv_plain_ms"] = t["dq_plain_ms"]   # one plain backward makes dq, dk and dv
        floors = {}
        for kind in ("fwd", "dq", "dkv"):
            floors[kind] = flash_floors_ms(bh, lq, d, kind, clock, DROPOUT)
            bytes_bound = (flash_bound_ms(bh, lq, lq, d, "bfloat16")[0] if kind == "fwd"
                           else bwd_bound_ms(bh, lq, d, 2, kind)[0])
            t[f"{kind}_ops_ms"] = max(floors[kind].values())
            t[f"{kind}_bound_ms"] = max(t[f"{kind}_ops_ms"], bytes_bound)
            t.update({f"{kind}_{f}_ms": ms for f, ms in floors[kind].items()})
            if kind != "fwd":
                # at dropout 0: no hash
                t[f"{kind}_p0_ops_ms"] = max(flash_floors_ms(bh, lq, d, kind, clock,
                                                             0.0).values())
                t[f"{kind}_p0_bound_ms"] = max(t[f"{kind}_p0_ops_ms"], bytes_bound)
        for key, val in t.items():
            res[key] += val
        f32core = 4.0 * bh * lq * lq * d / PEAK_OPS["float32"] * 1e3

        def floor_text(kind):
            return ", ".join(f"{f} {ms:.4f}" for f, ms in floors[kind].items())

        grids = fa.wgmma_bwd_waves(bh, lq, d, DROPOUT)
        print(f"train kernels ({bh}, {lq}, {d}) bf16 dropout {DROPOUT}: K1 {t['fwd_ms']:.4f} ms "
              f"(mma.sync kernel {t['fwd_mma_ms']:.4f} and sdpa {t['fwd_library_ms']:.4f} in "
              f"turns; wgmma grid {wgmma_grid(fa, bh, lq, d, DROPOUT)}; plain "
              f"{t['fwd_plain_ms']:.4f}; floors: {floor_text('fwd')}, f32-core bound "
              f"{f32core:.4f}); K2 wgmma dq {t['dq_ms']:.4f} ms (floors: {floor_text('dq')}), "
              f"dkv {t['dkv_ms']:.4f} ms (floors: {floor_text('dkv')}), mma.sync dq "
              f"{t['dq_mma_ms']:.4f} dkv {t['dkv_mma_ms']:.4f} and sdpa backward alone "
              f"{t['dq_library_ms']:.4f} ms in turns; wgmma grids " + ", ".join(
                  f"{kind} {g['blocks']} blocks, {g['blocks_per_sm']} an SM, {g['waves']:.2f} "
                  f"waves, {g['tile']}-wide looped tile" for kind, g in grids.items()) +
              f"; plain backward {t['dq_plain_ms']:.4f} ms; at dropout 0 (in turns): wgmma dq "
              f"{t['dq_p0_ms']:.4f} dkv {t['dkv_p0_ms']:.4f}, mma.sync dq "
              f"{t['dq_p0_mma_ms']:.4f} dkv {t['dkv_p0_mma_ms']:.4f}, sdpa backward "
              f"{t['k2_p0_library_ms']:.4f}, bounds dq {t['dq_p0_bound_ms']:.4f} dkv "
              f"{t['dkv_p0_bound_ms']:.4f}", flush=True)
        del q, k, v, do, q4, k4, v4, do4, args, k2, k2_p0
        torch.cuda.empty_cache()
    return res


def k2_text(r: dict) -> str:
    """K2's bf16 times of ``k1_k2_times`` (summed over its cases) at dropout
    DROPOUT and 0: the wgmma kernels, the mma.sync ones and SDPA's backward in
    turns, with the bounds."""
    parts = []
    for label, sfx, lib in ((f"dropout {DROPOUT}", "", "dq_library_ms"),
                            ("dropout 0", "_p0", "k2_p0_library_ms")):
        wg = r[f"dq{sfx}_ms"] + r[f"dkv{sfx}_ms"]
        mma = r[f"dq{sfx}_mma_ms"] + r[f"dkv{sfx}_mma_ms"]
        parts.append(f"{label}: wgmma dq {r[f'dq{sfx}_ms']:.4f} + dkv {r[f'dkv{sfx}_ms']:.4f} = "
                     f"{wg:.4f} ms (bounds {r[f'dq{sfx}_bound_ms']:.4f}, "
                     f"{r[f'dkv{sfx}_bound_ms']:.4f}), mma.sync {r[f'dq{sfx}_mma_ms']:.4f} + "
                     f"{r[f'dkv{sfx}_mma_ms']:.4f} = {mma:.4f}, SDPA backward alone "
                     f"{r[lib]:.4f}: wgmma / SDPA {wg / r[lib]:.3f}, mma.sync / SDPA "
                     f"{mma / r[lib]:.3f}")
    return "; ".join(parts)


def train_kernel_phase(torch, F, fa, tw) -> dict:
    """K1 with dropout, K2 and K4 at the training path's shapes.

    K1 and K2 at TRAIN_CASES (BH 32), f32 and bf16, dropout 0 and 0.1, against
    the plain versions over BH chunks (the kernels and the plain versions draw
    the same hash mask): f32 K1 and K2 at KERNEL_ATOL/RTOL and BWD_ATOL/RTOL,
    where K2's one-pass tf32 control (``k2_control_miss``) must miss;
    bf16 K1 (check_fwd_chunked: lse at KERNEL_ATOL/RTOL, out within
    K1_BF16_RTOL x max |out| and K1_BF16_TILED_RMS, rows of exp(s' - lse)
    within ROWSUM_ATOL of 1) and K2 (within K2_BF16_RTOL x max |grad|) against
    the plain versions that round where they do, K2's distance to the f32
    plain version printed.  Then timed at BH 32 in bf16 (the autocast step's
    operands), dropout 0.1 (K2 also 0), beside the mma.sync kernels they
    replaced in turns and the tensor-core, MUFU and dropout-hash floors of
    each.  Library yardsticks: SDPA's forward (K1) and SDPA's backward alone
    (K2: dq, dk and dv, the function of K2's two kernels), with the same
    dropout.  K4: ``warp_phase``.
    f32 K2's times, beside its SIMT kernels' and SDPA's f32 backward, come
    from the tools phase (tools/bench_flash_bwd.py --dtype float32).
    """
    from buctd_tpu_torch.tools.bench_exp2 import sm_clock_hz

    gen = torch.Generator(device="cuda").manual_seed(1)
    res = k1_k2_checks(torch, fa, gen, TRAIN_CASES, (torch.float32, torch.bfloat16),
                       (0.0, DROPOUT))
    clock = sm_clock_hz()
    res.update(k1_k2_times(torch, F, fa, gen, TRAIN_CASES, clock))
    print(f"K1 bf16 over {TRAIN_CASES} at SM clock {clock / 1e6:.0f} MHz, dropout "
          f"{DROPOUT}: wgmma kernel {res['fwd_ms']:.4f} ms (mma.sync kernel in turns "
          f"{res['fwd_mma_ms']:.4f}); floors "
          f"tensor {res['fwd_tensor_ms']:.4f} mufu {res['fwd_mufu_ms']:.4f} hash "
          f"{res['fwd_hash_ms']:.4f}, bound {res['fwd_bound_ms']:.4f} ms; SDPA forward "
          f"{res['fwd_library_ms']:.4f} ms, K1 / SDPA forward "
          f"{res['fwd_ms'] / res['fwd_library_ms']:.3f}; worst bf16 check {res['fwd_bf16_rel']:.3e} "
          f"of max |out| (limit {K1_BF16_RTOL:.0e}), vs the tile rounding rms {res['tiled']:.3e} "
          f"(limit {K1_BF16_TILED_RMS:.0e}; unrounded control {res['control']:.3e} at least), "
          f"rows of exp(s' - lse) within {res['rowsum']:.3e} of 1", flush=True)
    print(f"K2 bf16 over {TRAIN_CASES} at SM clock {clock / 1e6:.0f} MHz: {k2_text(res)}; "
          f"floors dq tensor {res['dq_tensor_ms']:.4f} mufu {res['dq_mufu_ms']:.4f} hash "
          f"{res['dq_hash_ms']:.4f}, dkv tensor {res['dkv_tensor_ms']:.4f} mufu "
          f"{res['dkv_mufu_ms']:.4f} hash {res['dkv_hash_ms']:.4f}; worst bf16 check "
          f"{res['bf16_rel']:.3e} of max |grad|, distance to the f32 plain version "
          f"{res['f32_gap']:.3e}", flush=True)
    print(f"K2 f32 (3xTF32) over {TRAIN_CASES}, dropout 0 and {DROPOUT}: within atol = rtol = "
          f"{BWD_ATOL:.0e} of the plain backward at every check above, the one-pass control "
          f"at least {res['k2_control']:.3e} outside it; times: the tools phase", flush=True)

    res.update(warp_phase(torch, F, tw, gen))
    return res


def transpose_kernel_phase(torch, F, fa, tk: dict) -> dict:
    """K1 and K2 at TransPose-H's training shape TP_TRAIN_CASES (d = 112),
    bf16, dropout DROPOUT: checked against the plain versions at the bf16
    gates (``k1_k2_checks``) and timed beside SDPA's forward and backward and
    the floors (``k1_k2_times``); the kernel / SDPA ratios printed beside
    those at TRAIN_CASES (``tk``, the training kernel phase's).  f32 K1 and
    K2 at the same shape with dropout 0 and 0.1 at the f32 gates (K2's
    one-pass control missing); f32 K1 at d = 112 is also in the kernel phase
    (TP_F32_CASES).  Prints ptxas's registers and spills of f32 K1's two
    kernels at every head dim (tools/bench_flash_fwd.py::register_summary)
    and of every instantiation of bf16 K2's and f32 K2's two pairs
    (tools/bench_flash_bwd.py::register_summary)."""
    from buctd_tpu_torch import _build
    from buctd_tpu_torch.tools.bench_exp2 import sm_clock_hz
    from buctd_tpu_torch.tools.bench_flash_bwd import register_summary as bwd_register_summary
    from buctd_tpu_torch.tools.bench_flash_fwd import register_summary

    for name in (F32_K1_KERNEL, "flash_fwd_tf32_kernel"):
        print(f"f32 K1 registers (spills; serialized wgmma) by head dim, {name}: "
              f"{register_summary(_build.build_log('flash_fwd'), name)}", flush=True)
    print(f"bf16 K2 registers (spills; serialized wgmma) of every instantiation, the wgmma "
          f"pair (wg_) and the mma.sync pair: "
          f"{bwd_register_summary(_build.build_log('flash_bwd'))}", flush=True)
    for lib in ("flash_bwd", "flash_bwd_kvres"):
        print(f"f32 K2 registers (spills; serialized wgmma) of every instantiation in {lib}, "
              f"the wgmma pair (wg_) and the mma.sync pair: "
              f"{bwd_register_summary(_build.build_log(lib), F32_K2_KINDS)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    # f32 K1 and K2 at d = 112 (TPU.COMPUTE_DTYPE float32 training), dropout
    # 0 and 0.1: K2 on its wgmma pair at the f32 gate, the control missing
    f32 = k1_k2_checks(torch, fa, gen, TP_TRAIN_CASES, (torch.float32,), (0.0, DROPOUT))
    res = k1_k2_checks(torch, fa, gen, TP_TRAIN_CASES, (torch.bfloat16,), (DROPOUT,))
    res["f32_k2_err"], res["f32_k2_control"] = f32["f32_k2_err"], f32["k2_control"]
    res.update(k1_k2_times(torch, F, fa, gen, TP_TRAIN_CASES, sm_clock_hz()))
    for kind, lib, label in (("fwd", "fwd_library_ms", "K1 / SDPA forward"),
                             ("dq", "dq_library_ms", "K2 (dq + dkv) / SDPA backward")):
        mine = res["fwd_ms"] if kind == "fwd" else res["dq_ms"] + res["dkv_ms"]
        theirs = tk["fwd_ms"] if kind == "fwd" else tk["dq_ms"] + tk["dkv_ms"]
        print(f"bf16 {label}: {mine / res[lib]:.3f} at {TP_TRAIN_CASES} (d = 112), "
              f"{theirs / tk[lib]:.3f} over {TRAIN_CASES}", flush=True)
    print(f"bf16 at d = 112: worst K1 check {res['fwd_bf16_rel']:.3e} of max |out|, tile "
          f"rounding rms {res['tiled']:.3e}; worst K2 check {res['bf16_rel']:.3e} of max "
          f"|grad|; K2 at {TP_TRAIN_CASES}: {k2_text(res)}", flush=True)
    return res


def grid_sample_affine(torch, F, images, trans, out_hw):
    """F.grid_sample (bilinear, zeros, align_corners=False) of (B, H, W, C)
    images at the (B, 2, 3) output->source affines: theta = N_src T N_out^-1
    in normalised coordinates.  Returns (run, grid): ``run()`` gives the
    (B, C, oh, ow) warp."""
    B, H, W, C = images.shape
    oh, ow = out_hw

    def norm(w, h):
        return torch.tensor([[2.0 / w, 0.0, 1.0 / w - 1.0], [0.0, 2.0 / h, 1.0 / h - 1.0],
                             [0.0, 0.0, 1.0]], device="cuda", dtype=torch.float64)

    t3 = torch.cat([trans.double(), torch.tensor([[[0.0, 0.0, 1.0]]], device="cuda",
                                                 dtype=torch.float64).expand(B, 1, 3)], dim=1)
    theta = (norm(W, H) @ t3 @ torch.linalg.inv(norm(ow, oh)))[:, :2]
    grid = F.affine_grid(theta, (B, C, oh, ow), align_corners=False).float()
    x_nchw = images.permute(0, 3, 1, 2).contiguous()
    return lambda: F.grid_sample(x_nchw, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False)


def same_bits(torch, got, want) -> bool:
    """Equal bit for bit, NaN in the same places."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def loader_chain_before(torch, tw, images, trans, mask_box, mean, std, out_hw):
    """The device loader's work before the render as it was with the two-pass
    kernel: the uint8 bucket cast to f32 and multiplied by the crop-aug mask
    in device memory, then warped by the two-pass form, rounded and
    normalised."""
    B, H, W, _ = images.shape
    x = images.float()
    bx, by, bw, bh = (mask_box[:, i, None, None] for i in range(4))
    xs = torch.arange(W, dtype=torch.float32, device=x.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=x.device)[None, :, None]
    inside = (xs >= bx) & (xs < bx + bw) & (ys >= by) & (ys < by + bh)
    crops = torch.round(tw.warp_resample_two_pass(x * inside[..., None], trans, out_hw))
    return (crops / 255.0 - mean) / std


def loader_chain(torch, tw, images, trans, mask_box, mean, std, out_hw):
    """The same with the fused kernel reading the bucket and the mask itself
    (data/device_pipeline.py::DeviceLoader._device_batch before the render)."""
    crops = torch.round(tw.warp_affine_general(images, trans, out_hw, mask_box=mask_box))
    return (crops / 255.0 - mean) / std


def warp_phase(torch, F, tw, gen) -> dict:
    """K4 at the training loader's shape, WARP_BATCH -> 384x288, rotations
    -90..90 (both decompositions): the fused kernel vs the plain version
    (WARP_ATOL) and bit for bit vs the two-pass form, both timed in turns; the
    uint8 source with mask rectangles vs the plain version of the f32 masked
    images (WARP_ATOL) and bit for bit vs the fused f32 warp of them, timed,
    with its own bytes bound (3 B a footprint pixel inside its sample's mask,
    12 B an output pixel); rotation 0 at the evaluation loader's scales,
    where F.grid_sample is the same function (WARP_GRID_ATOL), both timed in
    turns; the loader's work before the render, the former chain vs the fused one, equal bit for
    bit and timed in turns."""
    from buctd_tpu_torch.data.joints_dataset import IMAGENET_MEAN, IMAGENET_STD
    from buctd_tpu_torch.geometry import make_affine

    res = {}
    B, H, W = WARP_BATCH
    out_hw = (384, 288)
    n_out = B * out_hw[0] * out_hw[1]
    images = torch.rand(B, H, W, 3, device="cuda", generator=gen) * 255.0
    centers = torch.rand(B, 2, device="cuda", generator=gen) * torch.tensor(
        [440.0, 280.0], device="cuda") + 100.0
    scales = torch.rand(B, 2, device="cuda", generator=gen) * 1.2 + 0.6
    rots = torch.rand(B, device="cuda", generator=gen) * 180.0 - 90.0   # both decompositions
    trans = make_affine(centers, scales, rots, out_hw[::-1], inv=True).contiguous()
    got = tw.warp_affine_general(images, trans, out_hw)
    two = tw.warp_resample_two_pass(images, trans, out_hw)
    torch.cuda.synchronize()
    want = tw.warp_affine_reference(images, trans, out_hw)
    torch.testing.assert_close(got, want, atol=WARP_ATOL, rtol=0)
    res["warp_err"] = (got - want).abs().max().item()
    if not same_bits(torch, got, two):
        raise AssertionError(f"fused K4 vs the two-pass form: max |gap| "
                             f"{(got - two).abs().max().item():.3e}, not bit for bit")
    res["warp_two_pass_ms"], res["warp_ms"] = ab_ms(
        lambda: tw.warp_resample_two_pass(images, trans, out_hw),
        lambda: tw.warp_resample(images, trans, out_hw), 20)
    if res["warp_ms"] >= res["warp_two_pass_ms"]:
        raise AssertionError(f"fused K4 {res['warp_ms']:.4f} ms is no faster than the "
                             f"two-pass form's {res['warp_two_pass_ms']:.4f} ms")
    res["warp_plain_ms"] = timed_ms(lambda: tw.warp_affine_reference(images, trans, out_hw), 2)
    res["warp_library_ms"] = timed_ms(grid_sample_affine(torch, F, images, trans, out_hw), 20)
    # bytes: the f32 source pixels the crops read (each once) and the output
    read = warp_read_pixels(torch, tw, trans, (H, W), out_hw)
    res["warp_bound_ms"] = 4 * 3 * (read + n_out) / HBM_BYTES_PER_S * 1e3
    full_ms = 4 * 3 * B * (H * W + out_hw[0] * out_hw[1]) / HBM_BYTES_PER_S * 1e3
    print(f"K4 warp ({B}, {H}, {W}, 3) f32 -> {out_hw}, rotations -90..90: max_abs_err "
          f"{res['warp_err']:.3e} (limit {WARP_ATOL:.0e}), bit for bit the two-pass form; "
          f"fused {res['warp_ms']:.4f} ms, two-pass in turns {res['warp_two_pass_ms']:.4f} ms "
          f"({res['warp_two_pass_ms'] / res['warp_ms']:.2f}x), plain "
          f"{res['warp_plain_ms']:.4f} ms, grid_sample (one-pass, not the same function when "
          f"rotated) {res['warp_library_ms']:.4f} ms, bound {res['warp_bound_ms']:.4f} ms "
          f"(bytes: the crops read {read} source pixels, {100 * read / (B * H * W):.1f}% of "
          f"the images; whole-image bound {full_ms:.4f} ms)", flush=True)

    # the loader's input: the uint8 bucket, each sample's crop-aug rectangle
    # (a quarter of them the whole 480x640 image, as samples without one)
    u8 = torch.randint(0, 256, (B, H, W, 3), dtype=torch.uint8, device="cuda", generator=gen)
    lo = torch.rand(B, 2, device="cuda", generator=gen) * torch.tensor([320.0, 240.0],
                                                                         device="cuda")
    size = torch.rand(B, 2, device="cuda", generator=gen) * torch.tensor([320.0, 240.0],
                                                                           device="cuda") + 40.0
    boxes = torch.cat([lo, size], 1)
    boxes[::4] = torch.tensor([0.0, 0.0, 640.0, 480.0], device="cuda")
    boxes = boxes.contiguous()
    got8 = tw.warp_resample(u8, trans, out_hw, boxes)
    masked = tw.apply_mask_box(u8, boxes)
    if not same_bits(torch, got8, tw.warp_resample(masked, trans, out_hw)):
        raise AssertionError("fused K4 on uint8 with mask rectangles vs the f32 masked "
                             "images: not bit for bit")
    torch.cuda.synchronize()
    want8 = tw.warp_affine_reference(masked, trans, out_hw)
    torch.testing.assert_close(got8, want8, atol=WARP_ATOL, rtol=0)
    res["warp_uint8_err"] = (got8 - want8).abs().max().item()
    del want8
    res["warp_uint8_ms"] = timed_ms(lambda: tw.warp_resample(u8, trans, out_hw, boxes), 20)
    # bytes: the uint8 footprint pixels inside the mask rectangles, the output
    read8 = warp_read_pixels(torch, tw, trans, (H, W), out_hw, boxes)
    res["warp_uint8_bound_ms"] = (3 * read8 + 12 * n_out + 16 * B) / HBM_BYTES_PER_S * 1e3
    print(f"K4 uint8 + mask rectangles: max_abs_err vs the plain version of images.float() "
          f"* inside {res['warp_uint8_err']:.3e} (limit {WARP_ATOL:.0e}), bit for bit the "
          f"f32 warp of those images; {res['warp_uint8_ms']:.4f} ms, bound "
          f"{res['warp_uint8_bound_ms']:.4f} ms (3 B a footprint pixel inside its mask, "
          f"{read8} of the {read} footprint pixels; 12 B an output pixel)", flush=True)

    mean = torch.as_tensor(IMAGENET_MEAN, device="cuda")
    std = torch.as_tensor(IMAGENET_STD, device="cuda")
    old = loader_chain_before(torch, tw, u8, trans, boxes, mean, std, out_hw)
    new = loader_chain(torch, tw, u8, trans, boxes, mean, std, out_hw)
    if not same_bits(torch, new, old):
        raise AssertionError("the loader's chain before the render changed its output")
    res["loader_before_ms"], res["loader_ms"] = ab_ms(
        lambda: loader_chain_before(torch, tw, u8, trans, boxes, mean, std, out_hw),
        lambda: loader_chain(torch, tw, u8, trans, boxes, mean, std, out_hw), 10)
    print(f"loader before the render ({B}, {H}, {W}, 3) uint8 -> {out_hw}: former chain "
          f"(cast, mask multiply, f32 warp, round, normalise) {res['loader_before_ms']:.4f} "
          f"ms, fused read {res['loader_ms']:.4f} ms in turns; outputs bit for bit",
          flush=True)
    del u8, masked, got8, old, new

    # rotation 0 at the evaluation scales: grid_sample is the same function
    s0 = torch.rand(B, 1, device="cuda", generator=gen) * (
        WARP_EVAL_SCALES[1] - WARP_EVAL_SCALES[0]) + WARP_EVAL_SCALES[0]
    trans0 = make_affine(centers, s0.expand(B, 2), torch.zeros(B, device="cuda"),
                         out_hw[::-1], inv=True).contiguous()
    got0 = tw.warp_affine_general(images, trans0, out_hw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got0, tw.warp_affine_reference(images, trans0, out_hw),
                               atol=WARP_ATOL, rtol=0)
    library = grid_sample_affine(torch, F, images, trans0, out_hw)
    res["warp_rot0_grid_err"] = (library().permute(0, 2, 3, 1) - got0).abs().max().item()
    if res["warp_rot0_grid_err"] > WARP_GRID_ATOL:
        raise AssertionError(f"K4 vs grid_sample at rotation 0: {res['warp_rot0_grid_err']:.3e} "
                             f"> {WARP_GRID_ATOL:.0e}")
    res["warp_library_rot0_ms"], res["warp_rot0_ms"] = ab_ms(
        library, lambda: tw.warp_resample(images, trans0, out_hw), 20)
    print(f"K4 at rotation 0, scales {WARP_EVAL_SCALES} (the evaluation loader's): fused "
          f"{res['warp_rot0_ms']:.4f} ms, F.grid_sample (the same function here) in turns "
          f"{res['warp_library_rot0_ms']:.4f} ms, max |gap| {res['warp_rot0_grid_err']:.3e} "
          f"(limit {WARP_GRID_ATOL:.0e})", flush=True)
    del images, got, two, want, got0
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


def serving_phase(torch, np, fa, config=CONFIG, k1_per_forward: int = 2,
                  exact_ref: bool = False) -> dict:
    """``config``'s model served at full width through PoseEstimator (f32,
    ROUNDS rounds, random weights): predict and predict_batch, K1's launches
    (``k1_per_forward`` a forward), one forward on the card vs the CPU
    (within FORWARD_RTOL x peak; with ``exact_ref``, both against the CPU's
    float64 forward, within FORWARD_F64_RATIO)."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.serving import PoseEstimator

    cfg = default_config()
    update_config(cfg, types.SimpleNamespace(cfg=str(config), opts=[]))
    torch.manual_seed(0)
    est = PoseEstimator(cfg, refine_iters=ROUNDS)   # device="cuda"
    randomize(torch, est.model)
    joints = int(cfg.MODEL.NUM_JOINTS)
    print(f"serving: {cfg.MODEL.NAME} {tuple(cfg.MODEL.IMAGE_SIZE)} {joints} joints, "
          f"{sum(p.numel() for p in est.model.parameters())} parameters, "
          f"{ROUNDS} rounds; allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    rng = np.random.RandomState(0)
    img, conds = sample_request(np, rng, joints=joints)
    batch = [sample_request(np, rng, joints=joints) for _ in range(3)]
    images, poses = [b[0] for b in batch], [b[1] for b in batch]
    keep = float("-inf")   # random weights: keep every joint, whatever its confidence

    zero_k1(fa)                                      # the main path's run
    est.predict(img, conds, keep)                    # first calls: each bucket's graph
    est.predict_batch(images, poses, keep)           # (two eager warm-ups, the capture,
    torch.cuda.synchronize()                         # a replay)
    first = fa.flash_attention.launches
    f32_k1_wgmma(fa, f"{cfg.MODEL.NAME} serving")
    zero_k1(fa)                                      # the timed replays
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        out = est.predict(img, conds, keep)
    t1 = time.perf_counter()
    for _ in range(REPEATS):
        outs = est.predict_batch(images, poses, keep)
    t2 = time.perf_counter()
    timed = fa.flash_attention.launches
    f32_k1_wgmma(fa, f"{cfg.MODEL.NAME} serving")
    launches = first + timed

    if out.shape != (4, joints, 3) or not np.isfinite(out).all():
        raise AssertionError(f"predict gave {out.shape}, finite={np.isfinite(out).all()}")
    for o in outs:
        if o.shape != (4, joints, 3) or not np.isfinite(o).all():
            raise AssertionError(f"predict_batch gave {o.shape}")
    # K1 counted where it ran: the first calls' two warm-ups and one replay a
    # bucket (predict's and predict_batch's), then one replay a timed call
    per_call = k1_per_forward * ROUNDS
    if first != per_call * 2 * 3 or timed != per_call * 2 * REPEATS:
        raise AssertionError(f"flash launches {first} in the first calls, {timed} in the "
                             f"timed replays; expected {k1_per_forward} per forward x "
                             f"{ROUNDS} rounds x (2 x 3) and x {2 * REPEATS}")
    ms_predict = (t1 - t0) / REPEATS * 1e3
    ms_batch = (t2 - t1) / REPEATS * 1e3
    name = cfg.MODEL.NAME
    print(f"{name} predict: {ms_predict:.2f} ms/image (4 poses, {ROUNDS} rounds), "
          f"{4 * 1e3 / ms_predict:.2f} crops/s", flush=True)
    print(f"{name} predict_batch (3 images x 4 poses, padded to 4 images): "
          f"{ms_batch / 3:.2f} ms/image, {12 * 1e3 / ms_batch:.2f} crops/s", flush=True)
    print(f"{name} flash launches in the run: {launches} ({first} in two buckets' warm-ups "
          f"and first replays + {timed} in the {2 * REPEATS} timed replays, {k1_per_forward} "
          f"x {ROUNDS} a forward)", flush=True)

    # one forward on the card vs the same module on the CPU
    x = torch.from_numpy(rng.randn(1, 6, 384, 288).astype(np.float32))
    with torch.inference_mode():
        got = est.model(x.cuda()).cpu()
        cpu_model = copy.deepcopy(est.model).cpu()
        want_hm = cpu_model(x)
        exact = cpu_model.double()(x.double()) if exact_ref else None
    err = (got - want_hm).abs().max().item()
    peak = want_hm.abs().max().item()
    if not exact_ref:
        print(f"{name} forward card vs CPU: max_abs_err {err:.3e}, heatmap peak {peak:.3e}, "
              f"std {want_hm.std().item():.3e}, limit {FORWARD_RTOL:.0e} x peak", flush=True)
        if not err <= FORWARD_RTOL * peak:
            raise AssertionError("card forward disagrees with the CPU forward")
    else:
        card64, cpu64 = ((t.double() - exact).abs().max().item() for t in (got, want_hm))
        print(f"{name} forward vs float64 on the CPU: card (f32) {card64:.3e}, CPU (f32) "
              f"{cpu64:.3e} ({card64 / cpu64:.2f}x, limit {FORWARD_F64_RATIO}x), heatmap peak "
              f"{peak:.3e}; card vs CPU {err:.3e}", flush=True)
        if not card64 <= FORWARD_F64_RATIO * cpu64:
            raise AssertionError("card forward further from float64 than the CPU's f32 forward")
    return {"launches": launches, "ms_predict": ms_predict, "ms_batch": ms_batch,
            "est": est, "images": images, "poses": poses}


def host_ms(fn, iters: int) -> float:
    """Host time of ``fn()`` (a call that ends on the host), ms a call."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


@contextlib.contextmanager
def card_attention_rule():
    """CPU attention calls take the flash path where CUDA ones would (L_q *
    L_k >= 512^2 under the 'auto' engine): its plain version there, which in
    bf16 rounds p as K1 does (models/attention.py's batched-matmul path keeps
    p in f32), so a CPU forward computes the card's function."""
    from buctd_tpu_torch.models import attention

    rule = attention._use_flash

    def card_rule(q, nk, dv, engine):
        return q.shape[-1] == dv and (engine == "flash" or (
            engine == "auto" and q.shape[-2] * nk >= attention.FLASH_MIN_TOKENS))

    attention._use_flash = card_rule
    try:
        yield
    finally:
        attention._use_flash = rule


@contextlib.contextmanager
def exact_warps():
    """The refine round's warp and render exact whatever the model's dtype:
    a bf16 round's TF32 operands (core/refine.py) turned off, for the drift
    they cause."""
    from buctd_tpu_torch.core import refine

    real = refine.warp_affine_aligned, refine.render_condition
    refine.warp_affine_aligned = lambda *args, tf32, **kw: real[0](*args, tf32=False, **kw)
    refine.render_condition = lambda *args, tf32, **kw: real[1](*args, tf32=False, **kw)
    try:
        yield
    finally:
        refine.warp_affine_aligned, refine.render_condition = real


@contextlib.contextmanager
def module_dtypes(torch, model):
    """name -> output dtype of every module of ``model`` whose output is a
    tensor, filled by the forwards run inside the block."""
    dtypes = {}

    def record(name):
        def hook(module, args, out):
            if torch.is_tensor(out):
                dtypes[name] = out.dtype
        return hook

    handles = [m.register_forward_hook(record(n)) for n, m in model.named_modules()]
    try:
        yield dtypes
    finally:
        for handle in handles:
            handle.remove()


def bf16_serving_phase(torch, np, fa, config=CONFIG, k1_per_forward: int = 2,
                       opts=(), cpu_check: bool = True) -> dict:
    """``config``'s model served in bf16 (TPU.EVAL_DTYPE bfloat16) at full
    width through PoseEstimator (ROUNDS rounds), beside an f32 estimator of
    the same random weights.  The bf16 main path's run: predict and
    predict_batch once each, finite outputs, K1 launched ``k1_per_forward``
    a forward.  Then predict and predict_batch timed in turns with the f32
    estimator; a profile of one predict_batch in each dtype (K1's
    tensor-core kernel by name in bf16, the convolutions' share of kernel
    time in both); one round of both on the predict_batch inputs: the share
    of joints whose bf16 and f32 keypoints lie within one heatmap pixel (a
    report: the weights are random), and the bf16 decode's drift with the
    warp and render exact against TF32 (WARP_DRIFT_PX); with ``cpu_check``,
    one bf16 forward on the card against the CPU's (BF16_FORWARD_RATIO)."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.core.refine import joints2cs, make_refine_fn
    from buctd_tpu_torch.models import autocast
    from buctd_tpu_torch.models.hrnet import Upsample
    from buctd_tpu_torch.serving import PoseEstimator

    def load(dtype):
        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(config), opts=[
            *opts, "TPU.EVAL_DTYPE", dtype]))
        return cfg

    cfg32, cfg16 = load("float32"), load("bfloat16")
    torch.manual_seed(0)
    est32 = PoseEstimator(cfg32, refine_iters=ROUNDS)   # device="cuda"
    randomize(torch, est32.model)
    est16 = PoseEstimator(cfg16, refine_iters=ROUNDS)
    est16.model.load_state_dict(est32.model.state_dict())
    label = f"{cfg16.MODEL.NAME}{' '.join([''] + list(opts))} bf16"
    joints = int(cfg16.MODEL.NUM_JOINTS)
    rng = np.random.RandomState(0)
    img, conds = sample_request(np, rng, joints=joints)
    batch = [sample_request(np, rng, joints=joints) for _ in range(3)]
    images, poses = [b[0] for b in batch], [b[1] for b in batch]
    keep = float("-inf")
    est32.predict(img, conds, keep)                  # first calls: the f32 graphs
    est32.predict_batch(images, poses, keep)
    torch.cuda.synchronize()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

    zero_k1(fa)                                      # the bf16 main path's run: each
    est16.predict(img, conds, keep)                  # bucket's warm-ups, capture and a
    est16.predict_batch(images, poses, keep)         # replay, then a replay of each
    out = est16.predict(img, conds, keep)
    outs = est16.predict_batch(images, poses, keep)
    launches = fa.flash_attention.launches
    wgmma = bf16_k1_launches(fa, label, launches)
    f32_k1_wgmma(fa, label)
    for o in [out, *outs]:
        if o.shape != (4, joints, 3) or not np.isfinite(o).all():
            raise AssertionError(f"{label}: prediction {o.shape}, finite "
                                 f"{np.isfinite(o).all()}")
    # two buckets: two warm-ups and two replays each (the capture runs nothing)
    want = k1_per_forward * ROUNDS * 2 * 4
    if launches != want:
        raise AssertionError(f"{label}: flash launches {launches}, expected {want}")
    if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != flags:
        raise AssertionError(f"{label}: the estimator left the TF32 flags changed")

    calls = {key: [] for key in ("predict_f32", "predict_bf16", "batch_f32", "batch_bf16")}
    for _ in range(BF16_REPEATS):
        for dtype, e in (("f32", est32), ("bf16", est16), ("bf16", est16), ("f32", est32)):
            calls[f"predict_{dtype}"].append(host_ms(lambda: e.predict(img, conds, keep), 1))
            calls[f"batch_{dtype}"].append(
                host_ms(lambda: e.predict_batch(images, poses, keep), 1))
    ms = {key: statistics.median(v) for key, v in calls.items()}
    spread = {key: f"{min(v):.2f}-{max(v):.2f}" for key, v in calls.items()}
    print(f"{label} serving, medians of {2 * BF16_REPEATS} calls a dtype in turns with f32 "
          f"(f32, bf16, bf16, f32): predict {ms['predict_bf16']:.2f} ms/image "
          f"[{spread['predict_bf16']}] against {ms['predict_f32']:.2f} "
          f"[{spread['predict_f32']}] ({4e3 / ms['predict_bf16']:.2f} against "
          f"{4e3 / ms['predict_f32']:.2f} crops/s); predict_batch {ms['batch_bf16']:.2f} ms "
          f"[{spread['batch_bf16']}] against {ms['batch_f32']:.2f} [{spread['batch_f32']}] "
          f"({12e3 / ms['batch_bf16']:.2f} against {12e3 / ms['batch_f32']:.2f} crops/s, "
          f"{ms['batch_f32'] / ms['batch_bf16']:.3f}x); K1 launches in the bf16 run "
          f"{launches} (= {k1_per_forward} x {ROUNDS} x 2 x 4: two buckets' warm-ups and "
          f"two replays each)", flush=True)

    counts, shares = {}, {}
    for dtype, est in (("float32", est32), ("bfloat16", est16)):
        name = f"{cfg16.MODEL.NAME} {dtype} predict_batch (3 images x 4 poses, {ROUNDS} rounds)"
        by_name = kernel_profile(torch, lambda: est.predict_batch(images, poses, keep), name,
                                 counts if dtype == "bfloat16" else None)
        shares[dtype] = conv_share(by_name, name)
        if dtype == "bfloat16":
            k1 = bf16_k1_profile(by_name, counts, name, k1_per_forward * ROUNDS)

    # one round on the predict_batch inputs: the first round's box is the
    # input condition's, so its heatmap pixel is known
    imgs = torch.from_numpy(np.stack(images))
    cnds = torch.from_numpy(np.stack(poses))
    one = {key: make_refine_fn(cfg, est.model, est.colors, n_iters=1)
           for key, cfg, est in (("f32", cfg32, est32), ("bf16", cfg16, est16))}
    got = {key: fn(imgs, cnds)[0].reshape(-1, joints, 2).cpu() for key, fn in one.items()}
    with exact_warps():
        got["bf16_exact"] = one["bf16"](imgs, cnds)[0].reshape(-1, joints, 2).cpu()
    img_w, img_h = (int(v) for v in cfg16.MODEL.IMAGE_SIZE)
    _, scale = joints2cs(cnds.reshape(-1, joints, 3), 640, 480,
                         float(cfg16.DATASET.BU_BBOX_MARGIN), img_w / img_h,
                         float(cfg16.TEST.SCALE_THRE))
    pix = scale * 200.0 / torch.tensor([float(v) for v in cfg16.MODEL.HEATMAP_SIZE])
    off = (got["bf16"] - got["f32"]).abs() / pix[:, None, :]
    agree = (off <= 1.0).all(-1).float().mean().item()
    drift = (got["bf16"] - got["bf16_exact"]).norm(dim=-1).flatten()
    med, p99, top = (drift.median().item(), drift.quantile(0.99).item(), drift.max().item())
    print(f"{label}: one round, bf16 vs f32 keypoints within one heatmap pixel for "
          f"{100 * agree:.1f}% of {off.shape[0] * joints} joints (random weights: a report); "
          f"decode drift of the TF32 warp and render against exact: median {med:.4f} px "
          f"(limit {WARP_DRIFT_PX}), p99 {p99:.4f}, max {top:.4f}", flush=True)
    if not med <= WARP_DRIFT_PX:
        raise AssertionError(f"{label}: TF32 warp drift {med} px")
    res = {"launches": launches, "wgmma_launches": wgmma, "ms": ms, "conv": shares, "k1": k1,
           "agree": agree, "drift_px": [med, p99, top]}

    if cpu_check:   # one bf16 forward on the card vs the CPU's
        x = torch.from_numpy(rng.randn(1, 6, img_h, img_w).astype(np.float32))
        cpu_model = copy.deepcopy(est16.model).cpu()
        # TransPose-H: the first encoder layer's input tokens and attention
        taps, handles = {"tokens": [], "attention": []}, []
        for model in (est16.model, cpu_model):
            if hasattr(model, "global_encoder"):
                layer = model.global_encoder.layers[0]
                handles += [layer.register_forward_pre_hook(
                                lambda m, args: taps["tokens"].append(args[0].float().cpu())),
                            layer.self_attn.register_forward_hook(
                                lambda m, args, out: taps["attention"].append(
                                    out.float().cpu()))]
        with torch.inference_mode():
            with module_dtypes(torch, est16.model) as card_dtypes, \
                    autocast("cuda", torch.bfloat16):
                card = est16.model(x.cuda()).float().cpu()
            with module_dtypes(torch, cpu_model) as cpu_dtypes, card_attention_rule(), \
                    autocast("cpu", torch.bfloat16):
                cpu16 = cpu_model(x).float()
            for handle in handles:
                handle.remove()
            cpu32 = cpu_model(x)
            # the control: torch's nn.Upsample back in the fuse layers (F7)
            ups = [m for m in est16.model.modules() if isinstance(m, Upsample)]
            for m in ups:
                m.__class__ = torch.nn.Upsample
            try:
                with module_dtypes(torch, est16.model) as control_dtypes, \
                        autocast("cuda", torch.bfloat16):
                    control = est16.model(x.cuda()).float().cpu()
            finally:
                for m in ups:
                    m.__class__ = Upsample
        peak = cpu32.abs().max().item()
        steps = (card - cpu16).abs().max().item() / peak / BF16_STEP
        noise = (cpu16 - cpu32).abs().max().item() / peak / BF16_STEP
        control_steps = (control - cpu16).abs().max().item() / peak / BF16_STEP
        for key, (got, want) in ((k, v) for k, v in taps.items() if v):
            gap = (got - want).abs().max().item() / want.abs().max().item() / BF16_STEP
            print(f"{label} encoder layer 0's {key}, card vs CPU: {gap:.3f} bf16 steps of "
                  f"their max {want.abs().max().item():.3e}", flush=True)
        ratio = BF16_FORWARD_RATIO[cfg16.MODEL.NAME]
        apart = sorted(n for n in cpu_dtypes if card_dtypes.get(n) != cpu_dtypes[n])
        control_apart = [n for n in cpu_dtypes if control_dtypes.get(n) != cpu_dtypes[n]]
        print(f"{label} forward card vs CPU, both bf16: {steps:.3f} bf16 steps of the peak "
              f"{peak:.3e}; the CPU's bf16 vs its f32: {noise:.3f} ({steps / noise:.2f}x, "
              f"limit {ratio}x); module output dtypes apart {len(apart)} of "
              f"{len(cpu_dtypes)}; the control with nn.Upsample (F7 undone, {len(ups)} "
              f"upsamples): {control_steps:.3f} steps ({control_steps / noise:.2f}x), dtypes "
              f"apart {len(control_apart)}", flush=True)
        if not steps <= ratio * noise:
            raise AssertionError(f"{label}: the card's bf16 forward disagrees with the CPU's")
        if apart or not control_apart:
            raise AssertionError(f"{label}: module dtypes card vs CPU apart {apart[:8]}; "
                                 f"the nn.Upsample control apart {control_apart[:8]}")
        res.update(forward_steps=steps, forward_noise_steps=noise,
                   control_steps=control_steps, control_dtypes_apart=len(control_apart))
    del est32, est16
    torch.cuda.empty_cache()
    return res


def graph_serving_phase(torch, np, fa, card: str) -> dict:
    """CoAM-W48 (CONFIG, 384x288, ROUNDS rounds, random weights from one
    .pth) served through per-bucket CUDA graphs, in f32 and in bf16.
    ``precompile=GRAPH_PRECOMPILE`` with ``max_compiles=2`` admits and
    captures GRAPH_KEYS at start-up (K1 counted in the two warm-ups a
    bucket, not in the capture); ``predict`` and ``predict_batch`` replay
    them (K1 counted k1 x ROUNDS a replay) and equal ``est.refine`` run
    eagerly on the same padded inputs bit for bit; a profile of one replay
    names K1's kernel as many times as the replay moved its counter;
    ms/image eager (the padded inputs through ``refine``, then to the host:
    the path before the graphs) and replayed,
    in turns (eager, replay, replay, eager), and a profile of each (the
    device's idle share); a 300x400 call with 3 poses, beyond the budget,
    padded up into (512, 640, 4).  Then the single-image program in f32 and
    the batched one in bf16 (GRAPH_EXPORT) exported at GRAPH_EXPORT_ROUNDS
    rounds and loaded
    (ExportedPoseEstimator on the card, replayed as graphs): the seconds to
    export and to load, and their largest difference from the live
    estimator of the same rounds (EXPORT_ATOL)."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.buckets import canonical, finish, pad_image, pad_rows, to_host
    from buctd_tpu_torch.serving import PoseEstimator
    from buctd_tpu_torch.serving_export import ExportedPoseEstimator

    def config(dtype):
        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(CONFIG), opts=["TPU.EVAL_DTYPE", dtype]))
        return cfg

    rng = np.random.RandomState(16)
    img, conds = sample_request(np, rng)
    batch = [sample_request(np, rng) for _ in range(3)]
    images, poses = [b[0] for b in batch], [b[1] for b in batch]
    small = sample_request(np, rng, h=300, w=400, poses=3)
    keep, k1_replay = float("-inf"), 2 * ROUNDS
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.manual_seed(16)
        model = get_model(config("float32"))
        randomize(torch, model)
        weights = Path(tmp) / "coam_w48_random.pth"
        torch.save(model.state_dict(), weights)
        del model
        for dtype in ("float32", "bfloat16"):
            label = f"CoAM-W48 {dtype} graphs"
            zero_k1(fa)                                  # the graphs' main path
            t0 = time.perf_counter()
            est = PoseEstimator(config(dtype), checkpoint=str(weights), refine_iters=ROUNDS,
                                max_compiles=2, precompile=GRAPH_PRECOMPILE)
            torch.cuda.synchronize()
            start_s = time.perf_counter() - t0
            captured = fa.flash_attention.launches
            graphs = est._graphs
            if est._compiled != GRAPH_KEYS or set(graphs.keys()) != GRAPH_KEYS:
                raise AssertionError(f"{label}: admitted {est._compiled}, captured "
                                     f"{graphs.keys()}")
            # two eager warm-ups a bucket, each ROUNDS forwards; the capture runs none
            want = 2 * len(GRAPH_KEYS) * k1_replay
            if captured != want:
                raise AssertionError(f"{label}: K1 launches at start-up {captured}, want {want}")

            def eager(image, cond):
                padded = pad_image(*canonical(image, cond), 512, 640, 4)
                preds, maxvals = est.refine(*(torch.from_numpy(x).cuda() for x in padded[:2]),
                                            img_wh=torch.from_numpy(padded[2]).cuda())
                return finish(to_host(preds, maxvals), cond.shape[0], keep)

            def eager_batch(imgs, conds_):
                padded = pad_rows([canonical(i, c) for i, c in zip(imgs, conds_)],
                                   4, 512, 640, 4)
                preds, maxvals = est.refine(*(torch.from_numpy(x).cuda() for x in padded[:2]),
                                            img_wh=torch.from_numpy(padded[2]).cuda())
                res_ = to_host(preds, maxvals)
                return [finish(res_[row], c.shape[0], keep) for row, c in enumerate(conds_)]

            out, outs = est.predict(img, conds, keep), est.predict_batch(images, poses, keep)
            padded_up = est.predict(*small, keep)
            launches = fa.flash_attention.launches   # the graphs' main path, read
            f32_k1_wgmma(fa, label)
            wgmma = (bf16_k1_launches(fa, label, launches) if dtype == "bfloat16"
                     else fa.flash_attention.wgmma_launches)
            if launches != captured + 3 * k1_replay:
                raise AssertionError(f"{label}: three replays moved K1's counter from "
                                     f"{captured} to {launches}, not by {3 * k1_replay}")
            if est._compiled != GRAPH_KEYS:
                raise AssertionError(f"{label}: the 300x400 call admitted {est._compiled}")
            same = [np.array_equal(out, eager(img, conds)),
                    all(np.array_equal(a, b) for a, b in
                        zip(outs, eager_batch(images, poses))),
                    np.array_equal(padded_up, eager(*small))]
            for o in [out, *outs, padded_up]:
                if not np.isfinite(o).all():
                    raise AssertionError(f"{label}: a replay gave non-finite poses")
            print(f"{label}: start-up with 2 buckets captured {start_s:.2f} s (K1 {captured} "
                  f"in the warm-ups, {launches} after three replays); replayed predict, "
                  f"predict_batch and the "
                  f"300x400 call padded up into (512, 640, 4) bit for bit equal to eager "
                  f"refine: {same}", flush=True)
            if not all(same):
                raise AssertionError(f"{label}: a replay differs from eager refine: {same}")

            kernel = F32_K1_KERNEL if dtype == "float32" else BF16_K1_KERNEL
            counts = {}
            ticks = fa.flash_attention.launches
            by_name = kernel_profile(torch, lambda: est.predict(img, conds, keep),
                                     f"{label}: one predict replay (4 poses, {ROUNDS} rounds)",
                                     counts)
            ticks = fa.flash_attention.launches - ticks
            k1_seen = sum(n for key, n in counts.items() if kernel in key)
            print(f"{label}: {kernel} launched {k1_seen} times in one replay, the counter "
                  f"moved {ticks} (want {k1_replay})", flush=True)
            if not k1_seen == ticks == k1_replay:
                raise AssertionError(f"{label}: K1 {k1_seen} launches in a replay, counted "
                                     f"{ticks}")
            profiles = {"replay": {"kernels_ms": sum(by_name.values())}}
            for name, fn in (("eager", lambda: eager(img, conds)),
                             ("batch_replay", lambda: est.predict_batch(images, poses, keep)),
                             ("batch_eager", lambda: eager_batch(images, poses))):
                by = kernel_profile(torch, fn, f"{label}: {name} (3 rounds)")
                profiles[name] = {"kernels_ms": sum(by.values())}

            calls = {key: [] for key in ("eager", "replay", "batch_eager", "batch_replay")}
            for _ in range(GRAPH_TURNS):
                for kind in ("eager", "replay", "replay", "eager"):
                    one = (lambda: eager(img, conds)) if kind == "eager" else (
                        lambda: est.predict(img, conds, keep))
                    many = (lambda: eager_batch(images, poses)) if kind == "eager" else (
                        lambda: est.predict_batch(images, poses, keep))
                    calls[kind].append(host_ms(one, 1))
                    calls[f"batch_{kind}"].append(host_ms(many, 1) / 3)
            ms = {key: statistics.median(v) for key, v in calls.items()}
            print(f"{label}, medians of {2 * GRAPH_TURNS} calls each in turns (eager, replay, "
                  f"replay, eager): predict {ms['eager']:.2f} ms/image eager, {ms['replay']:.2f} "
                  f"replayed ({ms['eager'] / ms['replay']:.3f}x); predict_batch (3 images x 4 "
                  f"poses) {ms['batch_eager']:.2f} ms/image eager, {ms['batch_replay']:.2f} "
                  f"replayed ({ms['batch_eager'] / ms['batch_replay']:.3f}x); spreads "
                  f"{ {k: (round(min(v), 2), round(max(v), 2)) for k, v in calls.items()} }; "
                  f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: "
                  f"{card}", flush=True)
            entry = {"start_s": start_s, "warmup_launches": captured, "launches": launches,
                     "wgmma_launches": wgmma, "ms": ms,
                     "profiles": profiles, "k1_replay": k1_replay, "same": same}

            # the exported programs, at GRAPH_EXPORT_ROUNDS rounds
            short = PoseEstimator(config(dtype), checkpoint=str(weights),
                                  refine_iters=GRAPH_EXPORT_ROUNDS)
            art = Path(tmp) / f"artifact_{dtype}"
            t0 = time.perf_counter()
            manifest = short.export([GRAPH_EXPORT[dtype]], str(art))
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = ExportedPoseEstimator(str(art))
            if len(GRAPH_EXPORT[dtype]) == 3:
                def serve(e):
                    return [e.predict(img, conds, keep)]
            else:
                def serve(e):
                    return e.predict_batch(images, poses, keep)
            got = serve(loaded)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            want_ = serve(short)
            gap = max(float(np.abs(a - b).max()) for a, b in zip(got, want_))
            bits = all(np.array_equal(a, b) for a, b in zip(got, want_))
            counts = {}
            ticks = fa.flash_attention.launches
            kernel_profile(torch, lambda: serve(loaded),
                           f"{label}: one replay of the exported program", counts)
            ticks = fa.flash_attention.launches - ticks
            k1_art = sum(n for key, n in counts.items() if kernel in key)
            print(f"{label}: exported {manifest['programs']} ({GRAPH_EXPORT_ROUNDS} round) in "
                  f"{export_s:.1f} s ({sum(f.stat().st_size for f in art.iterdir()) / 2**20:.1f} "
                  f"MiB), loaded and first calls (captures) {load_s:.1f} s; largest difference "
                  f"from the live estimator {gap:.3e} (limit {EXPORT_ATOL}), bit for bit "
                  f"{bits}; {kernel} {k1_art} launches in one replay of the exported program, "
                  f"the counter moved {ticks} (want 2)", flush=True)
            if not (gap <= EXPORT_ATOL and k1_art == ticks == 2):
                raise AssertionError(f"{label}: exported programs {gap} from the live "
                                     f"estimator, K1 {k1_art}, counted {ticks}")
            entry.update(export_s=export_s, load_s=load_s, export_gap=gap, export_bits=bits)
            res[dtype] = entry
            del est, short, loaded
            torch.cuda.empty_cache()
    return res


def write_synthetic_set(np, root: Path, n_images: int, people: int, seed: int = 0,
                        layout: str = "crowdpose"):
    """A training or test set in COCO format made from a seed: random 480x640
    JPEGs and ``people`` overlapping persons per image, all joints visible,
    in one of SYNTH_JOINTS' layouts: ``crowdpose`` (14 joints, a crowdIndex
    per image, no condition poses: the CoAM yaml's trainer synthesizes them),
    ``coco`` (17 joints, each person with ``cond_kpts``, its joints moved
    by N(0, 6 px), as a BU model's predictions: the TransPose-H yaml trains
    from them, SYNTHESIS_POSE false), or an evaluation set of ``ochuman``
    (17), ``fish`` (7), ``multimouse`` (12) or ``marmosets`` (15) joints
    without conditions (their rounds read a BU json).  Returns the
    annotation file's path."""
    import cv2

    joints = SYNTH_JOINTS[layout]
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
            pts = np.stack([rng.uniform(x0, x0 + w, joints), rng.uniform(y0, y0 + h, joints)], 1)
            ann = {"id": len(anns) + 1, "image_id": i + 1, "category_id": 1,
                   "iscrowd": 0, "num_keypoints": joints,
                   "keypoints": [float(c) for x, y in pts for c in (x, y, 2)],
                   "bbox": [float(x0), float(y0), float(w), float(h)],
                   "area": float(w * h)}
            if layout == "coco":
                cond = pts + rng.randn(joints, 2) * 6.0
                ann["cond_kpts"] = {"bu": [float(c) for x, y in cond for c in (x, y, 1.0)]}
            anns.append(ann)
    ann_file = root / f"{layout}_train.json"
    ann_file.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "person", "supercategory": "person",
                        "keypoints": [f"k{j}" for j in range(joints)], "skeleton": []}]}))
    return ann_file


def kernel_profile(torch, fn, label: str, counts: dict | None = None) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and the
    device's idle share of the call's wall time.  Returns ms by kernel name;
    ``counts``, a dict, receives the launches by kernel name."""
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
    if counts is not None:
        counts.update({e.key: e.count for e in events})
    return {e.key: e.self_device_time_total / 1e3 for e in events}


def conv_share(by_name: dict, label: str) -> dict:
    """The convolutions' (and their layout transposes') device time and share
    of a profile's kernel time (``kernel_profile``'s ms by name)."""
    total = sum(by_name.values())
    convs = {k: ms for k, ms in by_name.items()
             if any(n in k for n in CONV_NAMES) and "bn_" not in k}
    ms = sum(convs.values())
    top = sorted(convs, key=lambda k: -convs[k])[:3]
    print(f"convolutions in {label}: {ms:.3f} ms = {100 * ms / total:.1f}% of {total:.2f} ms "
          f"of kernel time; largest: {[k[:70] for k in top]}", flush=True)
    return {"conv_ms": ms, "total_ms": total, "share": ms / total}


def bf16_k1_profile(by_name: dict, counts: dict, label: str, want: int) -> dict:
    """K1 in a profiled bf16 run: ``want`` launches of its wgmma kernel
    (BF16_K1_KERNEL, by name), its time and share; raises where the run named
    the mma.sync, a SIMT or a 3xTF32 forward."""
    total = sum(by_name.values())
    tc = {k: ms for k, ms in by_name.items() if BF16_K1_KERNEL in k}
    launched = sum(counts[k] for k in tc)
    other = [k for k in by_name if any(n in k for n in (
        "flash_fwd_kernel", "flash_fwd_tf32_kernel", "flash_fwd_tc_kernel"))]
    ms = sum(tc.values())
    print(f"K1 in the profiled {label}: {BF16_K1_KERNEL} {launched} launches (want {want}), "
          f"{ms:.3f} ms = {100 * ms / total:.1f}% of {total:.2f} ms of kernel time; SIMT or "
          f"3xTF32 forward kernels seen: {other}", flush=True)
    if launched != want or other:
        raise AssertionError(f"the bf16 {label}'s K1 kernels: tensor cores {launched}, "
                             f"others {other}")
    return {"k1_ms": ms, "total_ms": total}


def f32_k1_profile(by_name: dict, label: str, group: str) -> dict:
    """K1's f32 wgmma kernel in a profiled f32 run (``kernel_profile``'s ms
    by kernel name): its time and share of the kernel time, and beside them
    the share K1 would have with the mma.sync kernel it replaced, its time
    scaled by that kernel's ratio at the kernel phase's shapes of ``group``
    (K1_MMA_RATIO).  Raises where the run named a SIMT or mma.sync forward,
    or no wgmma one."""
    total = sum(by_name.values())
    k1 = sum(ms for key, ms in by_name.items() if F32_K1_KERNEL in key)
    other = [key for key in by_name
             if "flash_fwd_kernel" in key or "flash_fwd_tf32_kernel" in key]
    ratio = K1_MMA_RATIO[group]
    old = k1 * ratio
    print(f"K1 in the profiled {label}: {F32_K1_KERNEL} {k1:.3f} ms = "
          f"{100 * k1 / total:.1f}% of {total:.2f} ms of kernel time; with the mma.sync "
          f"kernel ({ratio:.3f}x at these shapes in the kernel phase) {old:.3f} ms = "
          f"{100 * old / (total - k1 + old):.1f}% of {total - k1 + old:.2f} ms; SIMT or "
          f"mma.sync forward kernels seen: {other}", flush=True)
    if not k1 > 0 or other:
        raise AssertionError(f"the f32 {label}'s K1 kernels: wgmma {k1} ms, others {other}")
    return {"k1_ms": k1, "total_ms": total, "share": k1 / total,
            "mma_share": old / (total - k1 + old)}


def training_phase(torch, np, fa, tw, config=CONFIG, layout: str = "crowdpose",
                   k1_per_step: int = 2, repeat_from_random: bool = False,
                   extra_opts=(), full: bool = True) -> dict:
    """The trainer's main path at full width on ``config`` and a synthetic set
    of ``layout`` (with ``extra_opts``, e.g. TPU.DEVICE_SYNTHESIS True), K1, K2
    dq and K2 dk/dv launched ``k1_per_step`` times a step, and the step on a
    resident batch; with ``full``, then the loss over a repeated batch, from
    the trained model or, with ``repeat_from_random``, from N(0, 1/fan_in)
    weights (``randomize``), and a profile of one step.

    The trainer starts from the reference's N(0, 0.001) init, whose heatmaps
    are near 0: its loss starts at the zero-output floor, half the mean square
    of the targets (~0.002 for sigma-3 heatmaps at 96x72).  CoAM-W48 leaves
    its 10 steps above that floor and falls back to it over the repeated
    batch; TransPose-H leaves them at it (its LayerNorms keep the encoder's
    output at unit scale and the head's weights at 0.001), and 10 steps cannot
    fit a batch below it (measured 0.00193 to 0.00193 on an H100), so its
    repeated batch starts from random weights, far above the floor."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.train import run
    from buctd_tpu_torch.train.state import TrainStep, make_lr_schedule, make_optimizer

    with tempfile.TemporaryDirectory(prefix="buctd_train_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        ann = write_synthetic_set(np, root, SYNTH_IMAGES, SYNTH_PEOPLE, layout=layout)
        opts = ["TPU.DEVICE_PIPELINE", "True", "DATASET.TRAIN_IMAGE_DIR", str(root),
                "DATASET.TRAIN_ANNOTATION_FILE", str(ann), "OUTPUT_DIR", str(root / "out"),
                *extra_opts]
        print(f"training {config.stem} {list(extra_opts)}: synthetic {layout} set of "
              f"{SYNTH_IMAGES} images x {SYNTH_PEOPLE} people written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        for f in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv, tw.warp_resample,
                  tw.warp_resample_two_pass):
            f.launches = 0                                   # the main path's run
        zero_k1(fa)
        zero_k2(fa)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run.main(["--cfg", str(config), "--steps", str(TRAIN_STEPS), "--no-eval",
                        "--seed", "0", *opts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        f32_k1_wgmma(fa, f"training {config.stem} {' '.join(extra_opts)}".strip())
        launches = {"flash_fwd": fa.flash_attention.launches,
                    "flash_fwd_wgmma": fa.flash_attention.wgmma_launches,
                    "flash_fwd_mma": fa.flash_attention.mma_launches,
                    "flash_bwd_dq": fa.flash_bwd_dq.launches,
                    "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
                    "warp_resample": tw.warp_resample.launches,
                    "warp_resample_two_pass": tw.warp_resample_two_pass.launches,
                    **k2_by_kernel(fa)}
        steps = res["steps"]
        stats = res["stats"][0]
        losses = [float(m["loss"]) for st in res["stats"] for m in st["metrics"]]
        # the autocast step's K1 and K2 run the wgmma kernels; the model
        # summary's forward, outside autocast, f32 K1
        want = {"flash_fwd": k1_per_step * steps + res["summary"]["flash_calls"],
                "flash_fwd_wgmma": k1_per_step * steps, "flash_fwd_mma": 0,
                "flash_bwd_dq": k1_per_step * steps, "flash_bwd_dkv": k1_per_step * steps,
                "warp_resample": steps, "warp_resample_two_pass": 0,
                **k2_wgmma_want(k1_per_step * steps)}
        print(f"training run: {steps} steps of batch {TRAIN_BATCH} in {wall:.1f} s "
              f"(model build and data included); launches {launches}, expected {want} "
              f"(K1, dq, dkv: {k1_per_step} per step, and K1 in the model summary's "
              f"forward; K4: 1 per batch)", flush=True)
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        if steps != TRAIN_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"{steps} steps, losses {losses}")
        per_step = [d + s for d, s in zip(stats["data_wait_s"], stats["step_s"])]
        warm = slice(2, None)
        ms_step = statistics.median(per_step[warm]) * 1e3
        data_ms = statistics.median(stats["data_wait_s"][warm]) * 1e3
        dispatch_ms = statistics.median(stats["step_s"][warm]) * 1e3
        print(f"training {list(extra_opts)} steps 3-{steps}: median {ms_step:.2f} ms/step "
              f"({TRAIN_BATCH * 1e3 / ms_step:.2f} images/s); data wait median "
              f"{data_ms:.2f} ms/step, step dispatch median {dispatch_ms:.2f} ms/step; "
              f"peak memory {peak_gib:.2f} GiB; losses {[round(x, 6) for x in losses]}",
              flush=True)

        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(config), opts=opts))
        loader = DeviceLoader(get_dataset(cfg, is_train=True), cfg, num_workers=4, seed=1)
        batch = next(iter(loader))
        loader.close()
        model = res["model"]
        if repeat_from_random:
            randomize(torch, model)
        optimizer = make_optimizer(cfg, model)
        step = TrainStep(cfg, model, optimizer, make_lr_schedule(cfg, optimizer, 1000),
                         torch.Generator().manual_seed(1))
        if full:
            # the loss over a repeated batch, from the trained model
            rep = [step(batch)["loss"] for _ in range(10)]
            rep = [float(x) for x in rep]
            print(f"repeated batch, 10 steps"
                  f"{' from random weights' if repeat_from_random else ''}: "
                  f"losses {[round(x, 6) for x in rep]}", flush=True)
            if not (np.isfinite(rep).all() and rep[-1] < rep[0]):
                raise AssertionError(f"loss did not fall over a repeated batch: {rep}")
        else:
            step(batch)                                     # warm-up
        t0 = time.perf_counter()
        for _ in range(5):
            step(batch)
        torch.cuda.synchronize()
        device_ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"train step on a resident batch (no data wait): {device_ms:.2f} ms/step "
              f"({TRAIN_BATCH * 1e3 / device_ms:.2f} images/s); the loop ran "
              f"{ms_step / device_ms:.3f}x it", flush=True)
        if not full:
            return {"launches": launches, "ms_step": ms_step, "data_ms": data_ms,
                    "dispatch_ms": dispatch_ms, "resident_ms": device_ms,
                    "peak_gib": peak_gib}
        by_name = kernel_profile(torch, lambda: step(batch),
                                 f"one {config.stem} train step (batch {TRAIN_BATCH}, bf16)")
        # the autocast step's bf16 backward runs K2's wgmma kernels, neither
        # the mma.sync ones (flash_bwd_{dq,dkv}_tc_kernel) nor the SIMT ones
        # (flash_bwd_dq_kernel, flash_bwd_dkv_kernel)
        k2 = {kind: sum(ms for key, ms in by_name.items()
                        if f"flash_bwd_{kind}_wgmma_kernel" in key) for kind in ("dq", "dkv")}
        other = [key for key in by_name
                 if any(f"flash_bwd_{kind}_{k}" in key for kind in ("dq", "dkv")
                        for k in ("kernel", "tc_kernel"))]
        total = sum(by_name.values())
        print(f"K2 in the profiled step: flash_bwd_dq_wgmma_kernel {k2['dq']:.3f} ms, "
              f"flash_bwd_dkv_wgmma_kernel {k2['dkv']:.3f} ms, together "
              f"{100 * (k2['dq'] + k2['dkv']) / total:.1f}% of {total:.2f} ms of kernel time; "
              f"mma.sync or SIMT K2 kernels seen: {other}", flush=True)
        if not (k2["dq"] > 0 and k2["dkv"] > 0) or other:
            raise AssertionError(f"the bf16 step's K2 kernels: wgmma {k2}, others {other}")
        # and its bf16 forward runs K1's wgmma kernel, never the mma.sync
        # flash_fwd_tc_kernel or the SIMT flash_fwd_kernel
        k1_tc = sum(ms for key, ms in by_name.items() if BF16_K1_KERNEL in key)
        k1_simt = [key for key in by_name
                   if "flash_fwd_kernel" in key or "flash_fwd_tc_kernel" in key]
        print(f"K1 in the profiled step: {BF16_K1_KERNEL} {k1_tc:.3f} ms = "
              f"{100 * k1_tc / total:.1f}% of kernel time; mma.sync or SIMT K1 kernels seen: "
              f"{k1_simt}",
              flush=True)
        if not k1_tc > 0 or k1_simt:
            raise AssertionError(f"the bf16 step's K1 kernels: tensor-core {k1_tc} ms, "
                                 f"SIMT {k1_simt}")
    return {"launches": launches, "ms_step": ms_step, "data_ms": data_ms,
            "dispatch_ms": dispatch_ms, "resident_ms": device_ms, "peak_gib": peak_gib,
            "k1_profile_ms": k1_tc, "k2_profile_ms": k2["dq"] + k2["dkv"],
            "profile_ms": total}


def synth_mode_rates(np, samples, joints, area, sigmas):
    """good / jitter / far / zero rates of synthesized joints by distance from
    GT (tests/test_pose_synthesis.py's buckets): samples (R, B, J, 3), joints
    (B, J, 3), area (B,)."""
    var = (np.asarray(sigmas) * 2) ** 2
    ks50, ks85 = (np.sqrt(-2 * np.asarray(area)[:, None] * var * np.log(p))
                  for p in (0.50, 0.85))
    d = np.linalg.norm(samples[..., :2] - joints[None, ..., :2], axis=-1)
    zero = samples[..., 2] == 0
    return np.array([((d <= ks85) & ~zero).mean(), ((d > ks85) & (d <= ks50) & ~zero).mean(),
                     ((d > ks50) & ~zero).mean(), zero.mean()])


def synthesis_phase(torch, np) -> dict:
    """TPU.DEVICE_SYNTHESIS on CONFIG's synthetic CrowdPose set: plan_sample's
    host time a sample, split into the host sampler and the rest, and the rest
    alone with the card's poses (cond_override); the card sampler's device
    time a batch of TRAIN_BATCH (CUDA events on its stream), its CUDA kernel
    launches, and its wall time with the copy to pinned host memory
    (pipeline.py::device_synthesize_batch); its mode rates against the host
    sampler's on the same records, within SYNTH_RATE_ATOL."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.data import joints_dataset
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.data.pipeline import device_synthesize_batch, synthesis_generator
    from buctd_tpu_torch.data.pose_synthesis import CROWDPOSE_SIGMAS

    with tempfile.TemporaryDirectory(prefix="buctd_synth_") as tmp:
        root = Path(tmp)
        ann = write_synthetic_set(np, root, TRAIN_BATCH // SYNTH_PEOPLE, SYNTH_PEOPLE, seed=3)
        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(CONFIG), opts=[
            "TPU.DEVICE_PIPELINE", "True", "TPU.DEVICE_SYNTHESIS", "True",
            "DATASET.TRAIN_IMAGE_DIR", str(root), "DATASET.TRAIN_ANNOTATION_FILE", str(ann)]))
        ds = get_dataset(cfg, is_train=True)
        idxs = np.arange(TRAIN_BATCH)
        if len(ds.db) != TRAIN_BATCH:
            raise AssertionError(f"{len(ds.db)} records, not {TRAIN_BATCH}")

        # plan_sample with the host sampler, the sampler timed inside it
        host_sampler, in_sampler = joints_dataset.synthesize_pose, []

        def timed_sampler(*a, **k):
            t0 = time.perf_counter()
            out = host_sampler(*a, **k)
            in_sampler.append(time.perf_counter() - t0)
            return out

        joints_dataset.synthesize_pose = timed_sampler
        try:
            ds.plan_sample(0)                                   # warm-up (decode caches)
            in_sampler.clear()
            t0 = time.perf_counter()
            for i in idxs:
                ds.plan_sample(int(i))
            plan_ms = (time.perf_counter() - t0) / len(idxs) * 1e3
        finally:
            joints_dataset.synthesize_pose = host_sampler
        sampler_ms = sum(in_sampler) / len(idxs) * 1e3
        if len(in_sampler) != len(idxs):
            raise AssertionError(f"host sampler ran {len(in_sampler)} times for {len(idxs)}")

        loader = DeviceLoader(ds, cfg, batch_size=TRAIN_BATCH, num_workers=4, seed=0)
        try:
            seeds = [ds.synthesis_seed(ds.db[i]) for i in idxs]
            args = (np.stack([s[0] for s in seeds]), np.stack([s[1] for s in seeds]),
                    [s[2] for s in seeds], np.array([s[3] for s in seeds]))
            for _ in range(3):
                conds = device_synthesize_batch(loader, idxs)          # warm-up
            t0 = time.perf_counter()
            for i in idxs:
                ds.plan_sample(int(i), cond_override=conds[i])
            rest_ms = (time.perf_counter() - t0) / len(idxs) * 1e3

            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                device_synthesize_batch(loader, idxs)
                walls.append((time.perf_counter() - t0) * 1e3)
            wall_ms = statistics.median(walls)
            stream = loader.synth_stream
            times = []
            with torch.cuda.stream(stream):
                for k in range(10):
                    gen = synthesis_generator(loader.device, 1, k)
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record(stream)
                    loader.device_synth(gen, *args)
                    end.record(stream)
                    end.synchronize()
                    times.append(start.elapsed_time(end))
            device_ms = statistics.median(times)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                device_synthesize_batch(loader, idxs)
                torch.cuda.synchronize()
            launches = sum(e.count for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA)

            # mode rates: the host sampler twice over the records, the card's
            # SYNTH_CARD_REPS batches, against each record's GT
            joints = np.stack([np.asarray(ds.db[i]["joints_3d"], np.float64) for i in idxs])
            area = args[3]
            host_rng = np.random.RandomState(5)
            host = np.stack([[host_sampler(cfg, s[0], s[1], s[2], s[3], 0, rng=host_rng)
                              for s in seeds] for _ in range(SYNTH_HOST_REPS)])
            card = np.stack([loader.device_synth(synthesis_generator(loader.device, 2, k),
                                                 *args).cpu().numpy()
                             for k in range(SYNTH_CARD_REPS)])
        finally:
            loader.close()
    rates = {name: synth_mode_rates(np, v, joints, area, CROWDPOSE_SIGMAS)
             for name, v in (("host", host), ("card", card))}
    print(f"plan_sample a sample (host clock, {len(idxs)} records): {plan_ms:.3f} ms with "
          f"the host sampler, of which the sampler {sampler_ms:.3f} ms and the rest "
          f"{plan_ms - sampler_ms:.3f}; with the card's poses (cond_override) {rest_ms:.3f} "
          f"ms", flush=True)
    print(f"card sampler, batch {TRAIN_BATCH} ({cfg.MODEL.NUM_JOINTS} joints, P_max 8, N 500): "
          f"device time {device_ms:.4f} ms (median of 10, CUDA events on its stream), "
          f"{launches} CUDA kernel launches a batch; wall {wall_ms:.4f} ms with the copy "
          f"to the host (median of 10; the host sampler {sampler_ms * TRAIN_BATCH:.1f} ms "
          f"a batch on one core)", flush=True)
    print(f"mode rates good/jitter/far/zero: host {np.round(rates['host'], 4).tolist()} "
          f"({SYNTH_HOST_REPS} x {TRAIN_BATCH} poses), card "
          f"{np.round(rates['card'], 4).tolist()} ({SYNTH_CARD_REPS} x {TRAIN_BATCH}); "
          f"max gap {np.abs(rates['host'] - rates['card']).max():.4f} (limit "
          f"{SYNTH_RATE_ATOL})", flush=True)
    if not (np.isfinite(card).all() and np.abs(rates["host"] - rates["card"]).max()
            <= SYNTH_RATE_ATOL and rates["card"][2] > 0.01):
        raise AssertionError(f"card sampler rates {rates}")
    return {"plan_ms": plan_ms, "sampler_ms": sampler_ms, "rest_ms": rest_ms,
            "device_ms": device_ms, "wall_ms": wall_ms, "launches": launches,
            "rates": rates}


def options_phase(torch, np, fa, tw, k1_per_step: int = 2) -> dict:
    """OPTION_STEPS-step CoAM-W48 runs of the trainer with each of OPTIONS
    (and TPU.DEVICE_SYNTHESIS, so the loader keeps up), each with finite
    losses and K1, K2 dq, K2 dk/dv launched ``k1_per_step`` times and K4
    once a loader batch; for TPU.REMAT also the resident step with and
    without remat, its ms, peak memory and K1/K2 launches."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.train import run
    from buctd_tpu_torch.train.state import TrainStep, make_lr_schedule, make_optimizer

    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv, tw.warp_resample)
    out = {}
    with tempfile.TemporaryDirectory(prefix="buctd_options_") as tmp:
        root = Path(tmp)
        ann = write_synthetic_set(np, root, OPTION_STEPS * TRAIN_BATCH // SYNTH_PEOPLE,
                                  SYNTH_PEOPLE, seed=4)
        base = ["TPU.DEVICE_PIPELINE", "True", "TPU.DEVICE_SYNTHESIS", "True",
                "DATASET.TRAIN_IMAGE_DIR", str(root), "DATASET.TRAIN_ANNOTATION_FILE",
                str(ann), "OUTPUT_DIR", str(root / "out"), "AUTO_RESUME", "False"]
        for name, opts in OPTIONS.items():
            for f in counters:
                f.launches = 0                               # this option's run
            zero_k1(fa)
            zero_k2(fa)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = run.main(["--cfg", str(CONFIG), "--steps", str(OPTION_STEPS), "--no-eval",
                            "--seed", "0", *base, *opts])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # K1, dq, dkv, K4; then dq and dkv by kernel (k2_by_kernel)
            launches = [f.launches for f in counters] + list(k2_by_kernel(fa).values())
            f32_k1_wgmma(fa, f"training option {name}")
            losses = [float(m["loss"]) for st in res["stats"] for m in st["metrics"]]
            st = res["stats"][0]
            per_step = [d + s for d, s in zip(st["data_wait_s"], st["step_s"])][1:]
            ms = statistics.median(per_step) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            # K1 also in the model summary's forward (utils/summary.py)
            want = ([k1_per_step * OPTION_STEPS + res["summary"]["flash_calls"]]
                    + [k1_per_step * OPTION_STEPS] * 2 + [OPTION_STEPS]
                    + list(k2_wgmma_want(k1_per_step * OPTION_STEPS).values()))
            print(f"option {name} {opts}: {res['steps']} steps in {wall:.1f} s (model build "
                  f"included), steps 2-{OPTION_STEPS} median {ms:.2f} ms/step, peak memory "
                  f"{peak:.2f} GiB; launches K1, dq, dkv, K4, dq and dkv by kernel (wgmma, "
                  f"mma.sync) {launches} (expected {want}); "
                  f"losses {[round(x, 6) for x in losses]}", flush=True)
            if (res["steps"] != OPTION_STEPS or not np.isfinite(losses).all()
                    or launches != want):
                raise AssertionError(f"option {name}: {res['steps']} steps, losses {losses}, "
                                     f"launches {launches} != {want}")
            out[name] = {"ms_step": ms, "peak_gib": peak, "launches": launches}
            if name != "remat":
                del res
                continue
            # the resident step with and without remat, on the trained model,
            # in turns (off, on, on, off, ...)
            cfg = default_config()
            update_config(cfg, types.SimpleNamespace(cfg=str(CONFIG), opts=base + opts))
            loader = DeviceLoader(get_dataset(cfg, is_train=True), cfg, num_workers=4, seed=1)
            batch = next(iter(loader))
            loader.close()
            model = res["model"]
            del res
            optimizer = make_optimizer(cfg, model)
            step = TrainStep(cfg, model, optimizer, make_lr_schedule(cfg, optimizer, 1000),
                             torch.Generator().manual_seed(1))
            times = {"": [], "modules": []}
            peaks, k12s = {}, {}
            for r in range(REMAT_ROUNDS):
                mode = ("", "modules")[(r + r // 2) % 2]            # off, on, on, off
                model.remat = mode
                step(batch)                                         # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = [f.launches for f in counters[:3]]
                t0 = time.perf_counter()
                for _ in range(OPTION_STEPS):
                    step(batch)
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) / OPTION_STEPS * 1e3)
                k12s[mode] = [(f.launches - b) // OPTION_STEPS for f, b in zip(counters[:3],
                                                                               before)]
                peaks[mode] = torch.cuda.max_memory_allocated() / 2**30
            for mode in ("", "modules"):
                ms_res, k12 = statistics.mean(times[mode]), k12s[mode]
                out["remat"][f"resident_{mode or 'off'}"] = {
                    "ms": ms_res, "peak_gib": peaks[mode], "k1_k2_per_step": k12}
                print(f"resident step, REMAT {mode or 'off'}: {ms_res:.2f} ms/step (turns "
                      f"{[round(t, 2) for t in times[mode]]}), peak memory {peaks[mode]:.2f} "
                      f"GiB (max_memory_allocated), K1, dq, dkv launches a step {k12}: "
                      f"CoAM's attention sits outside the remat units, as in JAX, so the "
                      f"recompute launches no K1 or K2 of its own", flush=True)
                if k12 != [k1_per_step] * 3:
                    raise AssertionError(f"REMAT {mode!r}: K1/K2 launches a step {k12}")
            del model, optimizer, step
            torch.cuda.empty_cache()
    return out


def dense_attention_grads(q, k, v, dout, scale):
    """dq, dk, dv of softmax(q k^T * scale) v by autograd in float64."""
    import torch

    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    out = torch.softmax(q @ k.transpose(1, 2) * scale, dim=-1) @ v
    return torch.autograd.grad(out, (q, k, v), dout.double())


def card_vs_cpu_step(torch, np, fa) -> dict:
    """One f32 (TF32 off), dropout-0 train step at batch 1 on the card vs the
    same step on the CPU, from the reference init the trainer starts from,
    with the CPU's float64 step as exact arithmetic: the loss, the BN running
    statistics after the forward, the gradients (see STEP_GRAD_RATIO), over
    the whole model and over the CoAM position attention alone, and each K2
    call of the card's step against float64 on its own inputs.  Returns the
    launches of f32 K2 (3xTF32) in the card's step, its main path."""
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
        if name == "card":                   # f32 K2's main path: this step
            zero_k2(fa)
        try:
            loss.backward()
        finally:
            fa.flash_attention_backward = backward
        if name == "card":
            torch.cuda.synchronize()
            launches = {"flash_bwd_dq": fa.flash_bwd_dq.launches,
                        "flash_bwd_dkv": fa.flash_bwd_dkv.launches, **k2_by_kernel(fa)}
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
    # f32 K2 (d = 48 and 96) on its wgmma kernels
    if len(k2_calls) != 2 or launches != {"flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                                          **k2_wgmma_want(0, f32=2)}:
        raise AssertionError(f"{len(k2_calls)} flash backward calls in the step, not 2; "
                             f"K2 launches {launches}")
    if not (abs(l_card - l_cpu) <= STEP_LOSS_RTOL * abs(l_cpu)
            and d_card <= STEP_GRAD_RATIO * d_cpu and a_card <= STEP_GRAD_RATIO * a_cpu
            and k2_err <= STEP_K2_RTOL and bn_ok):
        raise AssertionError("the card's train step disagrees with the CPU's")
    return launches


def ab_ms(old, new, iters: int) -> tuple:
    """Device times of two versions of one function in turns (old, new, new,
    old), each the mean of ``iters`` launches: the A/B inside one call."""
    a1, b1, b2, a2 = (timed_ms(f, iters) for f in (old, new, new, old))
    return (a1 + a2) / 2, (b1 + b2) / 2


def chunk_errors(got, plain, bh: int, chunk: int, *tensors, check=None) -> tuple:
    """``got`` (a tuple of (BH, ...) kernel outputs) against the plain
    version ``plain(bh0, *rows)`` over BH chunks starting at row bh0 (the
    plain versions hold (chunk, L, L) f32 tensors; bh0 gives them the dropout
    mask of their rows), calling ``check(got_rows, want)`` on each chunk;
    returns the largest |got - plain| and the largest |plain| of each output."""
    err, top = [0.0] * len(got), [0.0] * len(got)
    for i in range(0, bh, chunk):
        want = plain(i, *(t[i:i + chunk] for t in tensors))
        for j, (g, w) in enumerate(zip(got, want)):
            if check is not None:
                check(g[i:i + chunk], w)
            err[j] = max(err[j], (g[i:i + chunk] - w).abs().max().item())
            top[j] = max(top[j], w.abs().max().item())
    return err, top


def check_chunked(torch, got, plain, bh: int, chunk: int, *tensors,
                  atol=KERNEL_ATOL, rtol=KERNEL_RTOL) -> list:
    """``chunk_errors`` with every chunk held to atol/rtol; returns the
    largest |got - plain| of each output."""
    return chunk_errors(got, plain, bh, chunk, *tensors, check=functools.partial(
        torch.testing.assert_close, atol=atol, rtol=rtol))[0]


def check_fwd_chunked(torch, fa, got, q, k, v, scale, p, seed, chunk) -> tuple:
    """A forward kernel's (out, lse) at dropout p against the plain forward
    over BH chunks (each chunk with its rows' mask): f32 at KERNEL_ATOL/RTOL.
    bf16, from one logits tensor a chunk: lse at KERNEL_ATOL/RTOL, out within
    K1_BF16_RTOL x max |out| of the plain forward, rows of exp(s' - lse)
    within ROWSUM_ATOL of 1, and out within K1_BF16_TILED_RMS (relative rms)
    of ``fa.forward_tile_rounded``, whose unrounded control must miss by
    more.
    Returns ([max |out err|, max |lse err|], notes)."""
    bh = q.shape[0]
    if q.dtype == torch.float32:
        def plain(i, a, b, c):
            return fa.flash_attention_reference(a, b, c, scale, p, seed, bh0=i)

        return check_chunked(torch, got, plain, bh, chunk, q, k, v), {}
    err, top, gap = [0.0, 0.0], [0.0, 0.0], 0.0
    sq = {"ref": 0.0, "kernel": 0.0, "control": 0.0}
    for i in range(0, bh, chunk):
        rows = slice(i, i + chunk)
        s, _ = fa._logits(q[rows], k[rows], scale)
        keep = fa.dropout_multiplier(seed, *s.shape, p, s.device, i) if p > 0.0 else None
        want = fa.forward_from_logits(s, v[rows], keep, True)
        for j, (g, w) in enumerate(zip(got, want)):
            err[j] = max(err[j], (g[rows] - w).abs().max().item())
            top[j] = max(top[j], w.abs().max().item())
        del want
        gap = max(gap, (torch.exp(s - got[1][rows, :, None]).sum(-1) - 1).abs().max().item())
        tiled, control = fa.forward_tile_rounded(s, v[rows], keep)
        del s, keep
        sq["ref"] += tiled.square().sum().item()
        sq["kernel"] += (got[0][rows] - tiled).square().sum().item()
        sq["control"] += (control - tiled).square().sum().item()
        del tiled, control
    rel = err[0] / top[0]
    tiled_rms, control_rms = ((sq[key] / sq["ref"]) ** 0.5 for key in ("kernel", "control"))
    text = (f" ({rel:.3e} of max, limit {K1_BF16_RTOL:.0e}; vs the tile rounding rms "
            f"{tiled_rms:.3e}, limit {K1_BF16_TILED_RMS:.0e}, unrounded control "
            f"{control_rms:.3e}; row sums within {gap:.3e} of 1)")
    if not (err[1] <= KERNEL_ATOL + KERNEL_RTOL * top[1] and rel <= K1_BF16_RTOL
            and gap <= ROWSUM_ATOL and tiled_rms <= K1_BF16_TILED_RMS < control_rms):
        raise AssertionError(f"bf16 forward: lse {err[1]:.3e}, out{text}")
    return err, {"rel": rel, "rowsum": gap, "tiled": tiled_rms, "control": control_rms,
                 "text": text}


def kvres_kernel_phase(torch, F, fa) -> dict:
    """K1' and K2' vs their plain versions and vs K1/K2, and their times.

    K1': MAIN_CASES, EVAL_CASES, a ragged case and d = 47 in f32 and bf16
    against the plain version (check_fwd_chunked: K1's gates) and K1 (bit for
    bit: the same tensor-core kernels with a deeper ring); timed at
    EVAL_CASES beside K1 (the eval path's sums are the f32 ones).  At
    TRAIN_CASES (BH 32, the training path's shapes) in f32 and bf16 with
    dropout 0.1: K1' (out, lse, and in bf16 the row sums) and K2' (dq, dk, dv,
    from K1''s lse) against the plain versions over BH chunks (f32
    BWD_ATOL/RTOL, bf16 K2_BF16_RTOL x max |grad| of the rounding plain
    backward) and against K1/K2 (bit for bit in both dtypes: KVRES_GAP); K1'
    and K2' timed at BH 32 in bf16 and f32 beside K1 and K2.  Then KVRES_ODD_CASE in bf16
    under BUCTD_FLASH_KVRES=1: the dispatch launches K1', which with K2' meets
    the same gates."""
    import os

    from buctd_tpu_torch.tools.bench_exp2 import sm_clock_hz

    clock = sm_clock_hz()
    gen = torch.Generator(device="cuda").manual_seed(2)
    res = {k: 0.0 for k in ("fwd_err", "dq_err", "dkv_err", "fwd_k1_gap", "bwd_k2_gap",
                            "gap_exact", "fwd_bf16_rel", "bwd_bf16_rel", "rowsum")}
    for key in ("fwd", "k1", "fwd_plain", "fwd_library", "fwd_bound", "fwd_ops"):
        res[f"{key}_ms"] = 0.0

    def against_k1_k2(got, old):
        """gaps of K1'/K2' outputs to K1's/K2's, bit for bit (the same
        kernels)"""
        gaps = [(g - w).abs().max().item() for g, w in zip(got, old)]
        res["gap_exact"] = max(res["gap_exact"], *gaps)
        if max(gaps) > KVRES_GAP:
            raise AssertionError(f"K1'/K2' vs K1/K2 (the same kernels): {gaps} > {KVRES_GAP}")
        return max(gaps)

    def check_fwd_kv(out, lse, q, k, v, scale, p, seed, chunk):
        errs, note = check_fwd_chunked(torch, fa, (out, lse), q, k, v, scale, p, seed, chunk)
        res["fwd_err"] = max(res["fwd_err"], *errs)
        res["fwd_bf16_rel"] = max(res["fwd_bf16_rel"], note.get("rel", 0.0))
        res["rowsum"] = max(res["rowsum"], note.get("rowsum", 0.0))
        return errs, note

    def check_bwd_kv(grads, q, k, v, do, lse, delta, scale, p, seed, chunk):
        def plain(i, a, b, c, g, l, e):
            return fa.flash_attention_backward_reference(a, b, c, g, l, e, scale, p, seed,
                                                         bh0=i)

        args = (q.shape[0], chunk, q, k, v, do, lse, delta)
        if q.dtype == torch.float32:
            errs = check_chunked(torch, grads, plain, *args, atol=BWD_ATOL, rtol=BWD_RTOL)
            text = f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}"
        else:
            errs, top = chunk_errors(grads, plain, *args)
            rel = [e / t for e, t in zip(errs, top)]
            res["bwd_bf16_rel"] = max(res["bwd_bf16_rel"], *rel)
            if max(rel) > K2_BF16_RTOL:
                raise AssertionError(f"bf16 K2' vs the rounding plain backward: {rel}")
            text = (f"dq {rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e} of max |grad| (limit "
                    f"{K2_BF16_RTOL:.0e})")
        res["dq_err"] = max(res["dq_err"], errs[0])
        res["dkv_err"] = max(res["dkv_err"], errs[1], errs[2])
        return text

    for bh, lq, lk, d in MAIN_CASES + EVAL_CASES + OTHER_CASES[2:]:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q = torch.randn(bh, lq, d, device="cuda", generator=gen).to(dtype)
            k = torch.randn(bh, lk, d, device="cuda", generator=gen).to(dtype)
            v = torch.randn(bh, lk, d, device="cuda", generator=gen).to(dtype)
            scale = d ** -0.5
            out, lse = fa.flash_attention_kvres(q, k, v, scale)
            torch.cuda.synchronize()
            chunk = PLAIN_BH.get(lq, bh)
            errs, note = check_fwd_kv(out, lse, q, k, v, scale, 0.0, 0, chunk)
            gap = against_k1_k2((out, lse), fa.flash_attention(q, k, v, scale))
            res["fwd_k1_gap"] = max(res["fwd_k1_gap"], gap)
            print(f"K1' flash_fwd_kvres ({bh}, {lq}, {lk}, {d}) {name}: vs plain out "
                  f"{errs[0]:.3e}{note.get('text', '')} lse {errs[1]:.3e}, vs K1 {gap:.3e}",
                  flush=True)
            if (bh, lq, lk, d) in EVAL_CASES:
                k1_ms, kv_ms = ab_ms(lambda: fa.flash_attention(q, k, v, scale),
                                     lambda: fa.flash_attention_kvres(q, k, v, scale), 10)
                plain_ms = timed_ms(lambda: chunked(
                    lambda a, b, c: fa.flash_attention_reference(a, b, c, scale),
                    bh, chunk, q, k, v), 2)
                q4, k4, v4 = q[:, None], k[:, None], v[:, None]
                lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, scale=scale), 10)
                bound, by = flash_bound_ms(bh, lq, lk, d, name, clock)
                print(f"  eval shape {name}: K1' {kv_ms:.4f} ms, K1 {k1_ms:.4f} ms "
                      f"(K1'/K1 {kv_ms / k1_ms:.3f}), plain {plain_ms:.4f} ms, sdpa "
                      f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}), K1' "
                      f"{4.0 * bh * lq * lk * d / kv_ms / 1e9:.2f} TFLOP/s", flush=True)
                if dtype == torch.float32:
                    for key, val in (("fwd", kv_ms), ("k1", k1_ms), ("fwd_plain", plain_ms),
                                     ("fwd_library", lib_ms), ("fwd_bound", bound),
                                     ("fwd_ops", bound if by == "operations" else 0.0)):
                        res[f"{key}_ms"] += val
                del q4, k4, v4
            del q, k, v, out, lse
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
            before = k2_by_kernel(fa, True)
            dq = fa.flash_bwd_dq_kvres(q, k, v, do, lse, delta, scale, DROPOUT, seed)
            dk, dv = fa.flash_bwd_dkv_kvres(q, k, v, do, lse, delta, scale, DROPOUT, seed)
            torch.cuda.synchronize()
            # K2' on K2's wgmma kernels of each dtype (d = 48, 96)
            moved = {key: n - before[key] for key, n in k2_by_kernel(fa, True).items()}
            low = int(dtype == torch.bfloat16)
            if moved != k2_wgmma_want(low, True, 1 - low):
                raise AssertionError(f"K2' ({bh}, {lq}, {d}) {dtype}: launches by kernel {moved}")
            fwd_errs, note = check_fwd_kv(out, lse, q, k, v, scale, DROPOUT, seed, chunk)
            bwd_text = check_bwd_kv((dq, dk, dv), q, k, v, do, lse, delta, scale, DROPOUT,
                                    seed, chunk)
            fwd_gap = against_k1_k2((out, lse), fa.flash_attention(q, k, v, scale, DROPOUT,
                                                                   seed))
            k2 = (fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, DROPOUT, seed),
                  *fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, DROPOUT, seed))
            bwd_gap = against_k1_k2((dq, dk, dv), k2)
            res["fwd_k1_gap"] = max(res["fwd_k1_gap"], fwd_gap)
            if dtype == torch.float32:
                res["bwd_k2_gap"] = max(res["bwd_k2_gap"], bwd_gap)
            print(f"K1'+K2' check ({bh}, {lq}, {d}) {str(dtype)[6:]} dropout {DROPOUT}: vs "
                  f"plain out {fwd_errs[0]:.3e}{note.get('text', '')} lse {fwd_errs[1]:.3e}, "
                  f"{bwd_text}; K1' vs K1 {fwd_gap:.3e}, K2' vs K2 {bwd_gap:.3e}", flush=True)
            del q, k, v, do, out, lse, delta, dq, dk, dv, k2
            torch.cuda.empty_cache()

    for name in ("train_fwd", "train_k1", "dq", "dkv"):
        res[f"{name}_ms"] = 0.0
    for name in ("dq", "dkv"):
        for key in ("k2_ms", "bound_ms", "ops_ms", "f32_ms", "f32_k2_ms"):
            res[f"{name}_{key}"] = 0.0
    for bh, lq, d in TRAIN_CASES:
        q, k, v = (torch.randn(bh, lq, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        do = torch.randn(bh, lq, d, device="cuda", generator=gen)
        scale = d ** -0.5
        out, lse = fa.flash_attention(q, k, v, scale, DROPOUT, seed)
        delta = (do * out).sum(-1)
        args = (q, k, v, do, lse, delta, scale, DROPOUT, seed)
        k1_ms, kv_ms = ab_ms(lambda: fa.flash_attention(q, k, v, scale, DROPOUT, seed),
                             lambda: fa.flash_attention_kvres(q, k, v, scale, DROPOUT, seed),
                             5)
        k2_dq, kv_dq = ab_ms(lambda: fa.flash_bwd_dq(*args),
                             lambda: fa.flash_bwd_dq_kvres(*args), 5)
        k2_dkv, kv_dkv = ab_ms(lambda: fa.flash_bwd_dkv(*args),
                               lambda: fa.flash_bwd_dkv_kvres(*args), 5)
        res["train_fwd_ms"] += kv_ms
        res["train_k1_ms"] += k1_ms
        bounds = {}
        for kind, kv_t, k2_t in (("dq", kv_dq, k2_dq), ("dkv", kv_dkv, k2_dkv)):
            # the same function as K2's: the same floors
            ops_ms = max(flash_floors_ms(bh, lq, d, kind, clock, DROPOUT).values())
            bounds[kind] = max(ops_ms, bwd_bound_ms(bh, lq, d, 2, kind)[0])
            res[f"{kind}_ms"] += kv_t
            res[f"{kind}_k2_ms"] += k2_t
            res[f"{kind}_bound_ms"] += bounds[kind]
            res[f"{kind}_ops_ms"] += ops_ms
        print(f"K1'/K2' ({bh}, {lq}, {d}) bf16 dropout {DROPOUT}: K1' {kv_ms:.4f} ms (K1 "
              f"{k1_ms:.4f}, K1'/K1 {kv_ms / k1_ms:.3f}); dq {kv_dq:.4f} ms (K2 {k2_dq:.4f}, "
              f"K2'/K2 {kv_dq / k2_dq:.3f}, bound {bounds['dq']:.4f}), dkv {kv_dkv:.4f} ms "
              f"(K2 {k2_dkv:.4f}, K2'/K2 {kv_dkv / k2_dkv:.3f}, bound {bounds['dkv']:.4f}); "
              f"plain versions and sdpa: the train kernels line", flush=True)
        # f32 K2' (K2's 3xTF32 kernels with the deeper ring) beside f32 K2 in
        # turns, on the widened operands; SDPA's f32 backward and the f32
        # bounds: the tools phase
        qf, kf, vf = q.float(), k.float(), v.float()
        outf, lsef = fa.flash_attention(qf, kf, vf, scale, DROPOUT, seed)
        argf = (qf, kf, vf, do, lsef, (do * outf).sum(-1), scale, DROPOUT, seed)
        f32 = {"dq": ab_ms(lambda: fa.flash_bwd_dq(*argf),
                           lambda: fa.flash_bwd_dq_kvres(*argf), 2),
               "dkv": ab_ms(lambda: fa.flash_bwd_dkv(*argf),
                            lambda: fa.flash_bwd_dkv_kvres(*argf), 2)}
        for kind, (k2_t, kv_t) in f32.items():
            res[f"{kind}_f32_ms"] += kv_t
            res[f"{kind}_f32_k2_ms"] += k2_t
        print(f"K2' ({bh}, {lq}, {d}) f32 dropout {DROPOUT}: dq {f32['dq'][1]:.4f} ms (K2 "
              f"{f32['dq'][0]:.4f}), dkv {f32['dkv'][1]:.4f} ms (K2 {f32['dkv'][0]:.4f})",
              flush=True)
        del q, k, v, do, out, lse, delta, args, qf, kf, vf, outf, lsef, argf
        torch.cuda.empty_cache()

    # an odd head dim in bf16 under the switch: the dispatch takes K1', and K1'
    # and K2' load the 94-byte rows through registers
    bh, lq, d = KVRES_ODD_CASE
    q, k, v = (torch.randn(bh, lq, d, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    do = torch.randn(bh, lq, d, device="cuda", generator=gen)
    scale = d ** -0.5
    counters = (fa.flash_attention, fa.flash_attention_kvres)
    before = [f.launches for f in counters]
    os.environ["BUCTD_FLASH_KVRES"] = "1"
    try:
        out, lse = fa.flash_attention(q, k, v, scale, DROPOUT, seed)
    finally:
        del os.environ["BUCTD_FLASH_KVRES"]
    delta = (do * out).sum(-1)
    k2_before = k2_by_kernel(fa, True)
    grads = (fa.flash_bwd_dq_kvres(q, k, v, do, lse, delta, scale, DROPOUT, seed),
             *fa.flash_bwd_dkv_kvres(q, k, v, do, lse, delta, scale, DROPOUT, seed))
    torch.cuda.synchronize()
    launched = [f.launches - b for f, b in zip(counters, before)]
    if launched != [0, 1]:
        raise AssertionError(f"odd-d bf16 under BUCTD_FLASH_KVRES=1: K1, K1' launched {launched}")
    # d = 47 is no multiple of 8: K2' on the bf16 mma.sync kernels
    moved = {key: n - k2_before[key] for key, n in k2_by_kernel(fa, True).items()}
    if moved != {key: int(key.endswith("_mma") and "_f32_" not in key) for key in moved}:
        raise AssertionError(f"odd-d bf16 K2': launches by kernel {moved}")
    chunk = PLAIN_BH.get(lq, bh)
    fwd_errs, note = check_fwd_kv(out, lse, q, k, v, scale, DROPOUT, seed, chunk)
    bwd_text = check_bwd_kv(grads, q, k, v, do, lse, delta, scale, DROPOUT, seed, chunk)
    print(f"K1'+K2' odd head dim ({bh}, {lq}, {d}) bf16 dropout {DROPOUT} under "
          f"BUCTD_FLASH_KVRES=1 (94-byte rows): vs plain out {fwd_errs[0]:.3e}"
          f"{note.get('text', '')} lse {fwd_errs[1]:.3e}, {bwd_text}", flush=True)
    del q, k, v, do, out, lse, delta, grads
    torch.cuda.empty_cache()
    print(f"A/B sums: K1' {res['fwd_ms']:.4f} ms vs K1 {res['k1_ms']:.4f} ms (f32, eval "
          f"shapes); K1' {res['train_fwd_ms']:.4f} vs K1 {res['train_k1_ms']:.4f} ms, K2' dq "
          f"{res['dq_ms']:.4f} vs K2 {res['dq_k2_ms']:.4f} ms, dkv {res['dkv_ms']:.4f} vs "
          f"{res['dkv_k2_ms']:.4f} ms (bf16, training shapes); f32 K2' dq "
          f"{res['dq_f32_ms']:.4f} vs K2 {res['dq_f32_k2_ms']:.4f} ms, dkv "
          f"{res['dkv_f32_ms']:.4f} vs {res['dkv_f32_k2_ms']:.4f} ms; largest gap to K1 "
          f"{res['fwd_k1_gap']:.3e}, f32 K2' to K2 {res['bwd_k2_gap']:.3e}, of all "
          f"{res['gap_exact']:.3e} (limit {KVRES_GAP})", flush=True)
    return res


def write_smooth_images(np, root: Path, ann_file: Path, seed: int = 3) -> None:
    """The images of ``ann_file`` again under ``root``, smooth: per channel
    two crossed sinusoids of 40-80 px periods around mid-grey, at most ~18
    levels a pixel.  There 1/64 px of sampling error stays under a level,
    while a quarter-pixel misplacement moves a crop by several."""
    import cv2

    rng = np.random.RandomState(seed)
    for im in json.loads(Path(ann_file).read_text())["images"]:
        h, w = im["height"], im["width"]
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        chans = [127.5 + 55 * np.sin(2 * np.pi * xs / rng.uniform(40, 80) + rng.uniform(0, 6.3))
                 + 55 * np.sin(2 * np.pi * ys / rng.uniform(40, 80) + rng.uniform(0, 6.3))
                 for _ in range(3)]
        cv2.imwrite(str(root / im["file_name"]), np.rint(np.stack(chans, -1)).astype(np.uint8))


def loaders_input_gap(np, first_batch) -> dict:
    """The host Loader's and the device loader's 'input' for one batch
    (``first_batch(kind)`` -> the batch of 'host' or 'device'):
    tests/test_device_pipeline.py's eval measures, the RGB channels' largest
    gap, a sample's largest mean gap and the share within 0.02, and the
    condition channels' largest gap."""
    hb, db = first_batch("host"), first_batch("device")
    err = (hb["input"][:, :3] - db["input"][:, :3]).abs()
    return {"max": err.max().item(), "mean": err.flatten(1).mean(1).max().item(),
            "share": (err < 0.02).float().mean().item(),
            "cond": (hb["input"][:, 3:] - db["input"][:, 3:]).abs().max().item(),
            "batches": (hb, db)}


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
        ann = write_synthetic_set(np, root, EVAL_IMAGES, SYNTH_PEOPLE, seed=11)
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

        counted = (fa.flash_attention, fa.flash_attention_kvres, tw.warp_resample,
                   tw.warp_resample_two_pass)
        for f in counted:
            f.launches = 0                                   # the main path's run
        zero_k1(fa)
        t0 = time.perf_counter()
        out = valid_run.main(["--cfg", str(CONFIG), *opts, "OUTPUT_DIR", str(root / "out"),
                              "TEST.REFINE_ITERS", str(EVAL_ROUNDS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f32_k1_wgmma(fa, "pose_hrnet_coam evaluation")
        launches = {"flash_fwd": fa.flash_attention.launches,
                    "flash_fwd_kvres": fa.flash_attention_kvres.launches,
                    "warp_resample": tw.warp_resample.launches,
                    "warp_resample_two_pass": tw.warp_resample_two_pass.launches}
        batches = -(-EVAL_IMAGES * SYNTH_PEOPLE // EVAL_BATCH)
        # K1 also in the model summary's forward (utils/summary.py)
        want = {"flash_fwd": 2 * batches * EVAL_ROUNDS + out["summary"]["flash_calls"],
                "flash_fwd_kvres": 0,
                "warp_resample": batches * EVAL_ROUNDS, "warp_resample_two_pass": 0}
        print(f"evaluation run: {EVAL_ROUNDS} rounds in {wall:.1f} s (model build and "
              f"data included); launches {launches}, expected {want} (K1: 2, K4: 1 per "
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
        # the GT and round 0's results, for inference_phase's bin_evaluate
        keep = Path(tempfile.mkdtemp(prefix="buctd_eval_results_"))
        res["files"] = (keep / ann.name, keep / "round0_results.json")
        res["files"][0].write_bytes(ann.read_bytes())
        res["files"][1].write_bytes(Path(out["rounds"][0]["results"]).read_bytes())

        # the same evaluation, one round, under BUCTD_FLASH_KVRES=1
        os.environ["BUCTD_FLASH_KVRES"] = "1"
        try:
            for f in counted:
                f.launches = 0
            zero_k1(fa)
            kv = valid_run.main(["--cfg", str(CONFIG), *opts,
                                 "OUTPUT_DIR", str(root / "out_kvres")])
            kv_launches = {"flash_fwd": fa.flash_attention.launches,
                           "flash_fwd_kvres": fa.flash_attention_kvres.launches}
            f32_k1_wgmma(fa, "pose_hrnet_coam evaluation under BUCTD_FLASH_KVRES=1")
        finally:
            del os.environ["BUCTD_FLASH_KVRES"]
        r = kv["rounds"][0]
        print(f"evaluation under BUCTD_FLASH_KVRES=1, one round: AP {r['AP']!r} (K1's "
              f"round 0: {out['rounds'][0]['AP']!r}), {r['crops'] / r['loop_s']:.2f} "
              f"crops/s; launches {kv_launches}", flush=True)
        if kv_launches != {"flash_fwd": 0,
                           "flash_fwd_kvres": 2 * batches + kv["summary"]["flash_calls"]}:
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
        label = f"one validate step (batch {EVAL_BATCH}, flip test: 64 crops, f32)"
        by_name = kernel_profile(torch, lambda: step(batch), label)
        res["profile"] = f32_k1_profile(by_name, "validate step", "eval")
        res["conv_f32"] = conv_share(by_name, label)

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

        # bf16 (TPU.EVAL_DTYPE bfloat16): one round, and one under
        # BUCTD_FLASH_KVRES=1 whose results are K1's bit for bit; first one
        # bf16 validate step, so the timed round pays no first cuDNN calls
        bf16_opts = [*opts, "TPU.EVAL_DTYPE", "bfloat16"]
        cfg16 = default_config()
        update_config(cfg16, types.SimpleNamespace(cfg=str(CONFIG), opts=bf16_opts))
        step16 = make_validate_step(cfg16, model, ds.flip_pairs, ds.kpt_colors)
        step16(batch)
        torch.cuda.synchronize()
        runs = {}
        for kv in ("0", "1"):
            os.environ["BUCTD_FLASH_KVRES"] = kv
            try:
                for f in counted:
                    f.launches = 0                           # the bf16 main path's run
                zero_k1(fa)
                run = valid_run.main(["--cfg", str(CONFIG), *bf16_opts,
                                      "OUTPUT_DIR", str(root / f"out_bf16_kvres{kv}")])
                f32_k1_wgmma(fa, "pose_hrnet_coam bf16 evaluation" + " under "
                             "BUCTD_FLASH_KVRES=1" * (kv == "1"))
                got = {"flash_fwd": fa.flash_attention.launches,
                       "flash_fwd_kvres": fa.flash_attention_kvres.launches,
                       "flash_fwd_wgmma": (fa.flash_attention.wgmma_launches
                                           + fa.flash_attention_kvres.wgmma_launches),
                       "flash_fwd_mma": (fa.flash_attention.mma_launches
                                         + fa.flash_attention_kvres.mma_launches),
                       "warp_resample": tw.warp_resample.launches}
            finally:
                del os.environ["BUCTD_FLASH_KVRES"]
            r = run["rounds"][0]
            calls = 2 * batches + run["summary"]["flash_calls"]
            # the bf16 validate steps' K1 (or K1') calls run the wgmma kernel, the
            # model summary's f32 forward the 3xTF32 one
            want = {"flash_fwd": calls * (kv == "0"), "flash_fwd_kvres": calls * (kv == "1"),
                    "flash_fwd_wgmma": 2 * batches, "flash_fwd_mma": 0,
                    "warp_resample": batches}
            rows = Path(r["results"]).read_text()
            print(f"bf16 evaluation, one round{' under BUCTD_FLASH_KVRES=1' * (kv == '1')}: AP "
                  f"{r['AP']!r} (f32's round 0: {out['rounds'][0]['AP']!r}), {r['crops']} "
                  f"crops, eval loop {r['loop_s']:.3f} s = {r['crops'] / r['loop_s']:.2f} "
                  f"crops/s (f32's round 0: "
                  f"{out['rounds'][0]['crops'] / out['rounds'][0]['loop_s']:.2f}); loss "
                  f"{r['loss']:.6f} acc {r['acc']:.3f}; launches {got}, expected {want}",
                  flush=True)
            if got != want or len(json.loads(rows)) != r["crops"] \
                    or not (np.isfinite(r["AP"]) and 0.0 <= r["AP"] <= 1.0):
                raise AssertionError(f"bf16 evaluation: launches {got}, AP {r['AP']}")
            runs[kv] = (r, rows, got)
        if runs["1"][1] != runs["0"][1] or runs["1"][0]["AP"] != runs["0"][0]["AP"]:
            raise AssertionError("bf16 evaluation: K1' results differ from K1's")
        res["bf16"] = {"ap": runs["0"][0]["AP"], "launches": runs["0"][2]["flash_fwd"],
                       "wgmma_launches": runs["0"][2]["flash_fwd_wgmma"],
                       "kvres_wgmma_launches": runs["1"][2]["flash_fwd_wgmma"],
                       "warp_launches": runs["0"][2]["warp_resample"],
                       "kvres_launches": runs["1"][2]["flash_fwd_kvres"],
                       "crops_s": runs["0"][0]["crops"] / runs["0"][0]["loop_s"],
                       "f32_crops_s": out["rounds"][0]["crops"] / out["rounds"][0]["loop_s"]}
        hm16 = step16(batch)[5]
        os.environ["BUCTD_FLASH_KVRES"] = "1"
        try:
            hm16_kv = step16(batch)[5]
        finally:
            del os.environ["BUCTD_FLASH_KVRES"]
        res["bf16"].update(bf16_vs_f32(torch, hm16, hm_k1, "CoAM-W48 eval batch"))
        if hm16.dtype != torch.bfloat16 or not torch.equal(hm16_kv, hm16):
            raise AssertionError(f"bf16 eval batch: {hm16.dtype}, K1' heatmaps equal K1's: "
                                 f"{torch.equal(hm16_kv, hm16)}")
        print("bf16 eval batch: K1' heatmaps equal K1's bit for bit", flush=True)
        label = f"one bf16 validate step (batch {EVAL_BATCH}, flip test: 64 crops)"
        counts = {}
        by_name = kernel_profile(torch, lambda: step16(batch), label, counts)
        res["bf16"].update(profile=bf16_k1_profile(by_name, counts, label, 2),
                           conv=conv_share(by_name, label))
    return res


def bf16_vs_f32(torch, hm16, hm32, label: str) -> dict:
    """One batch's bf16 heatmaps against the f32 ones of the same weights:
    the largest gap in bf16 steps of the f32 peak, and the share of maps
    whose argmax agrees (random weights: a report)."""
    steps = ((hm16.float() - hm32).abs().max() / hm32.abs().max()).item() / BF16_STEP
    same = (hm16.float().flatten(2).argmax(-1) == hm32.flatten(2).argmax(-1)).float().mean()
    print(f"{label}: bf16 vs f32 heatmaps max |diff| {steps:.3f} bf16 steps of the f32 peak "
          f"{hm32.abs().max().item():.3e}; argmax equal in {100 * same.item():.1f}% of the "
          f"maps", flush=True)
    return {"hm_steps": steps, "argmax_same": same.item()}


def transpose_eval_phase(torch, np, fa, tw) -> dict:
    """One TransPose-H evaluation round at full width through
    ``valid.run.main`` on a synthetic COCO test set (TP_EVAL_IMAGES images x
    SYNTH_PEOPLE people, 17 joints) from a BU-prediction json, with
    N(0, 1/fan_in) weights saved as a .pth and the yaml's own test settings
    (batch 32, TEST.FLIP_TEST false): a results json with one entry per crop,
    a finite AP in [0, 1], K1 launched TP_LAYERS times and K4 once a batch;
    then a profile of one validate step, K1's share of its kernel time."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.core.function import make_validate_step
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.valid import run as valid_run

    with tempfile.TemporaryDirectory(prefix="buctd_tp_eval_") as tmp:
        root = Path(tmp)
        ann = write_synthetic_set(np, root, TP_EVAL_IMAGES, SYNTH_PEOPLE, seed=13,
                                  layout="coco")
        bu = write_bu_predictions(np, ann, root)
        torch.manual_seed(7)
        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(TRANSPOSE_CONFIG), opts=[]))
        model = get_model(cfg)
        randomize(torch, model)
        weights = root / "random_weights.pth"
        torch.save(model.state_dict(), weights)
        del model
        opts = ["TPU.DEVICE_PIPELINE", "True", "DATASET.TEST_IMAGE_DIR", str(root),
                "DATASET.TEST_ANNOTATION_FILE", str(ann), "TEST.COCO_BBOX_FILE", str(bu),
                "TEST.MODEL_FILE", str(weights), "PRINT_FREQ", "100",
                "OUTPUT_DIR", str(root / "out")]
        for f in (fa.flash_attention, tw.warp_resample):
            f.launches = 0                                   # the main path's run
        zero_k1(fa)
        t0 = time.perf_counter()
        out = valid_run.main(["--cfg", str(TRANSPOSE_CONFIG), *opts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f32_k1_wgmma(fa, "transpose_h evaluation")
        launches = {"flash_fwd": fa.flash_attention.launches,
                    "warp_resample": tw.warp_resample.launches}
        batch_size = int(cfg.TEST.BATCH_SIZE_PER_GPU)
        batches = -(-TP_EVAL_IMAGES * SYNTH_PEOPLE // batch_size)
        want = {"flash_fwd": TP_LAYERS * batches + out["summary"]["flash_calls"],
                "warp_resample": batches}
        r = out["rounds"][0]
        rows = json.loads(Path(r["results"]).read_text())
        print(f"transpose_h evaluation: one round in {wall:.1f} s (model build and data "
              f"included): AP {r['AP']!r}, {r['crops']} crops, results json {len(rows)} "
              f"entries; eval loop {r['loop_s']:.3f} s = {r['crops'] / r['loop_s']:.2f} "
              f"crops/s (host clock), evaluate {r['evaluate_s']:.3f} s; launches {launches}, "
              f"expected {want} (K1: {TP_LAYERS}, K4: 1 per batch of {batch_size} crops)",
              flush=True)
        if len(out["rounds"]) != 1 or len(rows) != r["crops"] \
                or r["crops"] != TP_EVAL_IMAGES * SYNTH_PEOPLE:
            raise AssertionError(f"{len(rows)} results for {r['crops']} crops")
        if not (np.isfinite(r["AP"]) and 0.0 <= r["AP"] <= 1.0):
            raise AssertionError(f"AP {r['AP']}")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")

        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(TRANSPOSE_CONFIG), opts=opts))
        ds = get_dataset(cfg, is_train=False)
        loader = DeviceLoader(ds, cfg, num_workers=4)
        batch = next(iter(loader))
        loader.close()
        step = make_validate_step(cfg, out["model"], ds.flip_pairs, ds.kpt_colors)
        label = f"one transpose_h validate step (batch {batch_size}, no flip, f32)"
        by_name = kernel_profile(torch, lambda: step(batch), label)
        profile = f32_k1_profile(by_name, "transpose_h validate step", "tp_eval")
        conv_f32 = conv_share(by_name, label)

        # one round in bf16 (TPU.EVAL_DTYPE bfloat16), after one bf16
        # validate step that pays the first cuDNN calls
        bf16_opts = [*opts[:-2], "OUTPUT_DIR", str(root / "out_bf16"),
                     "TPU.EVAL_DTYPE", "bfloat16"]
        cfg16 = default_config()
        update_config(cfg16, types.SimpleNamespace(cfg=str(TRANSPOSE_CONFIG), opts=bf16_opts))
        step16 = make_validate_step(cfg16, out["model"], ds.flip_pairs, ds.kpt_colors)
        step16(batch)
        torch.cuda.synchronize()
        for f in (fa.flash_attention, tw.warp_resample):
            f.launches = 0                                   # the bf16 main path's run
        zero_k1(fa)
        run = valid_run.main(["--cfg", str(TRANSPOSE_CONFIG), *bf16_opts])
        f32_k1_wgmma(fa, "transpose_h bf16 evaluation")
        got = {"flash_fwd": fa.flash_attention.launches,
               "flash_fwd_wgmma": fa.flash_attention.wgmma_launches,
               "flash_fwd_mma": fa.flash_attention.mma_launches,
               "warp_resample": tw.warp_resample.launches}
        want = {"flash_fwd": TP_LAYERS * batches + run["summary"]["flash_calls"],
                "flash_fwd_wgmma": TP_LAYERS * batches, "flash_fwd_mma": 0,
                "warp_resample": batches}
        r16 = run["rounds"][0]
        print(f"transpose_h bf16 evaluation, one round: AP {r16['AP']!r} (f32: {r['AP']!r}), "
              f"{r16['crops']} crops, eval loop {r16['loop_s']:.3f} s = "
              f"{r16['crops'] / r16['loop_s']:.2f} crops/s (f32: "
              f"{r['crops'] / r['loop_s']:.2f}); launches {got}, expected {want}", flush=True)
        if got != want or r16["crops"] != r["crops"] \
                or not (np.isfinite(r16["AP"]) and 0.0 <= r16["AP"] <= 1.0):
            raise AssertionError(f"transpose_h bf16 evaluation: launches {got}, AP {r16['AP']}")
        bf16 = bf16_vs_f32(torch, step16(batch)[5], step(batch)[5], "transpose_h eval batch")
        label = f"one transpose_h bf16 validate step (batch {batch_size}, no flip)"
        counts = {}
        by_name = kernel_profile(torch, lambda: step16(batch), label, counts)
        bf16.update(ap=r16["AP"], launches=got["flash_fwd"], wgmma_launches=got["flash_fwd_wgmma"],
                    warp_launches=got["warp_resample"],
                    crops_s=r16["crops"] / r16["loop_s"],
                    profile=bf16_k1_profile(by_name, counts, label, TP_LAYERS),
                    conv=conv_share(by_name, label))
    return {"launches": launches, "ap": r["AP"], "crops_s": r["crops"] / r["loop_s"],
            "profile": profile, "conv_f32": conv_f32, "bf16": bf16}


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
        ann = write_synthetic_set(np, root, 24, SYNTH_PEOPLE, seed=3)
        for f in counted.values():
            f.launches = 0
        zero_k1(fa)
        zero_k2(fa)
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
    launches = {**{k: f.launches for k, f in counted.items()}, **k2_by_kernel(fa, True)}
    f32_k1_wgmma(fa, "training under BUCTD_FLASH_KVRES=1")
    losses = [float(m["loss"]) for st in res["stats"] for m in st["metrics"]]
    n = 2 * KVRES_TRAIN_STEPS
    want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_fwd_kvres": n + res["summary"]["flash_calls"],
            "flash_bwd_dq_kvres": n, "flash_bwd_dkv_kvres": n, **k2_wgmma_want(n, True)}
    print(f"training under BUCTD_FLASH_KVRES=1: {res['steps']} steps, losses "
          f"{[round(x, 6) for x in losses]}; launches {launches}, expected {want}",
          flush=True)
    if launches != want or res["steps"] != KVRES_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"kv-resident training: launches {launches}, losses {losses}")
    return launches


def fused_block_phase(torch, fb) -> dict:
    """(a) K5 vs its plain version at the four W48 branch geometries: batch
    K5_CHECK_BATCH in f32 and bf16 (the tensor-core kernels, and the SIMT
    kernel of the A/B in both), where the one-pass tf32 control of f32
    (``fb.fused_block_tf32``, TF32_CONTROL_PASSES) must miss the f32 gate,
    and the benchmark's own inputs (batch 128, bf16, bench_block's scales
    and seed: the tensors the tools phase times); the plain version's time
    on those, summed over the branches; the long-K check (K5_LONG_K) in both
    dtypes.  K5's and cuDNN's times come from the tools phase."""
    from buctd_tpu_torch.tools import bench_block as bb
    from buctd_tpu_torch.tools import bench_block_variants as bv

    gen = torch.Generator(device="cuda").manual_seed(6)
    res = {"err_f32": 0.0, "err_bf16": 0.0, "err_simt": 0.0, "err_simt_f32": 0.0,
           "plain_ms": 0.0, "control": float("inf")}

    def check(label, args, tol, key, fn=fb.fused_basic_block):
        got = fn(*args)
        torch.cuda.synchronize()
        want = fb.fused_basic_block_plain(*args)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        err = (got.float() - want.float()).abs().max().item()
        res[key] = max(res[key], err)
        print(f"K5 {label}: max_abs_err {err:.3e} (output max "
              f"{want.float().abs().max().item():.3f}, limit atol = rtol = {tol:.3g}), "
              f"{(got != want).float().mean().item() * 100:.3f}% of outputs differ", flush=True)
        return want

    for _, h, w, c in bb.BRANCHES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = torch.randn(K5_CHECK_BATCH, h, w, c, device="cuda", generator=gen)
            ws = [torch.randn(3, 3, c, c, device="cuda", generator=gen) / (3 * c ** 0.5)
                  for _ in range(2)]
            bs = [torch.randn(c, device="cuda", generator=gen) * 0.1 for _ in range(2)]
            args = [t.to(dtype) for t in (x, *ws, *bs)]
            shape = f"({K5_CHECK_BATCH}, {h}, {w}, {c}) {name}"
            f32 = dtype == torch.float32
            want = check(f"tensor cores {shape}", args, K5_ATOL[name],
                         "err_f32" if f32 else "err_bf16")
            check(f"SIMT {shape}", args, K5_ATOL[name], "err_simt_f32" if f32 else "err_simt",
                  fb.fused_basic_block_simt)
            if f32:
                one = fb.fused_block_tf32(*args, passes=TF32_CONTROL_PASSES)
                miss = ((one - want).abs() - K5_ATOL[name] * (1 + want.abs())).max().item()
                res["control"] = min(res["control"], miss)
                print(f"  the {TF32_CONTROL_PASSES}-pass tf32 control misses the f32 gate by "
                      f"{miss:.3e}", flush=True)
                if not miss > 0.0:
                    raise AssertionError(f"f32 K5's one-pass control meets the gate {shape}")
                del one
            del x, ws, bs, args, want
    res["long_k"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        args = bv.random_block(gen, *K5_LONG_K, dtype=dtype)
        want = bv.reference64(*args)
        acc = {"tc": bv.accuracy(fb.fused_basic_block(*args), want),
               "simt": bv.accuracy(fb.fused_basic_block_simt(*args), want)}
        res["long_k"][name] = acc
        (tmax, trms, tshare), (smax, srms, sshare) = acc["tc"], acc["simt"]
        print(f"K5 long K {K5_LONG_K} {name} vs float64: tensor cores max {tmax:.4e} rms "
              f"{trms:.4e}, {tshare:.4%} of outputs off the rounded chain; SIMT max {smax:.4e} "
              f"rms {srms:.4e}, {sshare:.4%} (limit {K5_LONG_K_RATIO:g} x the SIMT kernel's "
              f"max and rms{', and share' if name == 'bfloat16' else ''})", flush=True)
        if not (tmax <= K5_LONG_K_RATIO * smax and trms <= K5_LONG_K_RATIO * srms
                and (dtype == torch.float32 or tshare <= K5_LONG_K_RATIO * sshare)):
            raise AssertionError(f"{name} K5's long-K error {acc}")
        del args, want
    res["plain_f32_ms"] = 0.0
    for dtype, key in ((torch.bfloat16, "plain_ms"), (torch.float32, "plain_f32_ms")):
        name = str(dtype).split(".")[-1]
        gen = torch.Generator(device="cuda").manual_seed(0)   # bench_block's default seed
        for _, h, w, c in bb.BRANCHES:
            args = bb.branch_inputs(gen, bb.BATCH, h, w, c, dtype)
            check(f"tensor cores ({bb.BATCH}, {h}, {w}, {c}) {name}, the benchmark's inputs",
                  args, K5_ATOL[name], "err_bf16" if name == "bfloat16" else "err_f32")
            plain_ms = timed_ms(lambda: fb.fused_basic_block_plain(*args), 3)
            print(f"  K5 plain version ({bb.BATCH}, {h}, {w}, {c}) {name}: {plain_ms:.4f} ms",
                  flush=True)
            res[key] += plain_ms
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
    """(e) The port's tools, reduced: bench_block --simt (cuDNN, K5 on the
    tensor cores and K5's SIMT kernel in turns) in bf16 and f32 (cuDNN with
    TF32 off), bench_flash_bwd --dtype float32 (f32 K2 in 3xTF32, its SIMT
    kernels and SDPA's f32 backward in turns), bench_exp2 and bench_stem;
    the launch counts of K5 (both dtypes), K5's SIMT A/B and K6 over these
    runs (their main path); K5 faster than its SIMT kernel at every branch
    in both dtypes, f32 K2 faster than its SIMT kernels at both shapes."""
    from buctd_tpu_torch.tools import bench_block, bench_exp2, bench_flash_bwd, bench_stem

    fb.fused_basic_block.launches = 0                    # the main path's run
    fb.fused_basic_block_simt.launches = 0
    ex.exp_chain.launches = 0
    chain = ["--chain", str(TOOL_CHAIN), "--rounds", str(TOOL_ROUNDS)]
    block = bench_block.main(["--simt", *chain])
    bf16_launches = fb.fused_basic_block.launches
    block_f32 = bench_block.main(["--simt", "--dtype", "float32", *chain])
    exp = bench_exp2.main(["--rounds", str(TOOL_ROUNDS)])
    launches = {"fused_basic_block": fb.fused_basic_block.launches,
                "fused_basic_block_simt": fb.fused_basic_block_simt.launches,
                "exp_throughput": ex.exp_chain.launches}
    k2 = bench_flash_bwd.main(["--dtype", "float32", "--rounds", "1", "--only"])
    stem = bench_stem.main([str(TOOL_STEM_BATCH), "--steps", "3", "--rounds",
                            str(TOOL_ROUNDS)])
    per_run = 4 * (TOOL_CHAIN * TOOL_ROUNDS + 1)
    want = {"fused_basic_block": 2 * per_run, "fused_basic_block_simt": 2 * per_run,
            "exp_throughput": len(ex.VARIANTS) * bench_exp2.OUTER * (2 * TOOL_ROUNDS + 2)}
    print(f"tools: launches {launches}, expected {want} (K5: 4 branches x (chain x rounds "
          f"+ warm-up), bf16 and f32, the SIMT A/B both; K6: 3 variants x "
          f"{bench_exp2.OUTER} x (2 timings x rounds + 2 to take the host's issue time))",
          flush=True)
    if launches != want or bf16_launches != per_run:
        raise AssertionError(f"tool launch counts {launches} != {want}")
    for name, res in (("bf16", block), ("f32", block_f32)):
        slower = {k: v for k, v in res.items() if not v["fused_ms"] < v["simt_ms"]}
        if slower:
            raise AssertionError(f"{name} K5 no faster than its SIMT kernel: {slower}")
    # f32 K2 at the training shapes with dropout 0.1, the training path's
    k2 = {shape: by_p[DROPOUT] for shape, by_p in k2.items()}
    slower = {s: r for s, r in k2.items() if not r["shipped"]["dq_ms"] + r["shipped"]["dkv_ms"]
              < r["simt"]["dq_ms"] + r["simt"]["dkv_ms"]}
    if slower:
        raise AssertionError(f"f32 K2 no faster than its SIMT kernels: {slower}")
    # every step is one MUFU.EX2 at least, and the bound takes the card's
    # highest SM clock: a chain faster than the bound skipped steps
    fast = {v: exp[v]["ms"] for v in ex.VARIANTS if not exp[v]["ms"] >= exp["bound_ms"]}
    if fast:
        raise AssertionError(f"K6 faster than its SFU bound {exp['bound_ms']:.4f} ms: {fast}")
    ratio = {k: round(v["cudnn_ms"] / v["fused_ms"], 4) for k, v in block.items()}
    ratio32 = {k: round(v["cudnn_ms"] / v["fused_ms"], 4) for k, v in block_f32.items()}
    print(f"tools: cuDNN/K5 by branch, bf16 {ratio}, f32 {ratio32}; bench_stem "
          f"b{TOOL_STEM_BATCH}: preNet {stem[TOOL_STEM_BATCH]['prenet_ms']:.4f} -> fused "
          f"{stem[TOOL_STEM_BATCH]['fused_prenet_ms']:.4f} ms, forward "
          f"{stem[TOOL_STEM_BATCH]['forward_ms']:.4f} -> "
          f"{stem[TOOL_STEM_BATCH]['fused_forward_ms']:.4f} ms", flush=True)
    if not stem[TOOL_STEM_BATCH]["rel_gap"] <= PRENET_FWD_RTOL:
        raise AssertionError("bench_stem: fused forward disagrees with the canonical one")
    return {"launches": launches, "f32_launches": launches["fused_basic_block"] - bf16_launches,
            "block": block, "block_f32": block_f32, "k2_f32": k2, "exp": exp, "stem": stem}


def zero_k1(fa) -> None:
    """K1's and K1''s launch counts, all of them and by kernel, to 0: the
    start of a main path's run."""
    for f in (fa.flash_attention, fa.flash_attention_kvres):
        for name in K1_COUNTS:
            setattr(f, name, 0)


def f32_k1_wgmma(fa, label: str, model_path: bool = True) -> int:
    """On a path run since ``zero_k1``: its f32 K1 and K1' launches (all
    launches less the bf16 kernels'; the model summary's forward is f32 in
    every run) and those of the f32 wgmma kernel, recorded under ``label``
    in F32_WGMMA_PATHS (added to what it holds).  On a model path (d = 48,
    96 and 112 at full width) every f32 launch must have run the wgmma
    kernel and none the mma.sync one; a narrow model's (``model_path``
    False: the orbax fixture's d = 4 and 8) are recorded as they split.
    Returns the wgmma kernel's launches."""
    f32 = wgmma = mma = 0
    for f in (fa.flash_attention, fa.flash_attention_kvres):
        f32 += f.launches - f.wgmma_launches - f.mma_launches
        wgmma, mma = wgmma + f.f32_wgmma_launches, mma + f.f32_mma_launches
    if wgmma + mma != f32 or (model_path and mma):
        raise AssertionError(f"{label}: {f32} f32 K1 launches, {wgmma} on the f32 wgmma "
                             f"kernel, {mma} on the mma.sync one")
    if f32:
        got = F32_WGMMA_PATHS.setdefault(label, {"f32_k1": 0, "f32_wgmma": 0, "f32_mma": 0})
        got["f32_k1"] += f32
        got["f32_wgmma"] += wgmma
        got["f32_mma"] += mma
    return wgmma


def zero_k2(fa) -> None:
    """K2's and K2''s launch counts, all of them and by kernel, to 0: the
    start of a main path's run."""
    for f in (fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dq_kvres, fa.flash_bwd_dkv_kvres):
        f.launches = 0
        for k in K2_KINDS:
            setattr(f, f"{k}_launches", 0)


# K2's kernels by kind: bf16 wgmma, bf16 mma.sync, f32 wgmma (F32_K2_KERNELS),
# f32 mma.sync (flash_bwd_tf32.cuh's 3xTF32 kernels)
K2_KINDS = ("wgmma", "mma", "f32_wgmma", "f32_mma")


def k2_by_kernel(fa, kvres: bool = False) -> dict:
    """K2's (``kvres``: K2''s) dq and dk/dv launches since ``zero_k2`` by
    kernel: {"flash_bwd_dq_wgmma": n, "flash_bwd_dq_mma": n,
    "flash_bwd_dq_f32_wgmma": n, ...}."""
    sfx = "_kvres" if kvres else ""
    return {f"flash_bwd_{kind}{sfx}_{k}": getattr(getattr(fa, f"flash_bwd_{kind}{sfx}"),
                                                 f"{k}_launches")
            for kind in ("dq", "dkv") for k in K2_KINDS}


def k2_wgmma_want(n: int, kvres: bool = False, f32: int = 0) -> dict:
    """``k2_by_kernel`` of a training path that launched K2 (K2') ``n`` times
    a kernel in bf16 and ``f32`` times in f32: every launch on the wgmma
    kernels of its dtype (d = 48, 96 and 112), none on the mma.sync ones."""
    sfx = "_kvres" if kvres else ""
    want = {"wgmma": n, "mma": 0, "f32_wgmma": f32, "f32_mma": 0}
    return {f"flash_bwd_{kind}{sfx}_{k}": want[k] for kind in ("dq", "dkv") for k in K2_KINDS}


def bf16_k1_launches(fa, label: str, launches: int) -> int:
    """On a bf16 path that launched K1 ``launches`` times since ``zero_k1``
    (the estimator's forwards: CoAM-W48 and TransPose-H at d = 48, 96 and
    112), every launch ran the wgmma kernel and none the mma.sync one.
    Returns the wgmma kernel's launches."""
    wgmma, mma = fa.flash_attention.wgmma_launches, fa.flash_attention.mma_launches
    if wgmma != launches or mma:
        raise AssertionError(f"{label}: K1 launched {launches} times, the wgmma kernel "
                             f"{wgmma}, the mma.sync kernel {mma}")
    return wgmma


def _run_counts(fa, tw, label: str) -> dict:
    """The launches since ``_zero_counts`` of K1, K1', K4 and its two-pass
    form; f32 K1's on its wgmma kernel recorded under ``label``
    (``f32_k1_wgmma``)."""
    f32_k1_wgmma(fa, label)
    return {"flash_fwd": fa.flash_attention.launches,
            "flash_fwd_kvres": fa.flash_attention_kvres.launches,
            "warp_resample": tw.warp_resample.launches,
            "warp_resample_two_pass": tw.warp_resample_two_pass.launches}


def _zero_counts(fa, tw) -> None:
    for f in (tw.warp_resample, tw.warp_resample_two_pass):
        f.launches = 0                                       # the main path's run
    zero_k1(fa)


def _check_round(np, label: str, r: dict, crops: int) -> None:
    rows = json.loads(Path(r["results"]).read_text())
    if len(rows) != crops or r["crops"] % crops or not (np.isfinite(r["AP"])
                                                        and 0.0 <= r["AP"] <= 1.0):
        raise AssertionError(f"{label}: {len(rows)} results for {crops} crops "
                             f"({r['crops']} run), AP {r['AP']}")


def resnet_phase(torch, np, fa, tw) -> dict:
    """BUCTD pose_resnet-50 with the preNet at full width (the preNet-W48
    yaml with MODEL.NAME pose_resnet: CrowdPose 384x288, 14 joints), from
    one .pth of random weights: served through PoseEstimator (ROUNDS rounds,
    predict_batch of 3 images x 4 poses) in f32 and bf16 in turns with
    TPU.FUSED_PRENET off and auto, each f32 forward card vs CPU, fused vs
    unfused predictions; one evaluation round of RESNET_EVAL_IMAGES x
    SYNTH_PEOPLE crops through valid.run and 3 training steps through
    train.run.  pose_resnet reaches no hand-written kernel but K4 (the
    loaders' warp): K1 is launched 0 times on every path."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.serving import PoseEstimator
    from buctd_tpu_torch.train import run as train_run
    from buctd_tpu_torch.valid import run as valid_run

    def config(*opts):
        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(PRENET_CONFIG),
                                                 opts=[*RESNET_OPTS, *opts]))
        return cfg

    res = {"serving": {}}
    rng = np.random.RandomState(31)
    batch = [sample_request(np, rng) for _ in range(3)]
    images, poses = [b[0] for b in batch], [b[1] for b in batch]
    x = torch.from_numpy(rng.randn(1, 6, 384, 288).astype(np.float32))
    keep = float("-inf")
    with tempfile.TemporaryDirectory(prefix="buctd_resnet_") as tmp:
        root = Path(tmp)
        torch.manual_seed(31)
        model = get_model(config("TPU.FUSED_PRENET", "off"))
        randomize(torch, model)
        weights = root / "pose_resnet50_random.pth"
        torch.save(model.state_dict(), weights)
        print(f"pose_resnet-50 + preNet: {sum(p.numel() for p in model.parameters())} "
              f"parameters, weights {weights.name}, {ROUNDS} rounds", flush=True)
        del model
        preds = {}
        for knob in ("off", "auto"):
            ests = {dt: PoseEstimator(config("TPU.FUSED_PRENET", knob, "TPU.EVAL_DTYPE", dt),
                                      checkpoint=str(weights), refine_iters=ROUNDS)
                    for dt in ("float32", "bfloat16")}
            for est in ests.values():
                if est.model.fused_prenet != (knob == "auto"):
                    raise AssertionError(f"FUSED_PRENET {knob}: fused {est.model.fused_prenet}")
                est.predict_batch(images, poses, keep)           # cuDNN set-up
            torch.cuda.synchronize()
            _zero_counts(fa, tw)
            ms = {"float32": [], "bfloat16": []}
            for dt in ("float32", "bfloat16", "bfloat16", "float32") * 2:
                t0 = time.perf_counter()
                outs = ests[dt].predict_batch(images, poses, keep)
                ms[dt].append((time.perf_counter() - t0) * 1e3)
                for o in outs:
                    if o.shape != (4, 14, 3) or not np.isfinite(o).all():
                        raise AssertionError(f"pose_resnet {dt}: prediction {o.shape}")
                preds[(knob, dt)] = outs
            launches = fa.flash_attention.launches
            with torch.inference_mode():
                got = ests["float32"].model(x.cuda()).cpu()
                want = copy.deepcopy(ests["float32"].model).cpu()(x)
            err, peak = (got - want).abs().max().item(), want.abs().max().item()
            med = {dt: statistics.median(v) for dt, v in ms.items()}
            print(f"pose_resnet FUSED_PRENET {knob}: predict_batch (3 images x 4 poses, "
                  f"{ROUNDS} rounds) f32 {12e3 / med['float32']:.2f} crops/s "
                  f"({med['float32']:.2f} ms), bf16 {12e3 / med['bfloat16']:.2f} crops/s "
                  f"({med['bfloat16']:.2f} ms), medians of {len(ms['float32'])} in turns; K1 "
                  f"launches {launches} (expected 0); f32 forward card vs CPU max_abs_err "
                  f"{err:.3e}, peak {peak:.3e}, limit {FORWARD_RTOL:.0e} x peak", flush=True)
            if launches != 0 or not err <= FORWARD_RTOL * peak:
                raise AssertionError(f"pose_resnet {knob}: K1 {launches}, card vs CPU {err}")
            res["serving"][knob] = {"ms": med, "forward_err": err}
            if knob == "auto":
                res["profile"] = kernel_profile(
                    torch, lambda: ests["float32"].predict_batch(images, poses, keep),
                    "pose_resnet-50 predict_batch, f32, FUSED_PRENET auto")
            del ests
            torch.cuda.empty_cache()
        gap = max(np.abs(a[..., :2] - b[..., :2]).max()
                  for a, b in zip(preds[("off", "float32")], preds[("auto", "float32")]))
        print(f"pose_resnet fused vs unfused (f32): predictions max |diff| {gap:.3e} px "
              f"(limit {PRENET_PX_TOL} px)", flush=True)
        if not gap <= PRENET_PX_TOL:
            raise AssertionError("pose_resnet: the fused preNet disagrees with the unfused")

        ann = write_synthetic_set(np, root, RESNET_EVAL_IMAGES, SYNTH_PEOPLE, seed=33)
        bu = write_bu_predictions(np, ann, root)
        crops = RESNET_EVAL_IMAGES * SYNTH_PEOPLE
        _zero_counts(fa, tw)
        out = valid_run.main(["--cfg", str(PRENET_CONFIG), *RESNET_OPTS,
                              "TPU.DEVICE_PIPELINE", "True", "DATASET.TEST_IMAGE_DIR", str(root),
                              "DATASET.TEST_ANNOTATION_FILE", str(ann),
                              "TEST.COCO_BBOX_FILE", str(bu),
                              "TEST.BATCH_SIZE_PER_GPU", str(EVAL_BATCH),
                              "TEST.MODEL_FILE", str(weights), "PRINT_FREQ", "100",
                              "OUTPUT_DIR", str(root / "out")])
        ev = _run_counts(fa, tw, "pose_resnet evaluation")
        r = out["rounds"][0]
        batches = -(-crops // EVAL_BATCH)
        print(f"pose_resnet evaluation, one round: AP {r['AP']!r}, {r['crops']} crops, "
              f"{r['crops'] / r['loop_s']:.2f} crops/s (loop {r['loop_s']:.3f} s); "
              f"launches {ev} (K1 0, K4 1 a batch of {EVAL_BATCH}: {batches})", flush=True)
        _check_round(np, "pose_resnet evaluation", r, crops)
        if ev != {"flash_fwd": 0, "flash_fwd_kvres": 0, "warp_resample": batches,
                  "warp_resample_two_pass": 0}:
            raise AssertionError(f"pose_resnet evaluation launches {ev}")
        res.update(eval_crops_s=r["crops"] / r["loop_s"], eval_ap=r["AP"], eval_launches=ev)
        del out

        train_ann = write_synthetic_set(np, root, RESNET_TRAIN_STEPS * TRAIN_BATCH // SYNTH_PEOPLE,
                                        SYNTH_PEOPLE, seed=34)
        _zero_counts(fa, tw)
        t0 = time.perf_counter()
        tr = train_run.main(["--cfg", str(PRENET_CONFIG), "--steps", str(RESNET_TRAIN_STEPS),
                             "--no-eval", "--seed", "0", *RESNET_OPTS,
                             "TPU.DEVICE_PIPELINE", "True", "TPU.DEVICE_SYNTHESIS", "True",
                             "DATASET.TRAIN_IMAGE_DIR", str(root),
                             "DATASET.TRAIN_ANNOTATION_FILE", str(train_ann),
                             "OUTPUT_DIR", str(root / "train")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tl = _run_counts(fa, tw, "pose_resnet training")
        losses = [float(m["loss"]) for st in tr["stats"] for m in st["metrics"]]
        step_ms = [(d + s) * 1e3 for st in tr["stats"]
                   for d, s in zip(st["data_wait_s"], st["step_s"])]
        print(f"pose_resnet training: {tr['steps']} steps of batch {TRAIN_BATCH} (bf16 "
              f"autocast, TPU.DEVICE_SYNTHESIS) in {wall:.1f} s with the model build; "
              f"ms/step {[round(v, 2) for v in step_ms]}; losses "
              f"{[round(v, 6) for v in losses]}; launches {tl}", flush=True)
        if (tr["steps"] != RESNET_TRAIN_STEPS or not np.isfinite(losses).all()
                or tl["flash_fwd"] != 0 or tl["warp_resample"] != RESNET_TRAIN_STEPS):
            raise AssertionError(f"pose_resnet training: {tr['steps']} steps, launches {tl}")
        res.update(train_launches=tl, train_ms=step_ms)
    return res


def lambda_phase(torch, np, fa, tw) -> dict:
    """TEST.LAMBDA_SWEEP: rounds of CoAM-W48 through valid.run on
    eval_phase's synthetic CrowdPose set and weights (the same seeds), f32 and
    bf16, a round without the sweep, then one with it:
    the _l0, _l1 and _merged results, AP in [0, 1], K1 launched 2 x a plain
    round's (lambda 0 and 1), K4 once a batch, the sweep's crops/s beside the
    plain round's.  Then validate_lambda over 6 lambdas on 2 batches of a
    preNet-W48 with the lambda head (K1 0 times)."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.core.function import validate_lambda
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.valid import run as valid_run

    res = {}
    crops = EVAL_IMAGES * SYNTH_PEOPLE
    batches = -(-crops // EVAL_BATCH)
    with tempfile.TemporaryDirectory(prefix="buctd_lambda_") as tmp:
        root = Path(tmp)
        ann = write_synthetic_set(np, root, EVAL_IMAGES, SYNTH_PEOPLE, seed=11)
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
                "PRINT_FREQ", "100"]
        for dt in ("float32", "bfloat16"):
            # a plain round, then a lambda round
            runs = {False: [], True: []}
            for sweep in (False, True):
                _zero_counts(fa, tw)
                out = valid_run.main(["--cfg", str(CONFIG), *opts, "TPU.EVAL_DTYPE", dt,
                                      "TEST.LAMBDA_SWEEP", str(sweep),
                                      "OUTPUT_DIR", str(root / f"out_{dt}_{sweep}")])
                got = _run_counts(fa, tw, f"lambda {dt}" + " sweep" * sweep)
                r = out["rounds"][0]
                want = {"flash_fwd": 2 * (1 + sweep) * batches + out["summary"]["flash_calls"],
                        "flash_fwd_kvres": 0,
                        "warp_resample": batches, "warp_resample_two_pass": 0}
                label = f"{'lambda sweep' if sweep else 'plain round'} {dt}"
                print(f"{label}: AP {r['AP']!r}, {crops} crops{' x lambda 0 and 1' * sweep} "
                      f"in {r['loop_s']:.3f} s = {crops / r['loop_s']:.2f} crops/s; evaluate "
                      f"{r['evaluate_s']:.3f} s; launches {got}, expected {want}", flush=True)
                if got != want or not (np.isfinite(r["AP"]) and 0.0 <= r["AP"] <= 1.0):
                    raise AssertionError(f"{label}: launches {got}, AP {r['AP']}")
                if sweep:
                    results = Path(r["results"])
                    if not results.name.endswith("_merged.json"):
                        raise AssertionError(f"lambda sweep results {results}")
                    for kind in ("l0", "l1"):
                        if not results.with_name(results.name.replace("merged", kind)).exists():
                            raise AssertionError(f"lambda sweep: no _{kind} json")
                    rows = json.loads(results.read_text())
                    if not crops <= len(rows) <= 2 * crops:
                        raise AssertionError(f"lambda sweep: {len(rows)} merged rows")
                runs[sweep].append((crops / r["loop_s"], got, r["AP"]))
                del out
            lam_s = statistics.mean(v[0] for v in runs[True])
            plain_s = statistics.mean(v[0] for v in runs[False])
            print(f"lambda sweep {dt}: {lam_s:.2f} crops/s against the plain round's "
                  f"{plain_s:.2f} ({lam_s / plain_s:.3f}x; one round each)", flush=True)
            res[dt] = {"launches": sum(v[1]["flash_fwd"] for vs in runs.values() for v in vs),
                       "warp_launches": sum(v[1]["warp_resample"] for vs in runs.values()
                                            for v in vs),
                       "crops_s": lam_s, "plain_crops_s": plain_s, "ap": runs[True][0][2]}
            torch.cuda.empty_cache()

        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(PRENET_CONFIG), opts=[
            "TPU.DEVICE_PIPELINE", "True", "DATASET.TEST_IMAGE_DIR", str(root),
            "DATASET.TEST_ANNOTATION_FILE", str(ann), "TEST.COCO_BBOX_FILE", str(bu),
            "TEST.BATCH_SIZE_PER_GPU", str(EVAL_BATCH)]))
        torch.manual_seed(35)
        model = get_model(cfg, lambda_head=True)
        randomize(torch, model)
        ds = get_dataset(cfg, is_train=False)
        _zero_counts(fa, tw)
        loader = DeviceLoader(ds, cfg, num_workers=4)
        it = iter(loader)
        two = [next(it) for _ in range(2)]
        loader.close()
        t0 = time.perf_counter()
        sweep = validate_lambda(cfg, two, ds, model)
        torch.cuda.synchronize()
        got = _run_counts(fa, tw, "validate_lambda")
        print(f"validate_lambda, preNet-W48 with the lambda head, 2 batches of {EVAL_BATCH}, "
              f"6 lambdas in {time.perf_counter() - t0:.3f} s: "
              f"{ {k: (round(v[0], 6), round(v[1], 4)) for k, v in sweep.items()} }; "
              f"launches {got}", flush=True)
        losses = [v[0] for v in sweep.values()]
        if (list(sweep) != [0, 0.2, 0.4, 0.6, 0.8, 1.0] or not np.isfinite(losses).all()
                or len(set(losses)) < 2 or got["flash_fwd"] != 0 or got["warp_resample"] != 2):
            raise AssertionError(f"validate_lambda: {sweep}, launches {got}")
        res["validate_lambda_warp_launches"] = got["warp_resample"]
    return res


def datasets_phase(torch, np, fa, tw) -> dict:
    """One evaluation round of DATASET_IMAGES x SYNTH_PEOPLE crops through
    valid.run with CoAM-W48 at full width (random weights) on each of
    DATASETS: synthetic OCHuman (COCO-17, the coco yaml), fish (7 joints),
    multimouse (12) and marmosets (15) from BU-prediction jsons: one result
    per crop, AP in [0, 1], K1 twice and K4 once a batch."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.valid import run as valid_run

    res = {}
    crops = DATASET_IMAGES * SYNTH_PEOPLE
    batches = -(-crops // EVAL_BATCH)
    for i, (name, yaml) in enumerate(DATASETS.items()):
        with tempfile.TemporaryDirectory(prefix=f"buctd_{name}_") as tmp:
            root = Path(tmp)
            ann = write_synthetic_set(np, root, DATASET_IMAGES, SYNTH_PEOPLE, seed=40 + i,
                                      layout=name)
            bu = write_bu_predictions(np, ann, root)
            opts = ["DATASET.DATASET", name, "MODEL.NUM_JOINTS", str(SYNTH_JOINTS[name])]
            cfg = default_config()
            update_config(cfg, types.SimpleNamespace(cfg=str(yaml), opts=opts))
            torch.manual_seed(40 + i)
            model = get_model(cfg)
            randomize(torch, model)
            weights = root / "random_weights.pth"
            torch.save(model.state_dict(), weights)
            del model
            _zero_counts(fa, tw)
            out = valid_run.main(["--cfg", str(yaml), *opts, "TPU.DEVICE_PIPELINE", "True",
                                  "DATASET.TEST_IMAGE_DIR", str(root),
                                  "DATASET.TEST_ANNOTATION_FILE", str(ann),
                                  "TEST.COCO_BBOX_FILE", str(bu),
                                  "TEST.BATCH_SIZE_PER_GPU", str(EVAL_BATCH),
                                  "TEST.MODEL_FILE", str(weights), "PRINT_FREQ", "100",
                                  "OUTPUT_DIR", str(root / "out")])
            got = _run_counts(fa, tw, f"datasets {name}")
            r = out["rounds"][0]
            want = {"flash_fwd": 2 * batches + out["summary"]["flash_calls"],
                    "flash_fwd_kvres": 0, "warp_resample": batches,
                    "warp_resample_two_pass": 0}
            print(f"{name} ({SYNTH_JOINTS[name]} joints, {yaml.parent.name} CoAM-W48), one "
                  f"round: AP {r['AP']!r}, {r['crops']} crops, "
                  f"{r['crops'] / r['loop_s']:.2f} crops/s; launches {got}, expected {want}",
                  flush=True)
            _check_round(np, name, r, crops)
            if got != want:
                raise AssertionError(f"{name}: launches {got} != {want}")
            res[name] = {"launches": got["flash_fwd"], "warp_launches": got["warp_resample"],
                         "ap": r["AP"], "crops_s": r["crops"] / r["loop_s"]}
            del out
            torch.cuda.empty_cache()
    return res


def host_loader_phase(torch, np, fa, tw) -> dict:
    """The JAX default data path, TPU.DEVICE_PIPELINE False (no override), at
    full width on CoAM-W48 (CONFIG, batch 32) and synthetic CrowdPose sets:

    * the trainer through train.run.main, HOST_SAMPLER_STEPS steps on the
      host ``Loader`` with the host sampler, then TRAIN_STEPS with
      TPU.DEVICE_SYNTHESIS True on the host Loader and on the device
      loader, one run each: ms/step (median from step 3), data wait and
      dispatch, K1 and K2 launches a
      step (bf16 K1 with dropout, K2 dq and dk/dv; K4 never on the host
      Loader); then HOST_CHECK_STEPS steps with PRINT_FREQ 1,
      BUCTD_PROFILE_DIR and DEBUG.DEBUG: one train_loss line a step in
      metrics.jsonl, a Chrome trace, epoch 0's debug images, the summary's
      parameter count and GFLOPs a crop;
    * evaluation rounds of EVAL_IMAGES x SYNTH_PEOPLE crops through valid.run
      on one .pth of random weights, host Loader and device loader in turns
      (host, device, device, host; f32 K1 2 a batch; K4 1 a batch on the
      device loader only): crops/s and AP; one batch's 'input' from the two
      loaders against each other (tests/test_device_pipeline.py's eval
      limits: the share within 0.02 on smooth images, the rest on these
      noise ones too); HOST_CROP_CHECKS host crops within one uint8 level of
      ``cv2_sampling_reference`` at the installed OpenCV's sampling;
    * the host Loader's batch on the card against the same batch on the CPU
      (same seed: the cv2 crops are equal, the normalisation and the render
      run on each device);
    * the banded-matmul warp engine (TPU.WARP_ENGINE matmul) at K4's draw,
      WARP_BATCH -> 384x288, rotations -90..90: against K4's plain version
      (WARP_MATMUL_ATOL), timed beside K4 on the same inputs, its peak
      memory."""
    import os

    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.data.pipeline import Loader
    from buctd_tpu_torch.geometry import make_affine
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.train import run as train_run
    from buctd_tpu_torch.valid import run as valid_run

    res = {"launches": {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                        "warp_resample": 0}}
    counted = {"flash_fwd": fa.flash_attention, "flash_bwd_dq": fa.flash_bwd_dq,
               "flash_bwd_dkv": fa.flash_bwd_dkv, "warp_resample": tw.warp_resample}

    def train(root, ann, label, opts, steps=TRAIN_STEPS, device_loader=False):
        for f in counted.values():
            f.launches = 0                                   # the main path's run
        zero_k1(fa)
        zero_k2(fa)
        t0 = time.perf_counter()
        out = train_run.main(["--cfg", str(CONFIG), "--steps", str(steps), "--no-eval",
                              "--seed", "0", "DATASET.TRAIN_IMAGE_DIR", str(root),
                              "DATASET.TRAIN_ANNOTATION_FILE", str(ann),
                              "OUTPUT_DIR", str(root / f"out_{label}"),
                              "LOG_DIR", str(root / f"log_{label}"), *opts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {**{k: f.launches for k, f in counted.items()}, **k2_by_kernel(fa)}
        f32_k1_wgmma(fa, f"host_loader training {label}")
        for k in got:
            res["launches"][k] = res["launches"].get(k, 0) + got[k]
        calls = out["summary"]["flash_calls"]
        want = {"flash_fwd": 2 * steps + calls, "flash_bwd_dq": 2 * steps,
                "flash_bwd_dkv": 2 * steps, "warp_resample": steps * device_loader,
                **k2_wgmma_want(2 * steps)}
        losses = [float(m["loss"]) for st in out["stats"] for m in st["metrics"]]
        st = out["stats"][0]
        warm = slice(2 if steps > 2 else 0, None)       # from step 3; all of a short run
        per_step = [d + x for d, x in zip(st["data_wait_s"], st["step_s"])]
        r = {"ms_step": statistics.median(per_step[warm]) * 1e3,
             "data_ms": statistics.median(st["data_wait_s"][warm]) * 1e3,
             "dispatch_ms": statistics.median(st["step_s"][warm]) * 1e3,
             "k1_per_step": (got["flash_fwd"] - calls) / steps,
             "k2_per_step": (got["flash_bwd_dq"] / steps, got["flash_bwd_dkv"] / steps)}
        print(f"host_loader trainer {label} ({'DeviceLoader' if device_loader else 'Loader'}"
              f", {opts}): {out['steps']} steps in {wall:.1f} s (model build and data "
              f"included); steps {warm.start + 1}-{steps} median {r['ms_step']:.2f} ms/step (data wait "
              f"{r['data_ms']:.2f}, dispatch {r['dispatch_ms']:.2f}); launches {got}, "
              f"expected {want} (K1 {r['k1_per_step']:.0f} a step + {calls} in the summary's "
              f"forward, K2 dq/dkv {r['k2_per_step']} a step); losses "
              f"{[round(x, 6) for x in losses]}", flush=True)
        if got != want or out["steps"] != steps or not np.isfinite(losses).all():
            raise AssertionError(f"host_loader trainer {label}: launches {got} != {want}, "
                                 f"{out['steps']} steps, losses {losses}")
        return r, out

    with tempfile.TemporaryDirectory(prefix="buctd_host_loader_") as tmp:
        root = Path(tmp)
        ann = write_synthetic_set(np, root, SYNTH_IMAGES, SYNTH_PEOPLE)
        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(CONFIG), opts=[]))
        if cfg.TPU.DEVICE_PIPELINE or int(cfg.TRAIN.BATCH_SIZE_PER_GPU) != TRAIN_BATCH:
            raise AssertionError("the stock yaml must run the host Loader at batch 32")
        res["host"] = train(root, ann, "host", [], steps=HOST_SAMPLER_STEPS)[0]
        torch.cuda.empty_cache()
        synth = ["TPU.DEVICE_SYNTHESIS", "True"]
        turns = [train(root, ann, f"{kind}_synth{k}",
                       synth + ["TPU.DEVICE_PIPELINE", "True"] * (kind == "device"),
                       device_loader=kind == "device")[0]
                 for k, kind in enumerate(("host", "device"))]
        torch.cuda.empty_cache()
        for kind, turn in (("host_synth", turns[0]), ("device_synth", turns[1])):
            res[kind] = {key: turn[key] for key in ("ms_step", "data_ms", "dispatch_ms")}
        print(f"host_loader trainer, CoAM-W48 batch {TRAIN_BATCH}: host Loader with the host "
              f"sampler {res['host']['ms_step']:.2f} ms/step (data wait "
              f"{res['host']['data_ms']:.2f}, dispatch {res['host']['dispatch_ms']:.2f}); "
              f"with TPU.DEVICE_SYNTHESIS, one run each: host Loader "
              f"{res['host_synth']['ms_step']:.2f} ms/step (data wait "
              f"{res['host_synth']['data_ms']:.2f}, dispatch "
              f"{res['host_synth']['dispatch_ms']:.2f}), DeviceLoader "
              f"{res['device_synth']['ms_step']:.2f} ms/step (data wait "
              f"{res['device_synth']['data_ms']:.2f}, dispatch "
              f"{res['device_synth']['dispatch_ms']:.2f})", flush=True)

        # metrics.jsonl, the Chrome trace, the debug dumps and the summary
        trace_dir = root / "trace"
        os.environ["BUCTD_PROFILE_DIR"] = str(trace_dir)
        try:
            chk, out = train(root, ann, "checks", synth + [
                "PRINT_FREQ", "1", "DEBUG.DEBUG", "True", "DEBUG.SAVE_BATCH_IMAGES_GT", "True",
                "DEBUG.SAVE_BATCH_IMAGES_PRED", "True", "DEBUG.SAVE_HEATMAPS_PRED", "True"],
                steps=HOST_CHECK_STEPS)
        finally:
            del os.environ["BUCTD_PROFILE_DIR"]
        rows = [json.loads(line) for line in
                (out["log_dir"] / "metrics.jsonl").read_text().splitlines()]
        loss_steps = [r["step"] for r in rows if r["tag"] == "train_loss"]
        traces = list(trace_dir.glob("trace_*.json"))
        dumps = sorted(p.name for p in out["output_dir"].glob("train_epoch_0_iter_*.jpg"))
        summary = out["summary"]
        gflops = summary["flops"] / 1e9
        print(f"host_loader checks: metrics.jsonl train_loss steps {loss_steps}; Chrome traces "
              f"{[(p.name, p.stat().st_size) for p in traces]}; debug dumps {dumps}; summary "
              f"{summary['params']:,} parameters, {gflops:.2f} GFLOPs a crop (K1's products "
              f"from {summary['flash_calls']} calls added)", flush=True)
        if loss_steps != list(range(HOST_CHECK_STEPS)) or len(traces) != 1 \
                or len(dumps) != 3 * HOST_CHECK_STEPS or not summary["params"] > 0 \
                or not gflops > 0 or summary["flash_calls"] != 2:
            raise AssertionError("host_loader checks failed")
        res.update(params=summary["params"], gflops=gflops)
        del out, chk
        torch.cuda.empty_cache()

        # evaluation: one round each loader, the same weights and set
        eroot = root / "eval"
        eroot.mkdir()
        eann = write_synthetic_set(np, eroot, EVAL_IMAGES, SYNTH_PEOPLE, seed=11)
        bu = write_bu_predictions(np, eann, eroot)
        torch.manual_seed(5)
        model = get_model(cfg)
        randomize(torch, model)
        weights = eroot / "random_weights.pth"
        torch.save(model.state_dict(), weights)
        del model
        opts = ["DATASET.TEST_IMAGE_DIR", str(eroot), "DATASET.TEST_ANNOTATION_FILE", str(eann),
                "TEST.COCO_BBOX_FILE", str(bu), "TEST.MODEL_FILE", str(weights),
                "PRINT_FREQ", "100"]
        batches = -(-EVAL_IMAGES * SYNTH_PEOPLE // EVAL_BATCH)
        rounds = {"host": [], "device": []}
        for k, kind in enumerate(("host", "device", "device", "host")):     # in turns
            _zero_counts(fa, tw)
            extra = ["TPU.DEVICE_PIPELINE", "True"] if kind == "device" else []
            ev = valid_run.main(["--cfg", str(CONFIG), *opts, *extra,
                                 "OUTPUT_DIR", str(eroot / f"out_{kind}{k}"),
                                 "LOG_DIR", str(eroot / f"log_{kind}{k}")])
            got = _run_counts(fa, tw, f"host_loader evaluation {kind}")
            r = ev["rounds"][0]
            want = {"flash_fwd": 2 * batches + ev["summary"]["flash_calls"],
                    "flash_fwd_kvres": 0, "warp_resample": batches * (kind == "device"),
                    "warp_resample_two_pass": 0}
            print(f"host_loader evaluation, {'DeviceLoader' if kind == 'device' else 'Loader'}: "
                  f"AP {r['AP']!r}, {r['crops']} crops in {r['loop_s']:.3f} s = "
                  f"{r['crops'] / r['loop_s']:.2f} crops/s, evaluate {r['evaluate_s']:.3f} s; "
                  f"launches {got}, expected {want}", flush=True)
            _check_round(np, f"host_loader evaluation {kind}", r, EVAL_IMAGES * SYNTH_PEOPLE)
            if got != want:
                raise AssertionError(f"host_loader evaluation {kind}: launches {got} != {want}")
            res["launches"]["flash_fwd"] += got["flash_fwd"]
            res["launches"]["warp_resample"] += got["warp_resample"]
            rounds[kind].append(r)
            del ev
        for kind, pair in rounds.items():
            if pair[0]["AP"] != pair[1]["AP"]:
                raise AssertionError(f"host_loader evaluation {kind}: AP {pair[0]['AP']} then "
                                     f"{pair[1]['AP']} on the same weights and set")
            res[f"eval_{kind}"] = {"ap": pair[0]["AP"], "crops_s": statistics.mean(
                r["crops"] / r["loop_s"] for r in pair)}

        # one batch of each loader, and the host Loader on the CPU
        import cv2

        def first_batch(kind, cfg_=None, ds_=None):
            cfg_ = cfg_ or ecfg
            make = DeviceLoader if kind == "device" else Loader
            loader = make(ds_ or ds, cfg_, num_workers=4,
                          **({"device": "cpu"} if kind == "host_cpu" else {}))
            try:
                return next(iter(loader))
            finally:
                loader.close()

        ecfg = default_config()
        update_config(ecfg, types.SimpleNamespace(cfg=str(CONFIG), opts=opts))
        ds = get_dataset(ecfg, is_train=False)
        gap = loaders_input_gap(np, first_batch)
        hb = gap.pop("batches")[0]
        cb = first_batch("host_cpu")
        # tests/test_device_pipeline.py's eval limits, on these noise images
        # all but the share within 0.02, which is held on smooth images
        # below: OpenCV 4's uint8 INTER_LINEAR samples at 1/32 px, up to 6
        # levels off the exact bilinear of K4's plain version on noise
        print(f"host_loader eval batch (noise images), Loader vs DeviceLoader 'input': RGB "
              f"max |diff| {gap['max']:.4f} (limit 0.2), a sample's mean {gap['mean']:.5f} "
              f"(limit 0.15), share within 0.02 {gap['share']:.5f} (held on smooth images); "
              f"condition channels max |diff| {gap['cond']:.2e} (limit 1e-3)", flush=True)
        if not (gap["max"] < 0.2 and gap["mean"] < 0.15 and gap["cond"] <= 1e-3):
            raise AssertionError("the host and device loaders' eval inputs disagree")
        # the host crops against the sampling the installed OpenCV is known by
        plans = [ds.plan_sample(i) for i in range(HOST_CROP_CHECKS)]
        if any(p_["mask_box"] is not None for p_ in plans):
            raise AssertionError("an eval sample with a crop-aug mask")
        samp = cv2_sampling(np, [ds.get_sample(i)["image"] for i in range(HOST_CROP_CHECKS)],
                            [p_["image"] for p_ in plans], [p_["trans"] for p_ in plans],
                            (int(ecfg.MODEL.IMAGE_SIZE[0]), int(ecfg.MODEL.IMAGE_SIZE[1])))
        print(f"host_loader crops (OpenCV {cv2.__version__}), {HOST_CROP_CHECKS} eval samples "
              f"against numpy's bilinear: exact point max {samp['exact']['max']} levels, "
              f"{samp['exact']['equal']:.5f} equal; 1/32 px point max "
              f"{samp['1/32 px']['max']} levels, {samp['1/32 px']['equal']:.5f} equal; this "
              f"build samples {samp['match']}", flush=True)
        if samp["match"] is None:
            raise AssertionError("the host crops match neither bilinear sampling")
        # smooth images: the share within 0.02 of test_device_pipeline.py's
        # eval test too (0.995)
        sroot = eroot / "smooth"
        sroot.mkdir()
        sann = sroot / eann.name
        sann.write_text(eann.read_text())
        write_smooth_images(np, sroot, sann)
        scfg = default_config()
        update_config(scfg, types.SimpleNamespace(cfg=str(CONFIG), opts=opts + [
            "DATASET.TEST_IMAGE_DIR", str(sroot), "DATASET.TEST_ANNOTATION_FILE", str(sann),
            "TEST.COCO_BBOX_FILE", str(write_bu_predictions(np, sann, sroot))]))
        sds = get_dataset(scfg, is_train=False)
        smooth = loaders_input_gap(np, lambda kind: first_batch(kind, scfg, sds))
        del smooth["batches"]
        print(f"host_loader eval batch (smooth images), Loader vs DeviceLoader 'input': RGB "
              f"max |diff| {smooth['max']:.4f} (limit 0.2), share within 0.02 "
              f"{smooth['share']:.5f} (limit 0.995), a sample's mean {smooth['mean']:.5f}; "
              f"condition channels max |diff| {smooth['cond']:.2e} (limit 1e-3)", flush=True)
        if not (smooth["max"] < 0.2 and smooth["share"] > 0.995 and smooth["cond"] <= 1e-3):
            raise AssertionError("the host and device loaders' eval inputs disagree on "
                                 "smooth images")
        res["loader_input"] = {"noise": gap, "smooth": smooth, "sampling": samp,
                               "opencv": cv2.__version__}
        gap_rgb = (hb["input"][:, :3].cpu() - cb["input"][:, :3]).abs().max().item()
        gap_cond = (hb["input"][:, 3:].cpu() - cb["input"][:, 3:]).abs().max().item()
        gap_tgt = (hb["target"].cpu() - cb["target"]).abs().max().item()
        print(f"host_loader eval batch, card vs CPU: RGB max |diff| {gap_rgb:.2e} (limit "
              f"{HOST_CARD_RGB_ATOL:.0e}), condition channels {gap_cond:.2e} (limit 1e-3), "
              f"targets {gap_tgt:.2e} (limit 1e-6)", flush=True)
        if not (gap_rgb <= HOST_CARD_RGB_ATOL and gap_cond <= 1e-3 and gap_tgt <= 1e-6):
            raise AssertionError("the host Loader's batch on the card disagrees with the CPU's")
        res["card_vs_cpu"] = {"rgb": gap_rgb, "cond": gap_cond, "target": gap_tgt}

    # the banded-matmul engine at K4's draw
    gen = torch.Generator(device="cuda").manual_seed(15)
    B, H, W = WARP_BATCH
    out_hw = (384, 288)
    images = torch.rand(B, H, W, 3, device="cuda", generator=gen) * 255.0
    centers = torch.rand(B, 2, device="cuda", generator=gen) * torch.tensor(
        [440.0, 280.0], device="cuda") + 100.0
    scales = torch.rand(B, 2, device="cuda", generator=gen) * 1.2 + 0.6
    rots = torch.rand(B, device="cuda", generator=gen) * 180.0 - 90.0
    trans = make_affine(centers, scales, rots, out_hw[::-1], inv=True).contiguous()
    before = tw.warp_resample.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = tw.warp_affine_general(images, trans, out_hw, "matmul")
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    if tw.warp_resample.launches != before:
        raise AssertionError("TPU.WARP_ENGINE matmul launched K4")
    want = tw.warp_affine_reference(images, trans, out_hw)
    mm_err = (got - want).abs().max().item()
    del want
    mm_ms = timed_ms(lambda: tw.warp_affine_general(images, trans, out_hw, "matmul"), 3)
    k4_ms = timed_ms(lambda: tw.warp_resample(images, trans, out_hw), 20)
    tw.warp_resample.launches = before                       # the timing's launches
    print(f"matmul warp engine ({B}, {H}, {W}, 3) f32 -> {out_hw}, rotations -90..90: max "
          f"|diff| to K4's plain version {mm_err:.3e} (limit {WARP_MATMUL_ATOL:.3e}); "
          f"{mm_ms:.4f} ms a batch against K4's {k4_ms:.4f} ms ({mm_ms / k4_ms:.1f}x), the "
          f"host Loader's step {res['host']['ms_step']:.2f} ms; peak memory above the inputs "
          f"{peak_gb:.3f} GB", flush=True)
    if not mm_err <= WARP_MATMUL_ATOL:
        raise AssertionError(f"the matmul engine disagrees with K4's plain version: {mm_err}")
    res["matmul"] = {"err": mm_err, "ms": mm_ms, "k4_ms": k4_ms, "peak_gb": peak_gb}
    return res


def inference_phase(torch, np, fa, eval_files) -> dict:
    """buctd_tpu_torch.tools.inference at full width: run_ctd_inference on
    one 480x640 image with 4 condition poses, refine_iters 1 and 3, CoAM-W48
    from a .pth of random weights, in the yaml's TPU.COMPUTE_DTYPE (bf16)
    and in f32: finite, K1 twice a round; the card against the CPU's f32 run
    (the share of joints within one heatmap pixel, at least
    INFERENCE_PX_SHARE in f32); ms/image of each call with the model built.
    Then ops/native.py's cpu_nms and gpu_nms on 2000 boxes against
    ops/nms.py::nms, and analysis.bin_evaluate on eval_phase's results."""
    import shutil

    from buctd_tpu_torch.analysis import bin_evaluate
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.core.refine import make_refine_fn
    from buctd_tpu_torch.data.coco_io import COCOIndex
    from buctd_tpu_torch.data.datasets.crowdpose import CROWDPOSE_OKS_SIGMAS
    from buctd_tpu_torch.geometry import joints2box, xywh2cs
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.ops import native
    from buctd_tpu_torch.ops.nms import nms
    from buctd_tpu_torch.tools import inference

    res = {"launches": {}}
    rng = np.random.RandomState(51)
    img, conds = sample_request(np, rng)
    # one heatmap pixel in image px for each pose: its crop's width / the map's
    px = np.array([xywh2cs(*joints2box(c, 25, 640, 480), aspect_ratio=288 / 384)[1][0]
                   * 200 / 72 for c in conds])
    with tempfile.TemporaryDirectory(prefix="buctd_inference_") as tmp:
        torch.manual_seed(51)
        cfgs = {}
        for dt in ("bfloat16", "float32"):
            cfgs[dt] = default_config()
            update_config(cfgs[dt], types.SimpleNamespace(
                cfg=str(CONFIG), opts=["TPU.COMPUTE_DTYPE", dt]))
        model = get_model(cfgs["float32"])
        randomize(torch, model)
        weights = str(Path(tmp) / "random_weights.pth")
        torch.save(model.state_dict(), weights)
        del model
        keep = float("-inf")
        runs = {}
        for dt in ("bfloat16", "float32"):
            for iters in (1, 3):
                zero_k1(fa)                                  # the main path's run
                out = inference.run_ctd_inference([img], [conds], weights, keep,
                                                  config=cfgs[dt], refine_iters=iters)
                n = fa.flash_attention.launches
                f32_k1_wgmma(fa, f"inference {dt}")
                res["launches"][f"{dt}_{iters}"] = n
                if out.shape != (1, 4, 14, 3) or not np.isfinite(out).all() or n != 2 * iters:
                    raise AssertionError(f"inference {dt} x{iters}: {out.shape}, K1 {n}")
                runs[(dt, iters)] = out[0]
        t0 = time.perf_counter()
        for iters in (1, 3):
            cpu = inference.run_ctd_inference([img], [conds], weights, keep, device="cpu",
                                              config=cfgs["float32"], refine_iters=iters)[0]
            for dt in ("float32", "bfloat16"):
                dist = np.abs(runs[(dt, iters)][..., :2] - cpu[..., :2]).max(-1)
                share = float((dist <= px[:, None]).mean())
                print(f"inference x{iters} {dt} on the card vs f32 on the CPU: "
                      f"{100 * share:.1f}% of joints within one heatmap pixel "
                      f"({px.round(2).tolist()} px), max |diff| {dist.max():.3e} px", flush=True)
                res[f"share_{dt}_{iters}"] = share
                if dt == "float32" and not share >= INFERENCE_PX_SHARE:
                    raise AssertionError(f"inference x{iters}: card vs CPU share {share}")
        print(f"the CPU's runs took {time.perf_counter() - t0:.1f} s", flush=True)

        for dt in ("bfloat16", "float32"):
            cfg = inference.model_config(cfgs[dt])
            model = inference.get_model(cfg, weights)
            refine = make_refine_fn(cfg, model, inference.palette(14), n_iters=3)
            calls = {1: lambda: inference.get_pose_feature(cfg, model, img, conds, keep),
                     3: lambda: torch.cat(refine(img, conds), -1).cpu()}
            for iters, fn in calls.items():
                fn()
                res[f"ms_{dt}_{iters}"] = host_ms(fn, REPEATS)
            print(f"inference {dt} (model built): refine_iters 1 {res[f'ms_{dt}_1']:.2f} "
                  f"ms/image, 3 {res[f'ms_{dt}_3']:.2f} ms/image (4 poses, host clock to "
                  f"the results on the host)", flush=True)
            del model, refine
            torch.cuda.empty_cache()

    r = np.random.RandomState(52)
    xy = r.uniform(0, 1000, (2000, 2))
    dets = np.c_[xy, xy + r.uniform(10, 150, (2000, 2)), r.permutation(2000) / 2000.0
                 ].astype(np.float32)
    t0 = time.perf_counter()
    for thresh in (0.3, 0.5, 0.7):
        kept = native.cpu_nms(dets, thresh)
        if native.gpu_nms(dets, thresh) != kept or kept != nms(dets, thresh):
            raise AssertionError(f"native NMS at {thresh} disagrees with ops/nms.py::nms")
    print(f"cpu_nms and gpu_nms on 2000 boxes at 0.3/0.5/0.7 equal ops/nms.py::nms "
          f"(built and run in {time.perf_counter() - t0:.2f} s)", flush=True)

    ann, results = eval_files
    try:
        out = bin_evaluate(COCOIndex(str(ann)), str(results), list(range(9)), list(range(18)),
                           sigmas=CROWDPOSE_OKS_SIGMAS)
    finally:
        shutil.rmtree(Path(ann).parent)
    print(f"bin_evaluate on eval_phase's round-0 results, every bin: {out}", flush=True)
    if not (out["num_instances"] > 0 and 0.0 <= out["AP"] <= 1.0):
        raise AssertionError(f"bin_evaluate: {out}")
    return res



def _mc_step(torch, cfg, model):
    """The trainer's step (train/state.py::make_train_step) on ``model`` with
    a seeded dropout generator; the model in training mode."""
    from buctd_tpu_torch.train.state import make_lr_schedule, make_optimizer, make_train_step

    optimizer = make_optimizer(cfg, model)
    return make_train_step(cfg, model, optimizer, make_lr_schedule(cfg, optimizer, 10),
                           torch.Generator().manual_seed(0), seed=0)


def _mc_config(opts):
    from buctd_tpu_torch.config import default_config, update_config

    cfg = default_config()
    update_config(cfg, types.SimpleNamespace(cfg=str(CONFIG), opts=list(opts)))
    return cfg


def _mc_batch(torch, np, n: int, seed: int, device) -> dict:
    rng = np.random.RandomState(seed)
    return {"input": torch.from_numpy(rng.randn(n, 6, 384, 288).astype(np.float32)).to(device),
            "target": torch.from_numpy((rng.rand(n, 14, 96, 72) > 0.999).astype(np.float32)
                                       ).to(device),
            "target_weight": torch.from_numpy((rng.rand(n, 14) > 0.2).astype(np.float32)
                                              ).to(device)}


def _mc_counts(fa) -> dict:
    return {"flash_fwd": fa.flash_attention.launches, "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches, **k2_by_kernel(fa),
            **{f"flash_fwd_{name}": getattr(fa.flash_attention, name)
               for name in K1_COUNTS[1:]}}


def _mc_k1_want(n: int, f32: bool) -> dict:
    """``_mc_counts``' K1 launches by kernel on a CoAM-W48 path that launched
    K1 ``n`` times: all on the wgmma kernel of its dtype."""
    return {"flash_fwd_wgmma_launches": 0 if f32 else n, "flash_fwd_mma_launches": 0,
            "flash_fwd_f32_wgmma_launches": n if f32 else 0, "flash_fwd_f32_mma_launches": 0}


def _mc_zero(fa) -> None:
    zero_k1(fa)
    zero_k2(fa)


def _mc_f32_run(torch, np, fa, job: dict, rank: int, world: int) -> dict:
    """Part (b)'s steps on this process's rows of the global batch: 2 steps
    whose losses are compared, then MC_TIMED_STEPS timed ones; the losses,
    ms/step, the K1/K2 launches of the 2 compared steps and the BN running
    statistics after them."""
    cfg = _mc_config(job["opts"])
    from buctd_tpu_torch.models import get_model

    model = get_model(cfg)
    model.load_state_dict(torch.load(job["weights"], weights_only=True))
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    step = _mc_step(torch, cfg, model)
    n = MC_GLOBAL_BATCH // world
    batch = {k: v[rank * n:(rank + 1) * n] for k, v in
             _mc_batch(torch, np, MC_GLOBAL_BATCH, 17, "cuda").items()}
    _mc_zero(fa)                                       # the main path's run
    losses = [float(step(batch)["loss"]) for _ in range(2)]
    torch.cuda.synchronize()
    launches = _mc_counts(fa)
    stats = {k: v.cpu() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    times = []
    for _ in range(MC_TIMED_STEPS):
        t0 = time.perf_counter()
        float(step(batch)["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    # where a step's time goes: one profiled step (the collectives' kernels
    # apart; not for the gloo processes that share one card, which cost the
    # most and tell the least), and an all-reduce of a gradient-sized f32
    # buffer alone
    split = {"kernels_ms": None, "collective_ms": None, "k2_ms": None, "k2_mma_ms": None}
    if job.get("profile", True):
        by_name = kernel_profile(torch, lambda: float(step(batch)["loss"]),
                                 f"multicard step, process {rank} of {world}")
        split = {"kernels_ms": sum(by_name.values()),
                 "collective_ms": sum(ms for k, ms in by_name.items()
                                      if "nccl" in k.lower() or "gloo" in k.lower()),
                 # f32 K2 by name: its wgmma pair, and its mma.sync pair
                 "k2_ms": sum(ms for k, ms in by_name.items()
                              if any(n in k for n in F32_K2_KERNELS)),
                 "k2_mma_ms": sum(ms for k, ms in by_name.items()
                                  if "flash_bwd_d" in k and "_tf32_kernel" in k)}
    if world > 1:
        import torch.distributed as dist

        buf = torch.zeros(sum(p.numel() for p in model.parameters()), device="cuda")
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        split["grad_allreduce_ms"] = (time.perf_counter() - t0) * 1e3
    return {"losses": losses, "ms": statistics.median(times), "launches": launches,
            "stats": stats, **split}


def multicard_child(argv) -> int:
    """One process of part (b): ``chip_smoke.py --multicard-child RANK WORLD
    PORT DIR``; joins the group (gloo on one card, NCCL over several), runs
    ``_mc_f32_run`` on its rows and saves what it saw in DIR."""
    import numpy as np
    import torch

    from buctd_tpu_torch.ops import flash_attention as fa
    from buctd_tpu_torch.parallel.distributed import initialize_distributed, shutdown_distributed

    rank, world, port, root = int(argv[0]), int(argv[1]), int(argv[2]), Path(argv[3])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one card: two processes on it over gloo (NCCL refuses two ranks on one
    # GPU); several: one process a card over NCCL
    backend = "gloo" if torch.cuda.device_count() == 1 else None
    if not initialize_distributed(f"localhost:{port}", world, rank, device="cuda",
                                  backend=backend):
        raise AssertionError("no process group")
    job = torch.load(root / "job.pt", weights_only=False)
    out = _mc_f32_run(torch, np, fa, job, rank, world)
    torch.save(out, root / f"out{rank}.pt")
    shutdown_distributed()
    return 0


def multicard_phase(torch, np, fa, card: str) -> dict:
    """The multi-card paths on the one H100, CoAM-W48 at full width
    (CONFIG, random N(0, 1/fan_in) weights):

    (a) DDP at NCCL world size 1 (parallel/distributed.py over
        tcp://localhost), the yaml's bf16 step: 2 steps of MC_NCCL_BATCH
        rows under DistributedDataParallel equal 2 steps without it bit for
        bit (losses and every parameter and buffer; cuDNN deterministic
        for both);
    (b) two processes on the one card over gloo (NCCL refuses two ranks on
        one GPU), MC_GLOBAL_BATCH rows, f32, dropout 0, SGD at MC_LR: the DDP step
        with global-batch BatchNorm, 2 steps, the losses within
        MC_LOSS_ATOL + MC_LOSS_RTOL x |one process's| (JAX's tolerance for
        its own sharded steps); the BN running statistics' largest gap
        printed; ms/step of both;
    (c) PoseEstimator(mesh=) with two replicas on cuda:0, f32, ROUNDS
        rounds: predict_batch of MC_SERVE_IMAGES images within EXPORT_ATOL
        of the one-device estimator on each replica's block of images (the
        shapes each replica runs); the gap to it on the whole batch at once
        printed.
    K1 and K2 launches of each part's main path are counted.  On a machine
    with several cards (``chip_smoke.py --multicard``) part (b) runs one
    process a card over NCCL, part (c) one replica a card, and (d) runs
    train.run and valid.run under torchrun (``_mc_entry_points``)."""
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.parallel import make_mesh
    from buctd_tpu_torch.parallel.distributed import initialize_distributed, shutdown_distributed
    from buctd_tpu_torch.serving import PoseEstimator

    res = {}
    with tempfile.TemporaryDirectory(prefix="buctd_multicard_") as tmp:
        root = Path(tmp)
        torch.manual_seed(17)
        model = get_model(_mc_config(["TPU.COMPUTE_DTYPE", "float32"]))
        randomize(torch, model)
        torch.save(model.state_dict(), root / "weights.pth")
        del model

        # (a) NCCL at world size 1: DDP vs no DDP, bit for bit
        t0 = time.perf_counter()
        port = _free_port()
        if not initialize_distributed(f"localhost:{port}", 1, 0, device="cuda"):
            raise AssertionError("(a): no process group")
        import torch.distributed as dist

        backend = dist.get_backend()
        bench, det = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
        runs = {}
        try:
            for ddp in (True, False):
                torch.manual_seed(5)        # the channel attention's nn.Dropout draws from it
                cfg = _mc_config([])
                model = get_model(cfg)
                model.load_state_dict(torch.load(root / "weights.pth", weights_only=True))
                step = _mc_step(torch, cfg, model)
                if ddp:
                    step.run = torch.nn.parallel.DistributedDataParallel(
                        step.run, device_ids=[torch.device("cuda", 0)], broadcast_buffers=False)
                batch = _mc_batch(torch, np, MC_NCCL_BATCH, 5, "cuda")
                _mc_zero(fa)                           # the main path's run
                losses = [float(step(batch)["loss"]) for _ in range(2)]
                torch.cuda.synchronize()
                runs[ddp] = {"losses": losses, "launches": _mc_counts(fa),
                             "state": {k: v.clone() for k, v in model.state_dict().items()}}
                del step, model
        finally:
            torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = bench, det
            shutdown_distributed()
        same = runs[True]["losses"] == runs[False]["losses"] and all(
            torch.equal(v, runs[False]["state"][k]) for k, v in runs[True]["state"].items())
        # bf16: K1 and K2 on the wgmma kernels
        want = {**{k: 2 * 2 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
                **k2_wgmma_want(2 * 2), **_mc_k1_want(2 * 2, False)}
        print(f"multicard (a) {backend} world size 1, CoAM-W48 bf16 batch {MC_NCCL_BATCH}: DDP "
              f"losses {runs[True]['losses']}, without DDP {runs[False]['losses']}, bit for "
              f"bit (losses, {len(runs[True]['state'])} tensors): {same}; launches "
              f"{runs[True]['launches']} (want {want}); {time.perf_counter() - t0:.1f} s",
              flush=True)
        if backend != "nccl" or not same or runs[True]["launches"] != want:
            raise AssertionError("(a): DDP at NCCL world size 1 differs from the plain steps")
        res["nccl_launches"] = runs[True]["launches"]
        del runs
        torch.cuda.empty_cache()

        # (b) one process on the global batch, then two processes over gloo
        t0 = time.perf_counter()
        opts = ["TPU.COMPUTE_DTYPE", "float32", "TRAIN.OPTIMIZER", "sgd", "TRAIN.LR", MC_LR]
        job = {"opts": opts, "weights": str(root / "weights.pth")}
        torch.save(job, root / "job.pt")
        # cuDNN's heuristics, as in the processes (an earlier phase's
        # CUDNN.BENCHMARK would pick algorithms by timing, run by run)
        bench = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False
        try:
            one = _mc_f32_run(torch, np, fa, job, 0, 1)
        finally:
            torch.backends.cudnn.benchmark = bench
        torch.cuda.empty_cache()
        port = _free_port()
        cards = torch.cuda.device_count()
        world = 2 if cards == 1 else cards
        torch.save(dict(job, profile=cards > 1), root / "job.pt")
        # NCCL names its transports (P2P, SHM, NET) in its INFO lines
        env = dict(os.environ, NCCL_DEBUG="INFO") if cards > 1 else None
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--multicard-child", str(r), str(world), str(port), str(root)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=env)
                 for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"(b): process {r} failed:\n{out[-4000:]}")
        two = [torch.load(root / f"out{r}.pt", weights_only=False) for r in range(world)]
        transports = sorted({line.split(" via ")[1].split()[0] for out in outs
                             for line in out.splitlines() if " via " in line})
        gaps = [abs(a - b) for a, b in zip(two[0]["losses"], one["losses"])]
        stat_gap = max(float((two[0]["stats"][k] - v).abs().max() / v.abs().max().clamp(min=1e-30))
                       for k, v in one["stats"].items())
        # f32: K1 and K2 on the f32 wgmma kernels
        want = {**{k: 2 * 2 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
                **k2_wgmma_want(0, f32=2 * 2), **_mc_k1_want(2 * 2, True)}
        where = ("2 processes on the one card over gloo" if cards == 1
                 else f"{world} processes, one a card, over NCCL")
        print(f"multicard (b) {where}, CoAM-W48 f32 global batch {MC_GLOBAL_BATCH}: losses "
              f"{[t['losses'] for t in two]}, one process {one['losses']}, gaps {gaps} (limit "
              f"{MC_LOSS_ATOL} + {MC_LOSS_RTOL} x |ref|); BN running statistics' largest gap "
              f"{stat_gap:.3e} of their tensor's max; ms/step: one process "
              f"{one['ms']:.2f} ({MC_GLOBAL_BATCH} rows), {world} processes "
              f"{[round(t['ms'], 2) for t in two]} ({MC_GLOBAL_BATCH // world} rows each); "
              f"launches a process {[t['launches'] for t in two]} (want {want}); card: {card}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        profiled = (f"{world} processes {[round(t['kernels_ms'], 2) for t in two]} ms of "
                    f"kernels, of which collectives "
                    f"{[round(t['collective_ms'], 2) for t in two]}" if cards > 1
                    else "the gloo processes not profiled")
        print(f"multicard (b) a profiled step: one process {one['kernels_ms']:.2f} ms of "
              f"kernels, of which f32 K2's wgmma pair {one['k2_ms']:.2f} ms "
              f"({100 * one['k2_ms'] / one['kernels_ms']:.1f}%; its mma.sync pair "
              f"{one['k2_mma_ms']:.2f} ms); {profiled}; an all-reduce of a gradient-sized f32 "
              f"buffer alone {[round(t['grad_allreduce_ms'], 2) for t in two]} ms; "
              f"transports {transports or 'gloo'}", flush=True)
        if not one["k2_ms"] > 0.0 or one["k2_mma_ms"]:
            raise AssertionError("(b): the profiled f32 step names no f32 K2 wgmma kernel, or "
                                 "an mma.sync one")
        if any(t["losses"] != two[0]["losses"] for t in two):
            raise AssertionError("(b): the processes' global losses differ")
        if not all(g <= MC_LOSS_ATOL + MC_LOSS_RTOL * abs(r)
                   for g, r in zip(gaps, one["losses"])):
            raise AssertionError("(b): two processes' losses off the one process's")
        if any(t["launches"] != want for t in two) or one["launches"] != want:
            raise AssertionError("(b): K1/K2 launches off")
        for label, runs_b in (("multicard (b) one process", [one]),
                              (f"multicard (b) {where}", two)):
            n = sum(t["launches"]["flash_fwd"] for t in runs_b)
            F32_WGMMA_PATHS[label] = {"f32_k1": n, "f32_mma": 0, "f32_wgmma": sum(
                t["launches"]["flash_fwd_f32_wgmma_launches"] for t in runs_b)}
        res.update(one_ms=one["ms"], two_ms=[t["ms"] for t in two], loss_gaps=gaps, world=world,
                   one_kernels_ms=one["kernels_ms"], one_k2_ms=one["k2_ms"],
                   one_launches=one["launches"],
                   kernels_ms=[t["kernels_ms"] for t in two],
                   collective_ms=[t["collective_ms"] for t in two],
                   grad_allreduce_ms=[t["grad_allreduce_ms"] for t in two],
                   transports=transports,
                   stat_gap=stat_gap,
                   gloo_launches={k: sum(t["launches"][k] for t in two) for k in want})

        # (c) mesh= serving: two replicas on cuda:0
        t0 = time.perf_counter()
        cfg = _mc_config([])
        single = PoseEstimator(cfg, checkpoint=str(root / "weights.pth"), refine_iters=ROUNDS)
        # one card: two replicas on it; several: one a card (make_mesh's default)
        mesh = make_mesh(devices=["cuda:0", "cuda:0"] if cards == 1 else None)
        est = PoseEstimator(cfg, checkpoint=str(root / "weights.pth"), refine_iters=ROUNDS,
                            mesh=mesh)
        rng = np.random.RandomState(17)
        reqs = [sample_request(np, rng) for _ in range(MC_SERVE_IMAGES * max(cards // 2, 1))]
        images, poses = [r[0] for r in reqs], [r[1] for r in reqs]
        keep = float("-inf")
        # the one-device estimator on each replica's block (the same shapes),
        # and on the whole batch (other shapes: cuDNN may pick other
        # algorithms, and a near-tie in the decode moves a joint)
        k = len(est._replicas)
        n = len(reqs) // k
        want_out = [p for b in range(k) for p in single.predict_batch(
            images[b * n:(b + 1) * n], poses[b * n:(b + 1) * n], keep)]
        whole = single.predict_batch(images, poses, keep)
        zero_k1(fa)                                    # the main path's run
        got = est.predict_batch(images, poses, keep)
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        f32_k1_wgmma(fa, "multicard mesh= serving")
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want_out))
        whole_err = max(float(np.abs(g - w).max()) for g, w in zip(got, whole))
        # each replica: its block's bucket, two warm-ups and one replay, 2 K1 a
        # forward, ROUNDS rounds
        want_k1 = len(est._replicas) * 3 * 2 * ROUNDS
        print(f"multicard (c) mesh= serving, {len(est._replicas)} replicas on "
              f"{sorted({str(d) for d in mesh.devices})}, count buckets {est.count_buckets}: "
              f"predict_batch of {len(reqs)} images {err:.3e} px from the one-device "
              f"estimator on each replica's {n} images (limit {EXPORT_ATOL}), {whole_err:.3e} "
              f"px from it on all {len(reqs)} at once; K1 launches "
              f"{launches} (want {want_k1}); {time.perf_counter() - t0:.1f} s", flush=True)
        if not all(np.isfinite(g).all() for g in got) or not err <= EXPORT_ATOL:
            raise AssertionError("(c): mesh= serving off the one-device estimator")
        if launches != want_k1:
            raise AssertionError("(c): K1 launches off")
        res["mesh_launches"] = launches
        res["mesh_err"] = err
        res["mesh_whole_err"] = whole_err
        del est, single
        torch.cuda.empty_cache()
        if cards > 1:
            res["entry"] = _mc_entry_points(np, root, cards)
    return res


def _mc_torchrun(cards: int, module: str, args: list, label: str) -> float:
    """``module``'s main under torchrun, one process a card (NCCL); raises
    with the output's tail where it fails; returns its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", str(cards), "-m", module, *args],
                          capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    if proc.returncode != 0:
        raise AssertionError(f"(d) {label}: rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    return time.perf_counter() - t0


def _mc_entry_points(np, root: Path, cards: int) -> dict:
    """(d), several cards only: the entry points under torchrun, one process
    a card over NCCL, on the stock yaml (the host cv2 Loader): train.run one
    epoch of one global step of MC_GLOBAL_BATCH with its validation (the
    merge over the gloo group beside NCCL), then valid.run of its
    final_state.pth; every process's results equal process 0's, and one
    process's valid.run of the same weights gives the same rows, its
    keypoints' largest gap printed and the share within EXPORT_ATOL px
    gated at 0.99 (other batch sizes, other cuDNN algorithms)."""
    from buctd_tpu_torch.valid import run as valid_run

    train_root, test_root = root / "train", root / "test"
    train_root.mkdir()
    test_root.mkdir()
    images = MC_GLOBAL_BATCH // SYNTH_PEOPLE
    train_ann = write_synthetic_set(np, train_root, images, SYNTH_PEOPLE)
    test_ann = write_synthetic_set(np, test_root, images, SYNTH_PEOPLE, seed=11)
    bu = write_bu_predictions(np, test_ann, test_root)
    per = str(MC_GLOBAL_BATCH // cards)
    test = ["DATASET.TEST_IMAGE_DIR", str(test_root), "DATASET.TEST_ANNOTATION_FILE",
            str(test_ann), "TEST.COCO_BBOX_FILE", str(bu), "TEST.BATCH_SIZE_PER_GPU", per]
    train_s = _mc_torchrun(cards, "buctd_tpu_torch.train.run", [
        "--cfg", str(CONFIG), "DATASET.TRAIN_IMAGE_DIR", str(train_root),
        "DATASET.TRAIN_ANNOTATION_FILE", str(train_ann), "TRAIN.BATCH_SIZE_PER_GPU", per,
        "TRAIN.END_EPOCH", "1", "OUTPUT_DIR", str(root / "out"), "LOG_DIR", str(root / "log"),
        *test], "train.run")
    out = next((root / "out").glob("*/*/*"))
    checks = {"checkpoint.pth": (out / "checkpoint.pth").exists(),
              "final_state.pth": (out / "final_state.pth").exists(),
              "logs": len(list(out.glob("*.log"))),
              "metrics.jsonl": len(list((root / "log").glob("**/metrics.jsonl")))}
    name = "results/keypoints_test_results_epoch0.json"
    dirs = [out] + [out / f"proc{r}" for r in range(1, cards)]
    train_rows = [json.loads((d / name).read_text()) for d in dirs]
    valid_s = _mc_torchrun(cards, "buctd_tpu_torch.valid.run", [
        "--cfg", str(CONFIG), "TEST.MODEL_FILE", str(out / "final_state.pth"),
        "OUTPUT_DIR", str(root / "eval"), *test], "valid.run")
    ev = next((root / "eval").glob("*/*/*"))
    rows = [json.loads((d / name).read_text())
            for d in [ev] + [ev / f"proc{r}" for r in range(1, cards)]]
    one = valid_run.main(["--cfg", str(CONFIG), "TEST.MODEL_FILE", str(out / "final_state.pth"),
                          "OUTPUT_DIR", str(root / "one"), *test])
    want = json.loads((one["output_dir"] / name).read_text())
    gaps = np.array([np.abs(np.subtract(g["keypoints"], w["keypoints"])).max()
                     for g, w in zip(rows[0], want)])
    same_rows = [(g["image_id"], g["category_id"]) for g in rows[0]] == \
        [(w["image_id"], w["category_id"]) for w in want]
    share = float((gaps <= EXPORT_ATOL).mean()) if len(gaps) else 0.0
    print(f"multicard (d) torchrun, {cards} processes over NCCL: train.run {train_s:.1f} s "
          f"(files {checks}; its validation's results alike on every process: "
          f"{all(r == train_rows[0] for r in train_rows)}, {len(train_rows[0])} rows), "
          f"valid.run {valid_s:.1f} s (results alike on every process: "
          f"{all(r == rows[0] for r in rows)}); one process's valid.run: same rows "
          f"{same_rows}, keypoints' largest gap {gaps.max() if len(gaps) else -1:.3e} px, share "
          f"within {EXPORT_ATOL} px {share:.4f}", flush=True)
    if checks != {"checkpoint.pth": True, "final_state.pth": True, "logs": 1,
                  "metrics.jsonl": 1}:
        raise AssertionError(f"(d): train.run's files {checks}")
    if not (all(r == train_rows[0] for r in train_rows) and all(r == rows[0] for r in rows)
            and len(rows[0]) == MC_GLOBAL_BATCH and same_rows and share >= 0.99):
        raise AssertionError("(d): the processes' or the one process's results differ")
    return {"train_s": train_s, "valid_s": valid_s, "max_gap_px": float(gaps.max()),
            "share": share}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


ORBAX_FIXTURE = ROOT / "tests" / "fixtures" / "orbax_coam_tiny"
# CoAM-W48 at full width (CONFIG, no overrides): 463 MB of f32 in patterns
ORBAX_FULL = ROOT / "tests" / "fixtures" / "orbax_coam_w48"
ORBAX_MIN_TIMED_S = 0.5                 # libzstd's MB/s over at least this long
ORBAX_TRAIN_STEPS = 2
ORBAX_EVAL_IMAGES = 8                   # x 4 people = 32 crops = 1 batch of 32


def orbax_phase(torch, np, fa, tw, card: str) -> dict:
    """JAX's orbax checkpoints in the port (train/checkpoint.py over the
    system's libzstd), on the card's host, from the committed fixtures
    (JAX's save_params, written by tests/make_orbax_fixture.py, with the
    yaml, overrides and every leaf's SHA-256 in each expected.json):

    * ORBAX_FULL, CoAM-W48 at full width: ``load_params`` timed (the read
      that decides start-up), its leaves equal to expected.json, libzstd's
      MB/s over its chunks, each decoded again and again for
      ORBAX_MIN_TIMED_S on one thread; PoseEstimator(checkpoint=<dir>) in
      f32 and in bf16 on the card at the main path's shapes (ROUNDS rounds):
      predict and predict_batch bit for bit equal to the estimator loaded
      from a .pth of the same state_dict, K1 launched 2 x ROUNDS a forward
      in each bucket's two warm-ups and first replay;
    * ORBAX_FIXTURE, a narrow CoAM: its leaves equal to expected.json;
      valid.run with TEST.MODEL_FILE <dir> (one round of ORBAX_EVAL_IMAGES
      x SYNTH_PEOPLE crops, the device loader) and train.run --steps
      ORBAX_TRAIN_STEPS with TEST.MODEL_FILE <dir>: the weights the entry
      points start from equal the fixture's, AP in [0, 1], finite losses,
      K1, K2 and K4 counted."""
    from buctd_tpu_torch.config import default_config, update_config
    from buctd_tpu_torch.convert import load_orbax_checkpoint
    from buctd_tpu_torch.serving import PoseEstimator
    from buctd_tpu_torch.train import run as train_run
    from buctd_tpu_torch.train.checkpoint import OcdbtStore, leaf_digests, load_params
    from buctd_tpu_torch.utils import zstd
    from buctd_tpu_torch.valid import run as valid_run

    def read(fixture):
        """The fixture's expected.json, directory, tree, read seconds, and
        the leaves that differ from expected.json."""
        expected = json.loads((fixture / "expected.json").read_text())
        ckpt = fixture / "checkpoint"
        t0 = time.perf_counter()
        tree = load_params(ckpt)
        read_s = time.perf_counter() - t0
        digests = leaf_digests(tree)
        bad = sorted(k for k in set(digests) | set(expected["leaves"])
                     if digests.get(k) != expected["leaves"].get(k))
        if bad:
            raise AssertionError(f"orbax: {fixture.name}'s leaves {bad[:5]} differ from "
                                 f"expected.json ({len(bad)} of {len(digests)})")
        return expected, ckpt, tree, read_s

    t0 = time.perf_counter()
    zstd._lib()
    lib_s = time.perf_counter() - t0
    expected, ckpt, tree, read_s = read(ORBAX_FULL)
    nbytes = sum(int(np.prod(v["shape"])) * np.dtype(v["dtype"]).itemsize
                 for v in expected["leaves"].values())
    del tree
    with OcdbtStore(ckpt) as store:
        chunks = [store.get(k) for k in store.keys() if not k.endswith(b"/.zarray")]
    raw = sum(len(zstd.decompress(c)) for c in chunks)
    reps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < ORBAX_MIN_TIMED_S:
        for c in chunks:
            zstd.decompress(c)
        reps += 1
    mb_s = reps * raw / (time.perf_counter() - t0) / 1e6
    print(f"orbax: libzstd loaded in {lib_s:.3f} s; CoAM-W48 at full width: "
          f"{len(expected['leaves'])} leaves, {nbytes} bytes, read by load_params in "
          f"{read_s:.3f} s ({nbytes / read_s / 1e6:.1f} MB/s, up to 8 threads), equal to "
          f"expected.json; libzstd {mb_s:.1f} MB/s over its {len(chunks)} chunks "
          f"({sum(map(len, chunks))} bytes -> {raw} bytes, {reps} passes; one host thread); "
          f"card: {card}", flush=True)
    res = {"mb_s": mb_s, "read_s": read_s, "read_bytes": nbytes,
           "leaves": len(expected["leaves"]),
           "launches": {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                        "warp_resample": 0}}
    counted = {"flash_fwd": fa.flash_attention, "flash_bwd_dq": fa.flash_bwd_dq,
               "flash_bwd_dkv": fa.flash_bwd_dkv, "warp_resample": tw.warp_resample}

    def config(yaml, opts, *more):
        cfg = default_config()
        update_config(cfg, types.SimpleNamespace(cfg=str(yaml), opts=list(opts) + list(more)))
        return cfg

    t0 = time.perf_counter()
    sd = load_orbax_checkpoint(ckpt)
    convert_s = time.perf_counter() - t0
    rng = np.random.RandomState(18)
    img, conds = sample_request(np, rng)
    batch = [sample_request(np, rng) for _ in range(3)]
    want = 2 * ROUNDS * 2 * 3        # K1 2 a forward; two buckets' warm-ups and first replay
    with tempfile.TemporaryDirectory(prefix="buctd_orbax_") as tmp:
        root = Path(tmp)
        pth = root / "coam_w48.pth"
        torch.save(sd, pth)
        del sd
        for dtype in ("float32", "bfloat16"):
            outs, k1, start = {}, {}, {}
            for source in (str(ckpt), str(pth)):
                zero_k1(fa)                                  # the main path's run
                t0 = time.perf_counter()
                est = PoseEstimator(config(CONFIG, (), "TPU.EVAL_DTYPE", dtype),
                                    checkpoint=source, refine_iters=ROUNDS)
                start[source] = time.perf_counter() - t0
                outs[source] = [est.predict(img, conds, float("-inf")),
                                *est.predict_batch([b[0] for b in batch],
                                                   [b[1] for b in batch], float("-inf"))]
                torch.cuda.synchronize()
                k1[source] = fa.flash_attention.launches
                f32_k1_wgmma(fa, f"orbax serving {dtype}")
                del est
                torch.cuda.empty_cache()
            same = all(np.array_equal(a, b) for a, b in zip(outs[str(ckpt)], outs[str(pth)]))
            finite = all(o.shape == (4, 14, 3) and np.isfinite(o).all()
                         for o in outs[str(ckpt)])
            print(f"orbax: CoAM-W48 PoseEstimator(checkpoint=<dir>) {dtype}, {ROUNDS} rounds, "
                  f"480x640 with 4 poses and a batch of 3: predict and predict_batch bit for "
                  f"bit the .pth estimator's: {same}, finite {finite}; K1 launches "
                  f"{k1[str(ckpt)]} (the .pth estimator {k1[str(pth)]}, want {want}); "
                  f"estimator built in {start[str(ckpt)]:.2f} s from the directory, "
                  f"{start[str(pth)]:.2f} s from the .pth (load_orbax_checkpoint alone "
                  f"{convert_s:.2f} s)", flush=True)
            if not (same and finite and k1[str(ckpt)] == k1[str(pth)] == want):
                raise AssertionError(f"orbax: the {dtype} estimator from the directory "
                                     f"differs or launched K1 {k1} times (want {want})")
            res["launches"]["flash_fwd"] += k1[str(ckpt)]
            res[f"serving_{dtype}"] = {"launches": k1[str(ckpt)], "same": same,
                                       "start_s": start[str(ckpt)]}
        res["convert_s"] = convert_s

        expected, ckpt, _, _ = read(ORBAX_FIXTURE)
        sd = load_orbax_checkpoint(ckpt)
        yaml, opts = ROOT / expected["cfg"], list(expected["opts"])
        ann = write_synthetic_set(np, root, ORBAX_EVAL_IMAGES, SYNTH_PEOPLE, seed=18)
        bu = write_bu_predictions(np, ann, root)
        data = ["DATASET.TEST_IMAGE_DIR", str(root), "DATASET.TEST_ANNOTATION_FILE", str(ann),
                "DATASET.TRAIN_IMAGE_DIR", str(root), "DATASET.TRAIN_ANNOTATION_FILE", str(ann),
                "TPU.DEVICE_PIPELINE", "True", "TEST.MODEL_FILE", str(ckpt)]
        for f in counted.values():
            f.launches = 0                                   # the main path's run
        zero_k1(fa)
        out = valid_run.main(["--cfg", str(yaml), *opts, *data, "TEST.COCO_BBOX_FILE", str(bu),
                              "TEST.BATCH_SIZE_PER_GPU", str(EVAL_BATCH), "PRINT_FREQ", "100",
                              "OUTPUT_DIR", str(root / "eval")])
        got = {k: f.launches for k, f in counted.items()}
        f32_k1_wgmma(fa, "orbax valid.run (the narrow fixture: d = 4 and 8)", model_path=False)
        r = out["rounds"][0]
        start_same = all(torch.equal(t.cpu(), sd[k]) for k, t in out["model"].state_dict().items())
        print(f"orbax: valid.run with TEST.MODEL_FILE <dir>: AP {r['AP']!r}, {r['crops']} "
              f"crops, {r['crops'] / r['loop_s']:.2f} crops/s, the fixture's weights: "
              f"{start_same}; launches {got}", flush=True)
        _check_round(np, "orbax valid.run", r, ORBAX_EVAL_IMAGES * SYNTH_PEOPLE)
        if not (start_same and got["flash_fwd"] > 0 and got["warp_resample"] > 0):
            raise AssertionError(f"orbax: valid.run from the directory: weights {start_same}, "
                                 f"launches {got}")
        for k in got:
            res["launches"][k] += got[k]
        res["eval"] = {"ap": r["AP"], "launches": got}

        for f in counted.values():
            f.launches = 0                                   # the main path's run
        zero_k1(fa)
        zero_k2(fa)
        # cuDNN's heuristics: with CUDNN.BENCHMARK the narrow model's first
        # step took 27.6 s on an H100 timing its new shapes (the second 2.6 s)
        trained = train_run.main(["--cfg", str(yaml), "--steps", str(ORBAX_TRAIN_STEPS),
                                  "--no-eval", "--seed", "0", *opts, *data,
                                  "CUDNN.BENCHMARK", "False", "OUTPUT_DIR", str(root / "train")])
        got = {k: f.launches for k, f in counted.items()}
        f32_k1_wgmma(fa, "orbax train.run (the narrow fixture: d = 4 and 8)", model_path=False)
        by_kernel = k2_by_kernel(fa)
        losses = [float(m["loss"]) for st in trained["stats"] for m in st["metrics"]]
        print(f"orbax: train.run --steps {ORBAX_TRAIN_STEPS} with TEST.MODEL_FILE <dir>: "
              f"{trained['steps']} steps, losses {[round(x, 6) for x in losses]}; launches "
              f"{got}, K2 by kernel {by_kernel}", flush=True)
        if (trained["steps"] != ORBAX_TRAIN_STEPS or not np.isfinite(losses).all()
                or min(got.values()) == 0):
            raise AssertionError(f"orbax: train.run from the directory: {trained['steps']} "
                                 f"steps, losses {losses}, launches {got}")
        for k in got:
            res["launches"][k] += got[k]
        res["train"] = {"losses": losses, "launches": got, "k2_by_kernel": by_kernel}
    return res


PARITY_IMAGES = 8                       # x 4 people = 32 crops = 1 batch of 32
PARITY_ROUNDS = 3


def parity_phase(torch, np, fa, tw, card: str) -> dict:
    """The AP-parity runner (buctd_tpu_torch/tools/parity_eval.py) in
    process through its ``main``, on the card at full width: CoAM-W48 from
    the committed orbax fixture ORBAX_FULL with its expected.json's yaml
    (the README's crowdpose CoAM row, target 78.5), f32 (3xTF32 K1),
    PARITY_ROUNDS refinement rounds on a seeded synthetic CrowdPose set of
    PARITY_IMAGES x SYNTH_PEOPLE crops from a BU json, one batch of
    EVAL_BATCH a round, through the host cv2 Loader.  At random weights the
    verdict must be FAIL with exit code 1; the table row is printed; the
    last JSON line's keys are there, its ap the trajectory's last, three
    finite APs in [0, 100] and ``pass`` as ``delta`` says; each round's
    results json has one entry a crop with finite keypoints, and round 1's
    centers differ from round 0's; K1 launched 2 a batch a round plus the
    summary forward's, K1' and K4 never."""
    from buctd_tpu_torch import convert
    from buctd_tpu_torch.tools import parity_eval

    expected = json.loads((ORBAX_FULL / "expected.json").read_text())
    counted = {"flash_fwd": fa.flash_attention, "flash_fwd_kvres": fa.flash_attention_kvres,
               "warp_resample": tw.warp_resample}
    crops = PARITY_IMAGES * SYNTH_PEOPLE
    batches = -(-crops // EVAL_BATCH)
    read_s = []
    load = convert.load_checkpoint

    def timed_load(path):
        t0 = time.perf_counter()
        sd = load(path)
        read_s.append(time.perf_counter() - t0)
        return sd

    with tempfile.TemporaryDirectory(prefix="buctd_parity_") as tmp:
        root = Path(tmp)
        ann = write_synthetic_set(np, root, PARITY_IMAGES, SYNTH_PEOPLE, seed=21)
        bu = write_bu_predictions(np, ann, root)
        argv = ["--cfg", str(ROOT / expected["cfg"]), "--pth", str(ORBAX_FULL / "checkpoint"),
                "--ann", str(ann), "--img-dir", str(root), "--refine-iters", str(PARITY_ROUNDS),
                "--out", str(root / "out"), *expected["opts"], "TEST.COCO_BBOX_FILE", str(bu),
                "TEST.BATCH_SIZE_PER_GPU", str(EVAL_BATCH), "PRINT_FREQ", "100",
                "LOG_DIR", str(root / "log")]
        out = io.StringIO()
        convert.load_checkpoint = timed_load
        try:
            for f in counted.values():
                f.launches = 0                               # the main path's run
            zero_k1(fa)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                verdict, rc = parity_eval.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            convert.load_checkpoint = load
        got = {k: f.launches for k, f in counted.items()}
        f32_k1_wgmma(fa, "parity_eval")
        printed = out.getvalue()
        print(printed, end="", flush=True)
        run = verdict["run"]
        want = {"flash_fwd": 2 * batches * PARITY_ROUNDS + run["summary"]["flash_calls"],
                "flash_fwd_kvres": 0, "warp_resample": 0}
        lines = printed.strip().splitlines()
        last = json.loads(lines[-1])
        traj = last["refine_trajectory"]
        rows = [json.loads(Path(r["results"]).read_text()) for r in run["rounds"]]
        crops_s = [r["crops"] / r["loop_s"] for r in run["rounds"]]
        print(f"parity: tools/parity_eval.py main, CoAM-W48 from the orbax fixture (read in "
              f"{read_s[0]:.3f} s), {PARITY_ROUNDS} rounds of {crops} crops: rc {rc}, verdict "
              f"{verdict['verdict']}, trajectory {traj}; crops/s by round "
              f"{[round(c, 2) for c in crops_s]}; launches {got}, expected {want}; phase "
              f"{seconds:.1f} s; card: {card}", flush=True)
        row = (f"| crowdpose | pose_hrnet_coam | {last['ap']:.2f} | 78.5 | "
               f"{last['delta']:+.2f} | FAIL |")
        if not (rc == 1 and verdict["verdict"] == "FAIL" and row in lines):
            raise AssertionError(f"parity: rc {rc}, verdict {verdict['verdict']}, the row "
                                 f"{row!r} printed: {row in lines}")
        if not (set(last) == {"ap", "expected", "delta", "pass", "refine_trajectory"}
                and last["expected"] == 78.5 and len(traj) == PARITY_ROUNDS
                and last["ap"] == traj[-1] and np.isfinite(traj).all()
                and all(0.0 <= a <= 100.0 for a in traj)
                and last["pass"] == (abs(last["delta"]) <= parity_eval.AP_TOLERANCE
                                     or last["delta"] > 0)):
            raise AssertionError(f"parity: the last line {last}")
        finite = all(np.isfinite(e["keypoints"]).all() for r in rows for e in r)
        if [len(r) for r in rows] != [crops] * PARITY_ROUNDS or not finite or all(
                a["center"] == b["center"] for a, b in zip(rows[0], rows[1])):
            raise AssertionError(f"parity: results {[len(r) for r in rows]} (want {crops} "
                                 f"each), keypoints finite {finite}, or round 1's centers "
                                 f"as round 0's")
        if got != want:
            raise AssertionError(f"parity: launches {got} != {want}")
    return {"launches": got, "read_s": read_s[0], "crops_s": crops_s, "seconds": seconds,
            "trajectory": traj}


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
    from buctd_tpu_torch.tools.bench_exp2 import sm_clock_hz

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
    phase_s, last = {}, [start]

    def mark(name):
        """Seconds since the previous mark, kept as the phase's time."""
        now = time.perf_counter()
        phase_s[name] = round(now - last[0], 1)
        last[0] = now
        print(f"phase {name}: {phase_s[name]} s", flush=True)

    names = _build.build_all()
    print(f"built {names} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in names:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    from concurrent.futures import ThreadPoolExecutor

    sass_pool = ThreadPoolExecutor(1)
    sass = sass_pool.submit(sass_counts)            # on the host beside the NaN phase
    mark("build")
    nan_phase(torch, fa, fb)
    mark("nan")
    # the disassemblies end before the timed phases: their host threads
    # delayed the launches there (host gaps inside a CUDA-event timing)
    check_sass(sass.result())
    sass_pool.shutdown()
    mark("sass")
    k1 = kernel_phase(torch, F, fa)
    mark("kernel")
    main_k1 = k1["main"]
    tk = train_kernel_phase(torch, F, fa, tw)
    mark("train_kernel")
    tp_k = transpose_kernel_phase(torch, F, fa, tk)
    mark("transpose_kernel")
    kv = kvres_kernel_phase(torch, F, fa)
    mark("kvres_kernel")

    def serve(config, k1_per_forward, group, exact_ref=False):
        serving = serving_phase(torch, np, fa, config, k1_per_forward, exact_ref)
        est = serving["est"]
        profile = f32_k1_profile(kernel_profile(
            torch, lambda: est.predict_batch(serving["images"], serving["poses"],
                                             float("-inf")),
            f"{config.stem} predict_batch (3 images x 4 poses, 3 rounds)"), "predict_batch",
            group)
        del est, serving["est"]
        torch.cuda.empty_cache()
        return serving["launches"], profile

    serving_launches, serving_profile = serve(CONFIG, 2, "main")
    mark("serving")
    bf16_serving = bf16_serving_phase(torch, np, fa, CONFIG, 2)
    mark("bf16_serving")
    graph = graph_serving_phase(torch, np, fa, card)
    mark("graph_serving")
    tp_serving_launches, tp_serving_profile = serve(
        TRANSPOSE_CONFIG, TP_LAYERS, "tp_serving", True)
    tp_bf16_serving = bf16_serving_phase(torch, np, fa, TRANSPOSE_CONFIG, TP_LAYERS)
    mark("transpose_serving")
    train = training_phase(torch, np, fa, tw)
    mark("training")
    torch.cuda.empty_cache()
    synth = synthesis_phase(torch, np)
    mark("synthesis")
    train_synth = training_phase(torch, np, fa, tw, extra_opts=("TPU.DEVICE_SYNTHESIS", "True"),
                                 full=False)
    torch.cuda.empty_cache()
    options = options_phase(torch, np, fa, tw)
    mark("synth_training_and_options")
    torch.cuda.empty_cache()
    print(f"CoAM-W48 trainer, batch {TRAIN_BATCH}: host synthesis {train['ms_step']:.2f} ms/step "
          f"(data wait {train['data_ms']:.2f}, dispatch {train['dispatch_ms']:.2f}; resident "
          f"{train['resident_ms']:.2f}); card synthesis (TPU.DEVICE_SYNTHESIS) "
          f"{train_synth['ms_step']:.2f} ms/step (data wait {train_synth['data_ms']:.2f}, "
          f"dispatch {train_synth['dispatch_ms']:.2f}; resident "
          f"{train_synth['resident_ms']:.2f}): {train_synth['ms_step'] / train_synth['resident_ms']:.3f}x "
          f"its resident step; the card sampler {synth['device_ms']:.4f} ms a batch on the "
          f"card, {synth['wall_ms']:.4f} ms with the copy back", flush=True)
    # K1, dq, dkv and K4 launches of the trainer's other paths in this run
    more = {key: train_synth["launches"][key] + sum(o["launches"][i] for o in options.values())
            for i, key in enumerate(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                     "warp_resample"))}
    tp_train = training_phase(torch, np, fa, tw, TRANSPOSE_CONFIG, "coco", TP_LAYERS, True)
    mark("transpose_training")
    step_launches = card_vs_cpu_step(torch, np, fa)
    mark("card_vs_cpu_step")
    torch.cuda.empty_cache()
    ev = eval_phase(torch, np, fa, tw)
    mark("eval")
    torch.cuda.empty_cache()
    tp_ev = transpose_eval_phase(torch, np, fa, tw)
    mark("transpose_eval")
    torch.cuda.empty_cache()
    kv_train = kvres_training_phase(torch, np, fa)
    mark("kvres_training")
    torch.cuda.empty_cache()
    rn = resnet_phase(torch, np, fa, tw)
    mark("resnet")
    torch.cuda.empty_cache()
    lam = lambda_phase(torch, np, fa, tw)
    mark("lambda")
    torch.cuda.empty_cache()
    dsets = datasets_phase(torch, np, fa, tw)
    mark("datasets")
    torch.cuda.empty_cache()
    inf = inference_phase(torch, np, fa, ev["files"])
    mark("inference")
    torch.cuda.empty_cache()
    host = host_loader_phase(torch, np, fa, tw)
    mark("host_loader")
    torch.cuda.empty_cache()
    k5 = fused_block_phase(torch, fb)
    k5_trunk = fused_block_vs_trunk(torch, np, fb)
    k6 = exp_phase(torch, ex)
    mark("k5_k6")
    prenet_serving_phase(torch, np)
    prenet_bf16 = {knob: bf16_serving_phase(torch, np, fa, PRENET_CONFIG, 0,
                                            ("TPU.FUSED_PRENET", knob), knob == "off")
                   for knob in ("off", "auto")}
    tools = tools_phase(torch, fb, ex)
    mark("prenet_serving_and_tools")
    mc = multicard_phase(torch, np, fa, card)
    mark("multicard")
    orb = orbax_phase(torch, np, fa, tw, card)
    mark("orbax")
    torch.cuda.empty_cache()
    par = parity_phase(torch, np, fa, tw, card)
    mark("parity")

    def bound_by(ops_ms, bound_ms):
        return "operations" if ops_ms >= bound_ms else "bytes"

    def entry(name, source, replaces, launches, err, key):
        bound, ops = tk[f"{key}_bound_ms"], tk.get(f"{key}_ops_ms", 0.0)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": tk[f"{key}_ms"],
                "plain_ms": tk[f"{key}_plain_ms"], "bound_ms": bound,
                "bound_by": bound_by(ops, bound), "library_ms": tk[f"{key}_library_ms"]}

    # f32 K2 at TRAIN_CASES and TP_TRAIN_CASES, dropout 0.1, from
    # bench_flash_bwd in the tools phase: the wgmma pair, the mma.sync pair,
    # the SIMT kernels and SDPA's f32 backward alone (dq, dk, dv) in turns;
    # bounds: the 3xTF32, MUFU and hash floors and the bytes, at this run's SM
    # clock
    k2_f32 = [r for (l, d), r in tools["k2_f32"].items() if (TRAIN_BATCH, l, d) in TRAIN_CASES]
    k2_f32_tp = tools["k2_f32"][TP_TRAIN_CASES[0][1:]]
    clock = sm_clock_hz()

    def f32_bound(kind, cases):
        ops = sum(max(flash_floors_ms(bh, l, d, kind, clock, DROPOUT, "float32").values())
                  for bh, l, d in cases)
        # bwd_bound_ms: the larger of the 3xTF32 operations and the bytes
        bound = max(ops, sum(bwd_bound_ms(bh, l, d, 4, kind)[0] for bh, l, d in cases))
        return bound, bound_by(ops, bound)

    f32_bounds = {kind: f32_bound(kind, TRAIN_CASES) for kind in ("dq", "dkv")}

    def f32_bwd(kind, ms, launches, **more):
        # f32 K2/K2' at TRAIN_CASES, dropout 0.1; launches: the f32 train
        # step (K2), none (K2')
        return {"ms": ms, "simt_ms": sum(r["simt"][f"{kind}_ms"] for r in k2_f32),
                "library_ms": sum(r["sdpa_ms"] for r in k2_f32),
                "bound_ms": f32_bounds[kind][0], "bound_by": f32_bounds[kind][1],
                "launches": launches, **more}

    def k2_p0(r, kind):
        # bf16 K2 at dropout 0 over a phase's cases: the wgmma kernel, the
        # mma.sync one and SDPA's backward alone in turns, the bound
        return {"ms": r[f"{kind}_p0_ms"], "mma_ms": r[f"{kind}_p0_mma_ms"],
                "library_ms": r["k2_p0_library_ms"], "bound_ms": r[f"{kind}_p0_bound_ms"],
                "bound_by": bound_by(r[f"{kind}_p0_ops_ms"], r[f"{kind}_p0_bound_ms"])}

    def tp_bf16(kind, err_key):
        # bf16 at TP_TRAIN_CASES (d = 112), dropout 0.1 (K2 also 0); beside
        # each the mma.sync kernel in turns
        e = {"ms": tp_k[f"{kind}_ms"], "plain_ms": tp_k[f"{kind}_plain_ms"],
             "bound_ms": tp_k[f"{kind}_bound_ms"],
             "bound_by": bound_by(tp_k[f"{kind}_ops_ms"], tp_k[f"{kind}_bound_ms"]),
             "library_ms": tp_k[f"{kind}_library_ms"], "mma_ms": tp_k[f"{kind}_mma_ms"],
             "max_abs_err": tp_k[err_key]}
        if kind != "fwd":
            e["dropout_0"] = k2_p0(tp_k, kind)
        return e

    def k2_kernel_launches(kind, k):
        # K2's launches on its wgmma (k "wgmma") or mma.sync ("mma") kernels
        # over the training paths whose launches its entry counts
        key = f"flash_bwd_{kind}_{k}"
        # options_phase's launch list: K1, dq, dkv, K4, then k2_by_kernel's
        idx = 4 + len(K2_KINDS) * (kind == "dkv") + K2_KINDS.index(k)
        return (train["launches"][key] + train_synth["launches"][key]
                + sum(o["launches"][idx] for o in options.values())
                + tp_train["launches"][key] + host["launches"][key]
                + mc["nccl_launches"][key] + mc["gloo_launches"][key]
                + orb["train"]["k2_by_kernel"][key])

    def bwd_entry(kind, replaces):
        e = entry(f"flash_bwd_{kind}", "buctd_tpu_torch/csrc/flash_bwd.cu",
                  f"buctd_tpu/ops/flash_attention.py:{replaces}",
                  train["launches"][f"flash_bwd_{kind}"] + more[f"flash_bwd_{kind}"]
                  + tp_train["launches"][f"flash_bwd_{kind}"]
                  + host["launches"][f"flash_bwd_{kind}"]
                  + mc_k2[f"flash_bwd_{kind}"] + orb["launches"][f"flash_bwd_{kind}"],
                  tk[f"{kind}_err"], kind)
        e["f32"] = f32_bwd(kind, sum(r["shipped"][f"{kind}_ms"] for r in k2_f32),
                           step_launches[f"flash_bwd_{kind}"])
        # bf16: the launches on the wgmma kernels (every bf16 training path's)
        # and on the mma.sync ones (none); the mma.sync kernels in turns and
        # the same at dropout 0
        e["wgmma_launches"] = k2_kernel_launches(kind, "wgmma")
        e["mma_launches"] = k2_kernel_launches(kind, "mma")
        e["mma_ms"] = tk[f"{kind}_mma_ms"]
        e["dropout_0"] = k2_p0(tk, kind)
        # the host Loader's trainer (host_loader_phase), its launches
        e["host_loader"] = {"launches": host["launches"][f"flash_bwd_{kind}"]}
        # train.run from the orbax fixture (orbax_phase), its launches
        e["orbax"] = {"launches": orb["launches"][f"flash_bwd_{kind}"]}
        # the multi-card steps (multicard_phase): DDP at NCCL world size 1,
        # the two gloo processes on the one card
        e["multicard"] = {"nccl_ddp": mc["nccl_launches"][f"flash_bwd_{kind}"],
                          "gloo_two_processes": mc["gloo_launches"][f"flash_bwd_{kind}"]}
        # TransPose-H's training at d = 112: its launches, its bf16 kernels
        e["transpose_h"] = {"launches": tp_train["launches"][f"flash_bwd_{kind}"],
                            "bf16_training": tp_bf16(kind, f"{kind}_err")}
        return e

    def tp_f32(group):
        t = k1[group]
        return {**{key: t[key] for key in ("ms", "mma_ms", "plain_ms", "library_ms",
                                           "bound_ms", "core_ms")},
                "bound_by": bound_by(t["ops_ms"], t["bound_ms"]), "case": TP_F32_CASES[group]}

    def k1_bf16(group, launches):
        # bf16 K1 at dropout 0 (the bf16 serving and evaluation paths) over a
        # group's shapes, with the launches of that bf16 path in this run
        t = k1["bf16"][group]
        return {**{key: t[key] for key in ("ms", "mma_ms", "plain_ms", "library_ms",
                                           "bound_ms")},
                "bound_by": bound_by(t["ops_ms"], t["bound_ms"]), "launches": launches,
                "max_out_err_of_max": t["rel"], "tile_rounding_rms": t["tiled"]}

    # f32 K2's and K2''s wgmma pair (csrc/flash_bwd_tf32_wgmma.cuh): dq's and
    # dk/dv's launches on it on each f32 training path of this run, read just
    # after its main path's run (K2' runs none); dq + dk/dv at TRAIN_CASES,
    # dropout 0.1, beside the mma.sync pair and SDPA's f32 backward in turns,
    # the same at TransPose-H's d = 112, and K2's share of the profiled f32
    # train step (with the share the mma.sync pair would take: its time over the
    # pair's at TRAIN_CASES)
    f32_k2_paths = {label: {kind: got[f"flash_bwd_{kind}_f32_wgmma"] for kind in ("dq", "dkv")}
                    for label, got in (("f32_train_step", step_launches),
                                       ("multicard_one_process", mc["one_launches"]),
                                       ("multicard_gloo_two_processes", mc["gloo_launches"]))}

    def f32_k2_sums(rows, key):
        return sum(r[key]["dq_ms"] + r[key]["dkv_ms"] for r in rows)

    f32_k2_ms, f32_k2_mma_ms = f32_k2_sums(k2_f32, "shipped"), f32_k2_sums(k2_f32, "mma")
    tp_bounds = {kind: f32_bound(kind, [TP_TRAIN_CASES[0]]) for kind in ("dq", "dkv")}
    share = mc["one_k2_ms"] / mc["one_kernels_ms"]
    ratio = f32_k2_mma_ms / f32_k2_ms
    f32_k2_entry = {
        "name": "flash_bwd_tf32_wgmma", "route": "cuda",
        "source": "buctd_tpu_torch/csrc/flash_bwd_tf32_wgmma.cuh",
        "replaces": "buctd_tpu/ops/flash_attention.py:721",
        # dq's pallas_call above, dk/dv's and the ring variants' (K2') here
        "also_replaces": ["buctd_tpu/ops/flash_attention.py:754",
                          "buctd_tpu/ops/flash_attention.py:624",
                          "buctd_tpu/ops/flash_attention.py:664"],
        "launches": sum(n for got in f32_k2_paths.values() for n in got.values()),
        "paths": f32_k2_paths,
        "max_abs_err": max(tk["f32_k2_err"], tp_k["f32_k2_err"], k1["f32_k2_err"]),
        "ms": f32_k2_ms, "mma_ms": f32_k2_mma_ms, "plain_ms": tk["f32_k2_plain_ms"],
        "bound_ms": f32_bounds["dq"][0] + f32_bounds["dkv"][0],
        "bound_by": f32_bounds["dq"][1],
        "library_ms": sum(r["sdpa_ms"] for r in k2_f32),
        **{kind: {"ms": sum(r["shipped"][f"{kind}_ms"] for r in k2_f32),
                  "mma_ms": sum(r["mma"][f"{kind}_ms"] for r in k2_f32),
                  "bound_ms": f32_bounds[kind][0], "bound_by": f32_bounds[kind][1]}
           for kind in ("dq", "dkv")},
        "transpose_h": {
            "case": TP_TRAIN_CASES[0], "library_ms": k2_f32_tp["sdpa_ms"],
            **{kind: {"ms": k2_f32_tp["shipped"][f"{kind}_ms"],
                      "mma_ms": k2_f32_tp["mma"][f"{kind}_ms"],
                      "bound_ms": tp_bounds[kind][0], "bound_by": tp_bounds[kind][1]}
               for kind in ("dq", "dkv")}},
        "profiled_f32_step": {"kernels_ms": mc["one_kernels_ms"], "k2_ms": mc["one_k2_ms"],
                              "share": share,
                              "share_with_mma_pair": share * ratio / (1 - share + share * ratio)}}
    print(f"f32 K2's wgmma pair: dq + dkv {f32_k2_ms:.4f} ms over {TRAIN_CASES} (the mma.sync pair "
          f"{f32_k2_mma_ms:.4f}, SDPA's f32 backward {f32_k2_entry['library_ms']:.4f}, bound "
          f"{f32_k2_entry['bound_ms']:.4f}: {f32_k2_entry['bound_ms'] / f32_k2_ms:.1%} of it); "
          f"dq {f32_k2_entry['dq']['ms']:.4f} ({f32_bounds['dq'][0] / f32_k2_entry['dq']['ms']:.1%}"
          f" of bound), dkv {f32_k2_entry['dkv']['ms']:.4f} "
          f"({f32_bounds['dkv'][0] / f32_k2_entry['dkv']['ms']:.1%}); at {TP_TRAIN_CASES[0]}: "
          f"dq {k2_f32_tp['shipped']['dq_ms']:.4f} dkv {k2_f32_tp['shipped']['dkv_ms']:.4f} "
          f"(the mma.sync pair's {k2_f32_tp['mma']['dq_ms']:.4f} + {k2_f32_tp['mma']['dkv_ms']:.4f}, SDPA "
          f"{k2_f32_tp['sdpa_ms']:.4f}); {100 * share:.1f}% of the profiled f32 step's kernel "
          f"time (the mma.sync pair would take {100 * f32_k2_entry['profiled_f32_step']['share_with_mma_pair']:.1f}%); "
          f"launches by path {f32_k2_paths}; card: {card}", flush=True)
    graph_k1 = {f"graph_phase_{dt}": r["launches"] for dt, r in graph.items()}
    # K1, dq and dkv launched on the multi-card paths (multicard_phase)
    mc_k2 = {k: mc["nccl_launches"][k] + mc["gloo_launches"][k]
             for k in ("flash_bwd_dq", "flash_bwd_dkv")}
    mc_k1 = {"nccl_ddp": mc["nccl_launches"]["flash_fwd"],
             "gloo_two_processes": mc["gloo_launches"]["flash_fwd"],
             "mesh_serving": mc["mesh_launches"]}
    bf16_launches = (bf16_serving["launches"] + tp_bf16_serving["launches"]
                     + ev["bf16"]["launches"] + tp_ev["bf16"]["launches"])
    # K1 and K4 on the paths of the lambda phase (its plain and swept rounds,
    # validate_lambda), the datasets, inference and pose_resnet (no K1)
    new_k1 = {"lambda_f32": lam["float32"]["launches"],
              "lambda_bf16": lam["bfloat16"]["launches"],
              "datasets": {k: v["launches"] for k, v in dsets.items()},
              "inference_f32": inf["launches"]["float32_1"] + inf["launches"]["float32_3"],
              "inference_bf16": inf["launches"]["bfloat16_1"] + inf["launches"]["bfloat16_3"],
              "pose_resnet": rn["eval_launches"]["flash_fwd"] + rn["train_launches"]["flash_fwd"],
              "host_loader": host["launches"]["flash_fwd"],
              "orbax": orb["launches"]["flash_fwd"],
              "parity_eval": par["launches"]["flash_fwd"]}
    new_k4 = {"pose_resnet": rn["eval_launches"]["warp_resample"]
              + rn["train_launches"]["warp_resample"],
              "lambda": lam["float32"]["warp_launches"] + lam["bfloat16"]["warp_launches"]
              + lam["validate_lambda_warp_launches"],
              "datasets": sum(v["warp_launches"] for v in dsets.values()),
              "host_loader_phase_device_loader": host["launches"]["warp_resample"],
              "orbax": orb["launches"]["warp_resample"],
              "parity_eval": par["launches"]["warp_resample"]}
    bf16_launches += new_k1["lambda_bf16"] + new_k1["inference_bf16"]
    # the wgmma kernel's launches on the bf16 serving (PoseEstimator, CUDA-graph
    # start-up and replays), evaluation (valid.run with K1 and under
    # BUCTD_FLASH_KVRES=1 K1') and training (train.run) paths, each read just
    # after its main path's run and equal there to K1's bf16 launches
    wgmma_paths = {"coam_bf16_serving": bf16_serving["wgmma_launches"],
                   "transpose_h_bf16_serving": tp_bf16_serving["wgmma_launches"],
                   "coam_bf16_graphs": graph["bfloat16"]["wgmma_launches"],
                   "coam_bf16_eval": ev["bf16"]["wgmma_launches"],
                   "coam_bf16_eval_kvres": ev["bf16"]["kvres_wgmma_launches"],
                   "transpose_h_bf16_eval": tp_ev["bf16"]["wgmma_launches"],
                   "coam_training": train["launches"]["flash_fwd_wgmma"],
                   "coam_training_card_sampler": train_synth["launches"]["flash_fwd_wgmma"],
                   "transpose_h_training": tp_train["launches"]["flash_fwd_wgmma"]}
    wgmma_err = max(tk["fwd_bf16_err"], tp_k["fwd_bf16_err"],
                    *(g["err"] for g in k1["bf16"].values()))
    main16 = k1["bf16"]["main"]

    def kv_bwd_entry(kind, replaces):
        return {"name": f"flash_bwd_{kind}_kvres", "route": "cuda",
                "source": "buctd_tpu_torch/csrc/flash_bwd_kvres.cu",
                "replaces": f"buctd_tpu/ops/flash_attention.py:{replaces}",
                "launches": kv_train[f"flash_bwd_{kind}_kvres"],
                "max_abs_err": kv[f"{kind}_err"], "ms": kv[f"{kind}_ms"],
                # one plain backward, and one SDPA backward, give dq, dk and dv:
                # timed in the training kernel phase at the same shapes
                "plain_ms": tk[f"{kind}_plain_ms"], "bound_ms": kv[f"{kind}_bound_ms"],
                "bound_by": bound_by(kv[f"{kind}_ops_ms"], kv[f"{kind}_bound_ms"]),
                "library_ms": tk[f"{kind}_library_ms"],
                # bf16 K2' on K2's wgmma kernels, as its training path ran it
                "wgmma_launches": kv_train[f"flash_bwd_{kind}_kvres_wgmma"],
                "mma_launches": kv_train[f"flash_bwd_{kind}_kvres_mma"],
                "f32": f32_bwd(kind, kv[f"{kind}_f32_ms"], 0, k2_ms=kv[f"{kind}_f32_k2_ms"])}

    # K5: ms per block summed over the 4 branches, from bench_block's chained,
    # interleaved medians; K6: OUTER launches summed over the 3 variants, from
    # bench_exp2's device-time medians
    block = tools["block"].values()
    k5.update({key: sum(r[src] for r in block) for key, src in (
        ("ms", "fused_ms"), ("library_ms", "cudnn_ms"), ("bound_ms", "bound_ms"),
        ("ops_ms", "bf16_ms"), ("simt_ms", "simt_ms"))})
    k5["f32"] = {key: sum(r[src] for r in tools["block_f32"].values()) for key, src in (
        ("ms", "fused_ms"), ("library_ms", "cudnn_ms"), ("bound_ms", "bound_ms"),
        ("ops_ms", "tf32_ms"), ("simt_ms", "simt_ms"))}
    k5["f32"].update(bound_by=bound_by(k5["f32"]["ops_ms"], k5["f32"]["bound_ms"]),
                     launches=tools["f32_launches"], plain_ms=k5["plain_f32_ms"],
                     branches={name: {"ms": r["fused_ms"], "simt_ms": r["simt_ms"],
                                      "library_ms": r["cudnn_ms"], "bound_ms": r["bound_ms"]}
                               for name, r in tools["block_f32"].items()})
    exp = tools["exp"]
    k6.update({key: sum(exp[v][key] for v in ex.VARIANTS) for key in ("ms", "library_ms")})
    k6.update(bound_ms=len(ex.VARIANTS) * exp["bound_ms"], bound_by=exp["bound_by"])
    print(f"K5 sums over the 4 branches at b128 bf16: tensor cores {k5['ms']:.4f} ms, SIMT "
          f"{k5['simt_ms']:.4f}, plain {k5['plain_ms']:.4f}, cuDNN {k5['library_ms']:.4f}, "
          f"bound {k5['bound_ms']:.4f}; f32 (3xTF32): {k5['f32']['ms']:.4f} ms, SIMT "
          f"{k5['f32']['simt_ms']:.4f}, plain {k5['plain_f32_ms']:.4f}, cuDNN (TF32 off) "
          f"{k5['f32']['library_ms']:.4f}, bound {k5['f32']['bound_ms']:.4f}; max err f32 "
          f"{k5['err_f32']:.3e} (SIMT {k5['err_simt_f32']:.3e}), bf16 {k5['err_bf16']:.3e} "
          f"(SIMT {k5['err_simt']:.3e}); vs the trunk {k5_trunk:.3e} of the max", flush=True)
    print(f"K2 f32 sums over {TRAIN_CASES}, dropout {DROPOUT}: 3xTF32 dq "
          f"{sum(r['shipped']['dq_ms'] for r in k2_f32):.4f} + dkv "
          f"{sum(r['shipped']['dkv_ms'] for r in k2_f32):.4f} ms, SIMT dq "
          f"{sum(r['simt']['dq_ms'] for r in k2_f32):.4f} + dkv "
          f"{sum(r['simt']['dkv_ms'] for r in k2_f32):.4f}, SDPA's f32 backward "
          f"{sum(r['sdpa_ms'] for r in k2_f32):.4f}; bounds dq {f32_bounds['dq'][0]:.4f}, dkv "
          f"{f32_bounds['dkv'][0]:.4f}; f32 K2' dq {kv['dq_f32_ms']:.4f} + dkv "
          f"{kv['dkv_f32_ms']:.4f} (K2 in turns {kv['dq_f32_k2_ms']:.4f} + "
          f"{kv['dkv_f32_k2_ms']:.4f})", flush=True)
    for name, r in (("CoAM-W48", bf16_serving), ("TransPose-H", tp_bf16_serving),
                    *((f"preNet-W48 FUSED_PRENET {k}", v) for k, v in prenet_bf16.items())):
        print(f"bf16 serving {name}: predict_batch {12e3 / r['ms']['batch_bf16']:.2f} crops/s "
              f"(f32 {12e3 / r['ms']['batch_f32']:.2f}), predict "
              f"{r['ms']['predict_bf16']:.2f} ms/image (f32 {r['ms']['predict_f32']:.2f}); "
              f"convolutions {100 * r['conv']['bfloat16']['share']:.1f}% of kernel time "
              f"(f32 {100 * r['conv']['float32']['share']:.1f}%); K1 launches {r['launches']}",
              flush=True)
    for dt, r in graph.items():
        print(f"CUDA graphs, CoAM-W48 {dt}: predict {r['ms']['eager']:.2f} ms/image eager, "
              f"{r['ms']['replay']:.2f} replayed; predict_batch {r['ms']['batch_eager']:.2f} "
              f"eager, {r['ms']['batch_replay']:.2f} replayed; start-up (2 captures) "
              f"{r['start_s']:.2f} s; export {r['export_s']:.1f} s, load {r['load_s']:.1f} s, "
              f"{r['export_gap']:.3e} from the live estimator; card: {card}", flush=True)
    for name, r in (("CoAM-W48", ev["bf16"]), ("TransPose-H", tp_ev["bf16"])):
        print(f"bf16 evaluation {name}: one round {r['crops_s']:.2f} crops/s, AP {r['ap']!r}, "
              f"K1 launches {r['launches']}; a validate step's convolutions "
              f"{100 * r['conv']['share']:.1f}% of kernel time", flush=True)
    r32, r16 = rn["serving"]["auto"]["ms"]["float32"], rn["serving"]["auto"]["ms"]["bfloat16"]
    print(f"pose_resnet-50 + preNet (FUSED_PRENET auto): predict_batch f32 {12e3 / r32:.2f} "
          f"crops/s, bf16 {12e3 / r16:.2f}; one eval round {rn['eval_crops_s']:.2f} crops/s, "
          f"AP {rn['eval_ap']!r}", flush=True)
    for dt in ("float32", "bfloat16"):
        r = lam[dt]
        print(f"lambda sweep {dt}: {r['crops_s']:.2f} crops/s against the plain round's "
              f"{r['plain_crops_s']:.2f} ({r['crops_s'] / r['plain_crops_s']:.3f}x), merged AP "
              f"{r['ap']!r}, K1 launches {r['launches']}; inference refine_iters 1 "
              f"{inf[f'ms_{dt}_1']:.2f} ms/image, 3 {inf[f'ms_{dt}_3']:.2f} ms/image",
              flush=True)
    print(f"pose_resnet training ms/step {[round(v, 2) for v in rn['train_ms']]}", flush=True)
    print(f"datasets: { {k: (round(v['crops_s'], 2), v['ap']) for k, v in dsets.items()} } "
          f"(crops/s, AP)", flush=True)
    print(f"host Loader (TPU.DEVICE_PIPELINE False): trainer {host['host']['ms_step']:.2f} "
          f"ms/step with the host sampler (DeviceLoader's in phase 4: {train['ms_step']:.2f}), "
          f"{host['host_synth']['ms_step']:.2f} with TPU.DEVICE_SYNTHESIS (DeviceLoader "
          f"{host['device_synth']['ms_step']:.2f}); one eval round {host['eval_host']['crops_s']:.2f} "
          f"crops/s, AP {host['eval_host']['ap']!r} (DeviceLoader {host['eval_device']['crops_s']:.2f} "
          f"crops/s, AP {host['eval_device']['ap']!r}); summary {host['params']:,} parameters, "
          f"{host['gflops']:.2f} GFLOPs a crop; matmul warp engine {host['matmul']['ms']:.4f} ms "
          f"(K4 {host['matmul']['k4_ms']:.4f} ms), peak {host['matmul']['peak_gb']:.3f} GB",
          flush=True)
    print(f"multi-card: CoAM-W48 f32 train step, global batch {MC_GLOBAL_BATCH}, one process "
          f"{mc['one_ms']:.2f} ms/step, two gloo processes on the one card "
          f"{mc['two_ms'][0]:.2f} and {mc['two_ms'][1]:.2f} ms/step; loss gaps "
          f"{mc['loss_gaps']}; mesh= serving {mc['mesh_err']:.3e} px; card: {card}", flush=True)
    print(f"orbax reader: CoAM-W48 at full width, {orb['leaves']} leaves, {orb['read_bytes']} "
          f"bytes read in {orb['read_s']:.3f} s; libzstd {orb['mb_s']:.1f} MB/s over its chunks; "
          f"served f32 and bf16 from the directory, a narrow CoAM evaluated and trained from "
          f"its directory; launches {orb['launches']}; card: {card}", flush=True)
    print(f"parity runner: CoAM-W48 from the orbax fixture (read in {par['read_s']:.3f} s), "
          f"{PARITY_ROUNDS} rounds, crops/s by round {[round(c, 2) for c in par['crops_s']]}, "
          f"AP trajectory {par['trajectory']}, {par['seconds']:.1f} s; launches "
          f"{par['launches']}; card: {card}", flush=True)
    print(f"phase seconds: {phase_s}", flush=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "buctd_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "buctd_tpu/ops/flash_attention.py:86",
         "launches": (serving_launches + train["launches"]["flash_fwd"] + more["flash_fwd"]
                      + ev["launches"]["flash_fwd"] + tp_serving_launches
                      + tp_train["launches"]["flash_fwd"] + tp_ev["launches"]["flash_fwd"]
                      + bf16_launches + new_k1["lambda_f32"] + new_k1["inference_f32"]
                      + sum(new_k1["datasets"].values()) + new_k1["host_loader"]
                      + new_k1["orbax"] + new_k1["parity_eval"] + sum(graph_k1.values())
                      + sum(mc_k1.values())),
         # its launches on the multi-card paths (multicard_phase)
         "multicard": mc_k1,
         # the graph phase's main path (f32, bf16): warm-ups and replays
         "graph_launches": graph_k1,
         # its launches on the lambda sweep (f32, bf16), the OCHuman and animal
         # evaluation rounds, inference (f32, bf16), pose_resnet's paths, the
         # host Loader's, the orbax fixture's (serving f32 and bf16,
         # valid.run, train.run) and the parity runner's
         "more_paths": new_k1,
         "max_abs_err": max(k1["max_abs_err"], tk["fwd_err"], tp_k["fwd_err"]),
         # f32 (3xTF32, the wgmma kernel) at MAIN_CASES, the mma.sync kernel
         # it replaced timed in turns beside it
         "ms": main_k1["ms"], "plain_ms": main_k1["plain_ms"],
         "bound_ms": main_k1["bound_ms"],
         "bound_by": bound_by(main_k1["ops_ms"], main_k1["bound_ms"]),
         "library_ms": main_k1["library_ms"], "mma_ms": main_k1["mma_ms"],
         "f32_core_bound_ms": main_k1["core_ms"],
         # the same at EVAL_CASES, and K1's time in the profiled f32 runs
         "f32_eval": {key: k1["eval"][key] for key in ("ms", "mma_ms", "plain_ms",
                                                       "library_ms", "bound_ms", "core_ms")},
         "profiled_ms": {"predict_batch": serving_profile["k1_ms"],
                         "validate_step": ev["profile"]["k1_ms"]},
         # the bf16 training path (the tensor-core kernel) at TRAIN_CASES,
         # dropout 0.1, beside the f32 SIMT kernel on the widened operands,
         # which bf16 ran before
         # bf16 at dropout 0 (TPU.EVAL_DTYPE bfloat16): CoAM-W48 serving at
         # MAIN_CASES, evaluation at EVAL_CASES, and K1's time in the profiled
         # bf16 runs
         "bf16_serving": k1_bf16("main", bf16_serving["launches"]),
         "bf16_eval": k1_bf16("eval", ev["bf16"]["launches"]),
         "bf16_profiled_ms": {"predict_batch": bf16_serving["k1"]["k1_ms"],
                              "validate_step": ev["bf16"]["profile"]["k1_ms"]},
         "bf16_training": {"ms": tk["fwd_ms"], "plain_ms": tk["fwd_plain_ms"],
                           "bound_ms": tk["fwd_bound_ms"],
                           "bound_by": bound_by(tk["fwd_ops_ms"], tk["fwd_bound_ms"]),
                           "library_ms": tk["fwd_library_ms"],
                           "mma_ms": tk["fwd_mma_ms"],
                           "max_out_err_of_max": tk["fwd_bf16_rel"]},
         # TransPose-H at d = 112: K1's launches on its three paths, f32 at
         # its serving and evaluation shapes, bf16 at its training shape, and
         # K1's time in its profiled runs
         "transpose_h": {
             "launches": {"serving": tp_serving_launches,
                          "training": tp_train["launches"]["flash_fwd"],
                          "evaluation": tp_ev["launches"]["flash_fwd"]},
             "f32_serving": tp_f32("tp_serving"), "f32_eval": tp_f32("tp_eval"),
             "bf16_serving": k1_bf16("tp_serving", tp_bf16_serving["launches"]),
             "bf16_eval": k1_bf16("tp_eval", tp_ev["bf16"]["launches"]),
             "bf16_training": {**tp_bf16("fwd", "fwd_err"),
                               "max_out_err_of_max": tp_k["fwd_bf16_rel"]},
             "profiled_ms": {"predict_batch": tp_serving_profile["k1_ms"],
                             "validate_step": tp_ev["profile"]["k1_ms"],
                             "train_step": tp_train["k1_profile_ms"]}}},
        {"name": "flash_fwd_kvres", "route": "cuda",
         "source": "buctd_tpu_torch/csrc/flash_fwd_kvres.cu",
         "replaces": "buctd_tpu/ops/flash_attention.py:139",
         "launches": (ev["kvres_launches"] + kv_train["flash_fwd_kvres"]
                      + ev["bf16"]["kvres_launches"]),
         "max_abs_err": kv["fwd_err"], "ms": kv["fwd_ms"], "plain_ms": kv["fwd_plain_ms"],
         "bound_ms": kv["fwd_bound_ms"], "bound_by": bound_by(kv["fwd_ops_ms"],
                                                              kv["fwd_bound_ms"]),
         "library_ms": kv["fwd_library_ms"], "k1_ms": kv["k1_ms"],
         # bf16 (the tensor-core ring variant) at TRAIN_CASES beside K1 in turns
         "bf16_training": {"ms": kv["train_fwd_ms"], "k1_ms": kv["train_k1_ms"]}},
        {"name": "flash_fwd_tf32_wgmma", "route": "cuda",
         "source": "buctd_tpu_torch/csrc/flash_fwd_tf32_wgmma.cuh",
         "replaces": "buctd_tpu/ops/flash_attention.py:86",
         # every f32 K1 and K1' launch of each main path, all on this kernel
         # (the narrow orbax fixture's d = 4 apart, on the mma.sync kernel)
         "launches": sum(r["f32_wgmma"] for r in F32_WGMMA_PATHS.values()),
         "paths": F32_WGMMA_PATHS, "max_abs_err": k1["f32_wgmma_err"],
         # CoAM-W48 f32 serving at MAIN_CASES, dropout 0: this kernel, the
         # mma.sync kernel it replaced and SDPA's f32 forward in turns
         "ms": main_k1["ms"], "mma_ms": main_k1["mma_ms"], "plain_ms": main_k1["plain_ms"],
         "bound_ms": main_k1["bound_ms"],
         "bound_by": bound_by(main_k1["ops_ms"], main_k1["bound_ms"]),
         "library_ms": main_k1["library_ms"],
         # the same at EVAL_CASES and TransPose-H's serving and evaluation
         # shapes, and K1's share of the profiled f32 runs beside the share
         # it would have with the mma.sync kernel
         "f32_eval": {key: k1["eval"][key] for key in ("ms", "mma_ms", "plain_ms",
                                                       "library_ms", "bound_ms")},
         "transpose_h": {"f32_serving": tp_f32("tp_serving"), "f32_eval": tp_f32("tp_eval")},
         "profiled_share": {
             "coam_predict_batch": serving_profile, "coam_validate_step": ev["profile"],
             "transpose_h_predict_batch": tp_serving_profile,
             "transpose_h_validate_step": tp_ev["profile"]}},
        {"name": "flash_fwd_wgmma", "route": "cuda",
         "source": "buctd_tpu_torch/csrc/flash_fwd_wgmma.cuh",
         "replaces": "buctd_tpu/ops/flash_attention.py:86",
         "launches": sum(wgmma_paths.values()), "paths": wgmma_paths,
         "max_abs_err": wgmma_err,
         # CoAM-W48 bf16 serving at MAIN_CASES, dropout 0: the wgmma kernel,
         # the mma.sync kernel it replaced and SDPA's bf16 forward in turns
         "ms": main16["ms"], "mma_ms": main16["mma_ms"], "plain_ms": main16["plain_ms"],
         "bound_ms": main16["bound_ms"],
         "bound_by": bound_by(main16["ops_ms"], main16["bound_ms"]),
         "library_ms": main16["library_ms"],
         # the same at EVAL_CASES, TransPose-H's serving and evaluation shapes,
         # and the training shapes at dropout 0.1 (with the hash's floor)
         "bf16_eval": k1_bf16("eval", ev["bf16"]["wgmma_launches"]),
         "transpose_h": {
             "bf16_serving": k1_bf16("tp_serving", tp_bf16_serving["wgmma_launches"]),
             "bf16_eval": k1_bf16("tp_eval", tp_ev["bf16"]["wgmma_launches"]),
             "bf16_training": tp_bf16("fwd", "fwd_err")},
         "bf16_training": {"ms": tk["fwd_ms"], "mma_ms": tk["fwd_mma_ms"],
                           "plain_ms": tk["fwd_plain_ms"], "bound_ms": tk["fwd_bound_ms"],
                           "bound_by": bound_by(tk["fwd_ops_ms"], tk["fwd_bound_ms"]),
                           "library_ms": tk["fwd_library_ms"]}},
        bwd_entry("dq", 212),
        bwd_entry("dkv", 363),
        kv_bwd_entry("dq", 245),
        kv_bwd_entry("dkv", 295),
        f32_k2_entry,
        {**entry("warp_resample", "buctd_tpu_torch/csrc/warp_resample.cu",
                 "buctd_tpu/ops/pallas_warp.py:30",
                 train["launches"]["warp_resample"] + more["warp_resample"]
                 + ev["launches"]["warp_resample"]
                 + tp_train["launches"]["warp_resample"] + tp_ev["launches"]["warp_resample"]
                 + ev["bf16"]["warp_launches"] + tp_ev["bf16"]["warp_launches"]
                 + sum(new_k4.values()), tk["warp_err"], "warp"),
         "more_paths": new_k4,
         # the fused f32 kernel above; beside it, in this run: the two-pass
         # form in turns, the uint8 source with mask rectangles (the loaders'
         # input) with its error against the plain version and its bound,
         # rotation 0 at the evaluation scales with F.grid_sample in turns,
         # and the loader's work before the render
         "two_pass_ms": tk["warp_two_pass_ms"], "uint8_ms": tk["warp_uint8_ms"],
         "uint8_max_abs_err": tk["warp_uint8_err"],
         "uint8_bound_ms": tk["warp_uint8_bound_ms"], "rot0_ms": tk["warp_rot0_ms"],
         "library_rot0_ms": tk["warp_library_rot0_ms"],
         "rot0_library_gap": tk["warp_rot0_grid_err"],
         "loader_before_render_ms": {"former": tk["loader_before_ms"],
                                     "fused": tk["loader_ms"]},
         # TPU.WARP_ENGINE matmul (no kernel: torch.einsum) at K4's draw, beside
         # K4 in the same run: its error against K4's plain version, its peak
         # memory above the inputs
         "matmul_engine": {"ms": host["matmul"]["ms"], "k4_ms": host["matmul"]["k4_ms"],
                           "max_abs_err": host["matmul"]["err"],
                           "peak_gb": host["matmul"]["peak_gb"]}},
        {"name": "fused_basic_block", "route": "cuda",
         "source": "buctd_tpu_torch/csrc/fused_block.cu",
         "replaces": "buctd_tpu/ops/pallas_block.py:106",
         "launches": tools["launches"]["fused_basic_block"],
         "max_abs_err": max(k5["err_f32"], k5["err_bf16"]),
         "max_abs_err_f32": k5["err_f32"],
         # bf16 (the tensor-core kernel) at b128 over the 4 branches, the SIMT
         # kernel timed in turns beside it
         "ms": k5["ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
         "bound_by": bound_by(k5["ops_ms"], k5["bound_ms"]), "library_ms": k5["library_ms"],
         "simt_ms": k5["simt_ms"], "simt_launches": tools["launches"]["fused_basic_block_simt"],
         "branches": {name: {"ms": r["fused_ms"], "simt_ms": r["simt_ms"],
                             "library_ms": r["cudnn_ms"], "bound_ms": r["bound_ms"]}
                      for name, r in tools["block"].items()},
         "long_k": k5["long_k"],
         # f32 (3xTF32) against its SIMT kernel and cuDNN with TF32 off, the
         # 3xTF32 bound
         "f32": k5["f32"]},
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


def multicard_main() -> int:
    """``chip_smoke.py --multicard``: the kernels' build and
    ``multicard_phase`` alone, on every card of the machine."""
    import numpy as np
    import torch

    from buctd_tpu_torch import _build
    from buctd_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()
    print(f"cards: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(f"built {_build.build_all()} in {time.perf_counter() - t0:.1f} s", flush=True)
    res = multicard_phase(torch, np, fa, card[0])
    print(f"multicard_phase passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(res, default=str), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multicard-child"]:
        sys.exit(multicard_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--multicard"]:
        sys.exit(multicard_main())
    sys.exit(main())
