#!/usr/bin/env python3
"""Smoke run of buctd_tpu_torch on one NVIDIA GPU (H100): builds the CUDA
kernels, holds each against its plain PyTorch version, then serves full-width
BUCTD-CoAM-W48 through PoseEstimator with 3 refinement rounds.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  0. build every kernel under buctd_tpu_torch/csrc/ with nvcc for sm_90a;
  1. kernel: K1 (flash-attention forward) vs its plain version at the CoAM-W48
     shapes (16 crops, as predict_batch gives them, and 8) in f32 and bf16
     plus a ragged case; kernel, plain and F.scaled_dot_product_attention
     times beside the card's bound;
  2. serving: CoAM-W48 crowdpose 384x288 (14 joints, random weights from
     torch.manual_seed), ``predict`` on a 480x640 image with 4 condition poses
     and ``predict_batch`` on 3 images; finite outputs of the right shapes, the
     flash launch count of the run, one forward on the card vs the same module
     on the CPU, ms per image and crops/s.

Prints the kernels' JSON line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result, where CUDA is absent.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
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
ROUNDS = 3
REPEATS = 5
# K1's (BH, Lq, Lk, d) on the main path: the CoAM position attention of branch
# 0 and branch 1, BH = the 16 crops of the serving phase's predict_batch
MAIN_CASES = [(16, 6912, 6912, 48), (16, 1728, 1728, 96)]
OTHER_CASES = [(8, 6912, 6912, 48), (8, 1728, 1728, 96), (3, 700, 300, 112)]


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


def sample_request(np, rng, h=480, w=640, poses=4, joints=14):
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    centers = rng.uniform([80, 80], [w - 80, h - 80], (poses, 1, 2))
    xy = centers + rng.uniform(-70, 70, (poses, joints, 2))
    conds = np.concatenate([xy, np.ones((poses, joints, 1))], -1).astype(np.float32)
    return img, conds


def randomize(torch, model) -> None:
    """Redraw every weight with N(0, 1/fan_in) and every BN statistic away from
    the identity, from torch's seeded generator.  The reference's N(0, 0.001)
    init leaves ~1e-10 heatmaps; these give maps with real peaks, far from
    zero, so the decode and the card-vs-CPU check see decisive values."""
    from torch import nn

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.1)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)


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


def profile_phase(torch, serving: dict) -> None:
    """Device time by kernel over one predict_batch (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    est = serving["est"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.predict_batch(serving["images"], serving["poses"], float("-inf"))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    flash = sum(e.self_device_time_total for e in events if "flash_fwd" in e.key) / 1e3
    print(f"profile predict_batch: kernels {total:.2f} ms in {wall:.2f} ms wall "
          f"(profiled), flash_fwd {flash:.2f} ms = {100 * flash / total:.1f}% of "
          f"kernel time; {len(events)} kernel names, top by device time:", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from buctd_tpu_torch import _build
    from buctd_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    names = _build.build_all()
    print(f"built {names} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in names:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    k1 = kernel_phase(torch, F, fa)
    serving = serving_phase(torch, np, fa)
    profile_phase(torch, serving)

    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "buctd_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "buctd_tpu/ops/flash_attention.py:86",
        "launches": serving["launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "operations" if k1["ops_ms"] >= k1["bound_ms"] else "bytes",
        "library_ms": k1["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
