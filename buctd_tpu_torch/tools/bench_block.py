"""Per-branch timing of the HRNet-W48 eval basic block on one CUDA card: the
cuDNN conv pair against the fused kernel K5 (ops/fused_block.py).

    python -m buctd_tpu_torch.tools.bench_block [--fused] [--simt]
        [--dtype bfloat16|float32] [--batch 128] [--chain 50] [--rounds 5]
        [--seed 0]

Counterpart of tools/bench_block.py.  The four W48 branch geometries at batch
128, bf16 by default, with that tool's parameter scales (weights N(0, 0.02^2),
biases N(0, 0.01^2), x N(0, 0.5^2); the small weights keep a deep chain tame
in bf16), drawn from a seeded torch generator.  One block is

    relu(conv3x3(relu(conv3x3(x) + b1)) + b2 + x)      (BN folded, as at eval)

For each geometry ``--chain`` blocks are chained (the output feeds the next
block) inside one timed region, with CUDA events around the chain, and the
implementations are timed in turns over ``--rounds`` rounds; the medians are
printed in ms per block.  cuDNN runs ``F.conv2d`` twice on channels-last
tensors with the bias, relu and residual in PyTorch; ``--fused`` adds K5 (on
the tensor cores: bf16, or f32 in 3xTF32), ``--simt`` adds K5's SIMT kernel
in the same dtype as well (``fused_basic_block_simt``, the A/B; implies
``--fused``).  ``--dtype float32`` runs f32 operands with TF32 off for cuDNN
(restored after).

Bounds are the H100's (NVIDIA data sheet, SXM): the two convs' operations
(2 x 2 x 9 C^2 H W B, 2 per multiply-add) over 989 TFLOP/s (bf16 dense tensor
cores) in bf16, three passes of them over 494.7 TFLOP/s (dense TF32, f32 K5's
3xTF32) in f32; the f32 CUDA-core figure (67 TFLOP/s, what a SIMT kernel can
reach) printed beside; and the bytes a fused block must move (x in, out, the
weights and biases, 2 or 4 bytes each) over 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import statistics

import torch
import torch.nn.functional as F

BATCH = 128
CHAIN = 50
ROUNDS = 5
BRANCHES = [("branch0", 96, 72, 48), ("branch1", 48, 36, 96),
            ("branch2", 24, 18, 192), ("branch3", 12, 9, 384)]
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16, PEAK_TF32, PEAK_F32 = 989e12, 494.7e12, 67e12


def make_params(gen, c: int, dtype=torch.bfloat16):
    """w1, w2 (3, 3, C, C) HWIO and b1, b2 (C,) on the card from ``gen``,
    tools/bench_block.py's scales, in ``dtype``."""
    def draw(*shape, std):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    return (draw(3, 3, c, c, std=0.02), draw(3, 3, c, c, std=0.02),
            draw(c, std=0.01), draw(c, std=0.01))


def branch_inputs(gen, batch: int, h: int, w: int, c: int, dtype=torch.bfloat16):
    """x (batch, h, w, C) N(0, 0.5^2) after ``make_params(gen, c)``: one
    branch's inputs in the order the benchmark draws them."""
    w1, w2, b1, b2 = make_params(gen, c, dtype)
    x = (torch.randn(batch, h, w, c, generator=gen, device="cuda") * 0.5).to(dtype)
    return x, w1, w2, b1, b2


def cudnn_block(x_nchw, k1, k2, b1, b2):
    """The library pair: two cuDNN convs on channels-last NCHW tensors."""
    y = torch.relu(F.conv2d(x_nchw, k1, b1, padding=1))
    return torch.relu(F.conv2d(y, k2, b2, padding=1) + x_nchw)


def block_ops(b: int, h: int, w: int, c: int) -> float:
    return 2.0 * 2 * 9 * c * c * h * w * b


def bounds(b: int, h: int, w: int, c: int, dtype: str = "bfloat16") -> dict:
    """The least time of one block on the card, ms: operations over the bf16
    peak (``bf16_ms``), three passes of them over the TF32 peak
    (``tf32_ms``) or over the f32 CUDA-core peak (``f32core_ms``), bytes (x
    in, out, weights, biases in ``dtype``) over the memory rate
    (``bytes_ms``); ``bound_ms`` is the larger of the bytes time and the
    operations of ``dtype``'s kernel (``ops_ms``: bf16 tensor cores, or f32
    in 3xTF32)."""
    ops = block_ops(b, h, w, c)
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * (2 * b * h * w * c + 2 * 9 * c * c + 2 * c)
    res = {"bf16_ms": ops / PEAK_BF16 * 1e3, "tf32_ms": 3 * ops / PEAK_TF32 * 1e3,
           "f32core_ms": ops / PEAK_F32 * 1e3, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    res["ops_ms"] = res["bf16_ms"] if dtype == "bfloat16" else res["tf32_ms"]
    res["bound_ms"] = max(res["ops_ms"], res["bytes_ms"])
    res["bound_by"] = "operations" if res["ops_ms"] >= res["bytes_ms"] else "bytes"
    return res


def chain_ms(fn, x, n: int) -> float:
    """Device ms per block of ``n`` chained ``fn`` applications (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        x = fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None) -> dict:
    from ..ops.fused_block import fused_basic_block, fused_basic_block_simt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fused", action="store_true", help="also time the fused kernel K5")
    ap.add_argument("--simt", action="store_true",
                    help="also time K5's SIMT kernel (implies --fused)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_block measures the CUDA card; none is available")
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    B = args.batch
    ops = ("ops / 989 TFLOP/s (bf16 tensor cores)" if args.dtype == "bfloat16"
           else "3 x ops / 494.7 TFLOP/s (3xTF32)")
    print(f"# {torch.cuda.get_device_name(0)}; b{B} {args.dtype}, {args.chain} chained blocks "
          f"per timed region, {args.rounds} rounds in turns; ms per block (median)")
    print(f"# bounds: {ops}, or bytes (x in, out, weights) / {HBM_BYTES_PER_S / 1e12} TB/s; "
          f"f32 CUDA cores: ops / {PEAK_F32 / 1e12:.0f} TFLOP/s")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False if args.dtype == "float32" else tf32
    results = {}
    try:
        for name, h, w, c in BRANCHES:
            x, w1, w2, b1, b2 = branch_inputs(gen, B, h, w, c, dtype)
            k1, k2 = (k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                      for k in (w1, w2))
            impls = {"cudnn": (lambda t: cudnn_block(t, k1, k2, b1, b2),
                               x.permute(0, 3, 1, 2))}        # channels-last NCHW view
            if args.fused or args.simt:
                impls["fused"] = (lambda t: fused_basic_block(t, w1, w2, b1, b2), x)
            if args.simt:
                impls["simt"] = (lambda t: fused_basic_block_simt(t, w1, w2, b1, b2), x)
            for fn, x0 in impls.values():                      # warm-up
                fn(x0)
            torch.cuda.synchronize()
            times = {k: [] for k in impls}
            for r in range(args.rounds):
                order = list(impls) if r % 2 == 0 else list(impls)[::-1]
                for k in order:
                    fn, x0 = impls[k]
                    times[k].append(chain_ms(fn, x0, args.chain))
            res = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
            res.update(bounds(B, h, w, c, args.dtype))
            results[name] = res
            line = f"{name} ({h}x{w}xC{c}): " + ", ".join(
                f"{label} {res[f'{k}_ms']:.4f} ms [{min(times[k]):.4f}-{max(times[k]):.4f}]"
                for k, label in (("cudnn", "cuDNN"), ("fused", "K5"), ("simt", "K5 SIMT"))
                if k in times)
            if "fused" in times:
                line += f", cuDNN/K5 {res['cudnn_ms'] / res['fused_ms']:.3f}"
            if "simt" in times:
                line += f", SIMT/K5 {res['simt_ms'] / res['fused_ms']:.3f}"
            print(line + f"; bound {res['bound_ms']:.4f} ms ({res['bound_by']}; bf16 ops "
                  f"{res['bf16_ms']:.4f}, 3xTF32 {res['tf32_ms']:.4f}, f32-core "
                  f"{res['f32core_ms']:.4f}, bytes {res['bytes_ms']:.4f})", flush=True)
            del x, impls
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return results


if __name__ == "__main__":
    main()
