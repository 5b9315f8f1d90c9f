"""K5's tensor-core kernels (launched by csrc/fused_block.cu) against
variants of their tile plans and of how their products enter the f32 sums,
on one CUDA card: bf16 (csrc/fused_block_tc.cuh) or, with ``--dtype
float32``, f32 in 3xTF32 (csrc/fused_block_tf32.cuh).

    python -m buctd_tpu_torch.tools.bench_block_variants [--dtype bfloat16|float32]
        [--chain 5] [--rounds 3] [--seed 0] [--only NAME ...]

Each variant is the dtype's header with one choice changed, written beside a
copy of csrc/fused_block.cu into buctd_tpu_torch/_build/variants/k5_<name>/
(git ignores it) and built there with nvcc (tools/kernel_variants.py);
ptxas's registers and spills of the tensor-core kernels are printed.  bf16:

  shipped     the source as it is;
  fold0       the products summed in the tensor cores' accumulators;
  p48_w8      C <= 48: 16x12 tiles, 8 warps, two blocks an SM;
  p96_s3      C <= 96: three ring slots;
  p192_t1     C <= 192: one tap a ring slot;
  p192_12x9   C <= 192: 12x9 tiles, 64-channel input chunks, 128 output
              channels a chunk (the second half idle at C = 192), 2 x 4 warps;
  p192_n64    the same with 64 output channels a chunk, 4 x 2 warps;
  p384_k32    C > 192: 32-channel input chunks, three taps a ring slot;
  p384_k32s4  C > 192: 32-channel input chunks, one tap a slot, four slots;
  p384_th6    C > 192: 6x9 tiles (two a 12x9 image), three slots;
  p384_w16    C > 192: 4 x 4 warps;
  p384_w12    C > 192: 3 x 4 warps;
  p192_w12    C <= 192: 6 x 2 warps;
  p96_w16     C <= 96: 16 warps;
  ko_mma      no mma (the copies, ldmatrix, barriers and epilogues alone);
  ko_copy     no copies into shared memory (the products on stale tiles);
  ko_lda      A fragments loaded at the first k16 step of a tap only;
  ko_ldb      B fragments loaded at the first k16 step of a tap only;
  ko_cm       ko_copy and ko_mma;
  ko_cl       ko_copy, ko_lda and ko_ldb;
  ko_x2mma    every mma issued twice.

f32:

  shipped     the source as it is;
  fold0       the products summed in the tensor cores' accumulators;
  cvtsplit    each operand split by cvt.rna.tf32.f32 (csrc/mma_tf32.cuh's
              first split; the same values as the integer rounding shipped
              for finite operands);
  nanfree     the integer rounding without the fma that carries a NaN into
              lo (a NaN operand then reads as 0 or inf: what keeping NaN
              costs);
  p48_k16t3   C <= 48: 16-channel input chunks, three taps a ring slot;
  p96_8x12    C <= 96: 8x12 tiles, 4 warps, two blocks an SM;
  p192_n64    C <= 192: 64 output channels a chunk (three chunks at C = 192);
  p192_k32t1  C <= 192: 32-channel input chunks, one tap a slot;
  p384_k32t1  C > 192: 32-channel input chunks, one tap a slot;
  ko_mma      no mma;
  ko_mma1     one tf32 pass (hi hi) in place of three;
  ko_split    no split (hi = x, lo = 0);
  ko_copy     no copies into shared memory;
  ko_cm       neither copies nor mma: what is left is the fragment loads and
              splits, barriers and epilogues.

The knock-outs' outputs are wrong and are not checked, and fold0's is
measured but not gated (in f32 it misses 2e-5: the accumulator's sums).
Every other variant is held against the plain version at the four W48
branch geometries at batch 32 (bf16 2^-6, f32 2e-5: chip_smoke.py's
K5_ATOL), and
measured for accuracy at C = 384 (batch 32, 12 x 9) against a float64 chain
on the same operands that rounds the intermediate to the operands' dtype
where the kernel does: max and rms |out - ref|, and the share of outputs that
differ from the float64 chain rounded to that dtype (the SIMT kernel beside
them).  Then each is timed per branch on bench_block.py's batch-128 inputs,
``--chain`` chained blocks per timed region with CUDA events, the variants
in turns (the order reversed every other round) over ``--rounds`` rounds.
Returns {"accuracy": {variant: (max, rms, share)}, branch: {variant: ms per
block}}, medians.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess

import torch
import torch.nn.functional as F

from . import bench_block, kernel_variants
from .kernel_variants import CVT_SPLIT, INT_SPLIT, NANFREE_SPLIT, substituted

HEADER = "fused_block_tc.cuh"
P48 = "using Plan48 = Plan<    48, 16,  8, 48,  48, 4, 1, 2, 3, 2>;"
P96 = "using Plan96 = Plan<    96, 16, 12, 96,  48, 8, 1, 2, 3, 1>;"
P192 = "using Plan192 = Plan<  192, 12, 18, 32,  64, 4, 2, 2, 3, 1>;"
P384 = "using Plan384 = Plan<  384, 12,  9, 64, 128, 2, 4, 2, 1, 1>;"
VARIANTS = {
    "shipped": [],
    "fold0": [("constexpr bool kFold = true;", "constexpr bool kFold = false;")],
    "p48_w8": [(P48, "using Plan48 = Plan<    48, 16, 12, 48,  48, 8, 1, 2, 3, 2>;")],
    "p192_t1": [(P192, "using Plan192 = Plan<  192, 12, 18, 32,  64, 4, 2, 2, 1, 1>;")],
    "p192_12x9": [(P192, "using Plan192 = Plan<  192, 12,  9, 64, 128, 2, 4, 2, 3, 1>;")],
    "p192_n64": [(P192, "using Plan192 = Plan<  192, 12,  9, 64,  64, 4, 2, 2, 3, 1>;")],
    "p384_k32": [(P384, "using Plan384 = Plan<  384, 12,  9, 32, 128, 2, 4, 2, 3, 1>;")],
    "p384_k32s4": [(P384, "using Plan384 = Plan<  384, 12,  9, 32, 128, 2, 4, 4, 1, 1>;")],
    "p384_th6": [(P384, "using Plan384 = Plan<  384,  6,  9, 64, 128, 2, 4, 3, 1, 1>;")],
    "p384_w16": [(P384, "using Plan384 = Plan<  384, 12,  9, 64, 128, 4, 4, 2, 1, 1>;")],
    "p384_w12": [(P384, "using Plan384 = Plan<  384, 12,  9, 64, 128, 3, 4, 2, 1, 1>;")],
    "p192_w12": [(P192, "using Plan192 = Plan<  192, 12, 18, 32,  64, 6, 2, 2, 3, 1>;")],
    "p96_w16": [(P96, "using Plan96 = Plan<    96, 16, 12, 96,  48, 16, 1, 2, 3, 1>;")],
    "p96_s3": [(P96, "using Plan96 = Plan<    96, 16, 12, 96,  48, 8, 1, 3, 3, 1>;")],
    # knock-outs, for where the time goes (their outputs are wrong, not checked)
    "ko_mma": [("        tc::mma(acc[i][j], a[i]", "        if (0) tc::mma(acc[i][j], a[i]")],
    "ko_copy": [("      load_w<P>(ring", "      if (0) load_w<P>(ring"),
                ("        load_x<P>(xbuf", "        if (0) load_x<P>(xbuf")],
    "ko_lda": [("      if (wm + i * P::WM < mtiles) tc::ldsm(a[i]",
                "      if (k0 == 0 && wm + i * P::WM < mtiles) tc::ldsm(a[i]")],
    "ko_ldb": [("    for (int j = 0; j < P::NT / 2; ++j) tc::ldsm_t(b[j]",
                "    for (int j = 0; j < P::NT / 2; ++j) if (k0 == 0) tc::ldsm_t(b[j]")],
    "ko_cm": "ko_copy ko_mma",
    "ko_cl": "ko_copy ko_lda ko_ldb",
    "ko_x2mma": [("        tc::mma(acc[i][j], a[i], b[j / 2][2 * (j & 1)], b[j / 2][2 * (j & 1) + 1]);",
                  "        tc::mma(acc[i][j], a[i], b[j / 2][2 * (j & 1)], b[j / 2][2 * (j & 1) + 1]),\n"
                  "        tc::mma(acc[i][j], a[i], b[j / 2][2 * (j & 1)], b[j / 2][2 * (j & 1) + 1]);")],
}
# ko_split's stand-in for the split: hi = x, lo = 0
_NO_SPLIT = """__device__ __forceinline__ void nosplit(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = 0u;
}
"""
F32_P48 = "using Plan48 = Plan<    48, 16,  8, 48,  48, 4, 1, 2, 1, 2>;"
F32_P96 = "using Plan96 = Plan<    96, 16, 12, 16,  48, 8, 1, 2, 3, 1>;"
F32_P192 = "using Plan192 = Plan<  192, 12,  9, 16,  96, 4, 2, 2, 3, 1>;"
F32_P384 = "using Plan384 = Plan<  384,  6,  9, 16, 128, 2, 4, 2, 3, 1>;"
F32_VARIANTS = {
    "shipped": [],
    "fold0": [("constexpr bool kFold = true;", "constexpr bool kFold = false;")],
    "cvtsplit": {"mma_tf32.cuh": [(INT_SPLIT, CVT_SPLIT)]},
    "nanfree": {"mma_tf32.cuh": [(INT_SPLIT, NANFREE_SPLIT)]},
    "p48_k16t3": [(F32_P48, "using Plan48 = Plan<    48, 16,  8, 16,  48, 4, 1, 2, 3, 2>;")],
    "p96_8x12": [(F32_P96, "using Plan96 = Plan<    96,  8, 12, 16,  48, 4, 1, 2, 3, 2>;")],
    "p192_n64": [(F32_P192, "using Plan192 = Plan<  192, 12,  9, 16,  64, 4, 2, 2, 3, 1>;")],
    "p192_k32t1": [(F32_P192, "using Plan192 = Plan<  192, 12,  9, 32,  96, 4, 2, 2, 1, 1>;")],
    "p384_k32t1": [(F32_P384, "using Plan384 = Plan<  384,  6,  9, 32, 128, 2, 4, 2, 1, 1>;")],
    "ko_mma": [("      for (int j = 0; j < P::NT; ++j) tf32::mma3(acc[i][j]",
                "      for (int j = 0; j < P::NT; ++j) if (0) tf32::mma3(acc[i][j]")],
    "ko_mma1": [("tf32::mma3(acc[i][j], ah[i], al[i], bh[j], bl[j]);",
                 "tf32::mma(acc[i][j], ah[i], bh[j][0], bh[j][1]);")],
    "ko_split": [("namespace k5tf32 {", "namespace k5tf32 {\n" + _NO_SPLIT),
                 ("      tf32::split(", "      nosplit(")],
    "ko_copy": [("      k5tc::load_w<P>(ring", "      if (0) k5tc::load_w<P>(ring"),
                ("        k5tc::load_x<P>(xbuf", "        if (0) k5tc::load_x<P>(xbuf")],
    "ko_cm": "ko_copy ko_mma",
}
# each dtype's header, variants, kernels (by a part of their name) and gate
DTYPES = {"bfloat16": (HEADER, VARIANTS, "fused_block_tc_kernel", 2.0 ** -6),
          "float32": ("fused_block_tf32.cuh", F32_VARIANTS, "fused_block_tf32_kernel", 2e-5)}
CHECK_BATCH = 32
LONG_K = (32, 12, 9, 384)


def variant_sources(name: str, dtype: str = "bfloat16") -> dict:
    """{header: text} of a variant: its substitutions in the dtype's kernel
    header, or in the headers it names (a dict of them) with the kernel
    header unchanged beside them."""
    header, variants, _, _ = DTYPES[dtype]
    subs = variants[name]
    if isinstance(subs, str):          # a combination of other variants
        subs = [sub for part in subs.split() for sub in variants[part]]
    if isinstance(subs, dict):
        # the kernel header goes beside the changed ones unchanged: its quoted
        # includes then find them in the variant's directory, not in csrc/
        return {header: substituted(header, [], name),
                **{h: substituted(h, s, name) for h, s in subs.items()}}
    return {header: substituted(header, subs, name)}


def variant_source(name: str, dtype: str = "bfloat16") -> str:
    """The dtype's kernel header with the variant's substitutions."""
    return variant_sources(name, dtype)[DTYPES[dtype][0]]


def register_summary(log: str, kind: str = "fused_block_tc_kernel") -> str:
    """'C48:168 C96:... ' for the tensor-core kernels (names holding
    ``kind``) in a ptxas -v log, with their spills."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        if fn is None or kind not in fn:
            continue
        tag = "C" + re.search(r"PlanILi(\d+)E", fn).group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and m.group(1) != "0":
            out.append(f"{tag}:spills {m.group(1)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{tag}:{m.group(1)}")
    return " ".join(out)


def reference64(x, w1, w2, b1, b2):
    """The block in float64 on the same operands, the intermediate rounded to
    x's dtype (bf16 or f32) as the kernels round it; the output unrounded."""
    xn = x.double().permute(0, 3, 1, 2)
    k1, k2 = (w.double().permute(3, 2, 0, 1) for w in (w1, w2))
    y = torch.relu(F.conv2d(xn, k1, padding=1) + b1.double()[:, None, None])
    y = y.to(x.dtype).double()
    z = torch.relu(F.conv2d(y, k2, padding=1) + b2.double()[:, None, None] + xn)
    return z.permute(0, 2, 3, 1)


def accuracy(got, want) -> tuple:
    """max |got - want|, rms, and the share of outputs that differ from
    ``want`` rounded to got's dtype."""
    e = got.double() - want
    share = (got != want.to(got.dtype)).double().mean().item()
    return e.abs().max().item(), e.pow(2).mean().sqrt().item(), share


def random_block(gen, b, h, w, c, dtype=torch.bfloat16):
    """x, w1, w2, b1, b2 in ``dtype`` with O(1) outputs (chip_smoke.py's
    scales)."""
    x = torch.randn(b, h, w, c, device="cuda", generator=gen)
    ws = [torch.randn(3, 3, c, c, device="cuda", generator=gen) / (3 * c ** 0.5)
          for _ in range(2)]
    bs = [torch.randn(c, device="cuda", generator=gen) * 0.1 for _ in range(2)]
    return [t.to(dtype) for t in (x, *ws, *bs)]


def main(argv=None) -> dict:
    from .. import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    ap.add_argument("--chain", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="*", help="variants to build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_block_variants measures the CUDA card; none is available")
    header, variants, kind, tol = DTYPES[args.dtype]
    if args.only and set(args.only) - set(variants):
        raise ValueError(f"unknown {args.dtype} variants {sorted(set(args.only) - set(variants))}")
    dtype = getattr(torch, args.dtype)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    names = [n for n in variants if n == "shipped" or not args.only or n in args.only]
    _build.build(["fused_block"])
    built = kernel_variants.build(
        "fused_block", {f"k5_{n}": variant_sources(n, args.dtype)
                        for n in names if n != "shipped"})
    libs = {"shipped": (None, _build.build_log("fused_block")),
            **{tag[len("k5_"):]: lib for tag, lib in built.items()}}
    print(f"# {card}; K5 {args.dtype} variants", flush=True)
    for name, (_, log) in libs.items():
        print(f"# {name} registers: {register_summary(log, kind)}", flush=True)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False       # the f32 plain version: exact f32 convs
    try:
        return _run(args, libs, dtype, tol)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _run(args, libs: dict, dtype, tol: float) -> dict:
    from ..ops import fused_block as fb

    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    gaps = {}
    for _, h, w, c in bench_block.BRANCHES:
        args_b = random_block(gen, CHECK_BATCH, h, w, c, dtype)
        want = fb.fused_basic_block_plain(*args_b).float()
        for name, (path, _) in libs.items():
            if name.startswith("ko_"):
                continue
            with kernel_variants.loaded("fused_block", path):
                got = fb.fused_basic_block(*args_b).float()
            gaps[name] = max(gaps.get(name, 0.0), (got - want).abs().max().item())
            if name != "fold0":
                torch.testing.assert_close(got, want, atol=tol, rtol=tol,
                                           msg=lambda m, n=name: f"variant {n}: {m}")
    print("max |variant - plain| at batch 32 over the branches: " + "; ".join(
        f"{n} {g:.3e}" for n, g in gaps.items()), flush=True)
    args_k = random_block(gen, *LONG_K, dtype=dtype)
    want = reference64(*args_k)
    results = {"accuracy": {"simt": accuracy(fb.fused_basic_block_simt(*args_k), want)}}
    for name, (path, _) in libs.items():
        if name.startswith("ko_"):
            continue
        with kernel_variants.loaded("fused_block", path):
            results["accuracy"][name] = accuracy(fb.fused_basic_block(*args_k), want)
    print(f"accuracy at {LONG_K} vs float64 (max, rms, share of outputs off the rounded "
          "chain): " + "; ".join(f"{n} {m:.4e} {r:.4e} {s:.4%}"
                                 for n, (m, r, s) in results["accuracy"].items()), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for branch, h, w, c in bench_block.BRANCHES:
        x, w1, w2, b1, b2 = bench_block.branch_inputs(gen, bench_block.BATCH, h, w, c, dtype)
        times = {n: [] for n in libs}
        for r in range(args.rounds):
            for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                with kernel_variants.loaded("fused_block", libs[name][0]):
                    fn = lambda t: fb.fused_basic_block(t, w1, w2, b1, b2)   # noqa: E731
                    fn(x)
                    times[name].append(bench_block.chain_ms(fn, x, args.chain))
        results[branch] = {n: statistics.median(t) for n, t in times.items()}
        print(f"{branch} ({h}x{w}xC{c}) b{bench_block.BATCH}: " + "; ".join(
            f"{n} {t:.4f}" for n, t in results[branch].items()), flush=True)
        del x
    print("sums over the branches: " + "; ".join(
        f"{n} {sum(results[b][n] for b, *_ in bench_block.BRANCHES):.4f}" for n in libs),
        flush=True)
    return results


if __name__ == "__main__":
    main()
