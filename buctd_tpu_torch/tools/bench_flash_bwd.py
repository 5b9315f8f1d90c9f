"""K2's tensor-core kernels (launched by csrc/flash_bwd.cu) at the training
step's shapes against variants of their launch choices, on one CUDA card;
in f32 also against the SIMT kernels and SDPA's f32 backward.

    python -m buctd_tpu_torch.tools.bench_flash_bwd [--dtype bfloat16|float32]
        [--rounds 2] [--seed 3] [--only NAME ...]

Each variant is the kernels' header with one choice changed, written beside
a copy of csrc/flash_bwd.cu into buctd_tpu_torch/_build/variants/<name>/ (git
ignores it) and built there with nvcc (tools/kernel_variants.py); ptxas's
registers and spills of the kernels are printed for each.  bf16
(csrc/flash_bwd_tc.cuh):

  shipped  the source as it is: dk/dv held to 3 blocks a SM at d <= 48;
  no_cap   dk/dv keeps its registers at every d (2 blocks a SM at d = 48);
  cap4     both kernels held to 4 blocks a SM (128 registers) at every d;
  tiles32  32-wide looped tiles (keys for dq, q rows for dk/dv) at every d.

f32 (csrc/flash_bwd_tf32.cuh, 3xTF32):

  shipped  the source as it is: dq's own operands (q' and do) as register
           fragments, split once, at d <= 48; dk/dv's (K and V) read from
           shared memory and split each looped tile;
  smem_a   dq's read from shared memory too, at every d;
  cvtsplit every operand split by cvt.rna.tf32.f32 (csrc/mma_tf32.cuh's first
           split; the same values as the integer rounding shipped for
           finite operands);
  nanfree  the integer rounding without the fma that carries a NaN into lo
           (a NaN operand then reads as 0 or inf: what keeping NaN costs);

and beside them, in the same turns, the SIMT kernels that f32 ran before
(``flash_bwd_dq_simt``, ``flash_bwd_dkv_simt``) and SDPA's f32 backward alone
(dq, dk and dv from a saved ``F.scaled_dot_product_attention`` forward with
the same dropout, TF32 off: the library yardstick of dq + dk/dv).
``--only`` names the variants to build besides the shipped source (none
given: the shipped source alone).

dq and dk/dv are timed with CUDA events around 10 launches, the variants in
turns (the order reversed every other round) over ``--rounds`` rounds, at BH
32 and (L, d) = (6912, 48) and (1728, 96), with dropout 0.1 and 0 (the
difference is the dropout hash's share), on inputs from a seeded generator.
Every variant's gradients (and in f32 the SIMT kernels') must match the
shipped kernels' within 1e-3.  Returns {(L, d): {dropout: {impl: {"dq_ms",
"dkv_ms"}, "sdpa_ms": ms (f32)}}}, medians.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess

import torch

from . import kernel_variants
from .kernel_variants import CVT_SPLIT, INT_SPLIT, NANFREE_SPLIT, substituted

SHAPES = [(32, 6912, 48), (32, 1728, 96)]
DROPOUTS = (0.1, 0.0)
ROUNDS = 2
LAUNCHES = 10
# (old, new) source substitutions of each variant
_CAP = "constexpr int kDkvMinBlocks = D <= 48 ? 3 : 1;"
_DQ_BOUNDS = "__launch_bounds__(kThreads)\nflash_bwd_dq_tc_kernel("
VARIANTS = {
    "shipped": [],
    "no_cap": [(_CAP, "constexpr int kDkvMinBlocks = 1;")],
    "cap4": [(_CAP, "constexpr int kDkvMinBlocks = 4;"),
             (_DQ_BOUNDS, "__launch_bounds__(kThreads, 4)\nflash_bwd_dq_tc_kernel(")],
    "tiles32": [("return D <= 64 ? 64 : 32;", "return 32;")],
}
F32_VARIANTS = {
    "shipped": [],
    "smem_a": [("constexpr bool bwd_reg_a() { return D <= 48; }",
                "constexpr bool bwd_reg_a() { return false; }")],
    "cvtsplit": {"mma_tf32.cuh": [(INT_SPLIT, CVT_SPLIT)]},
    "nanfree": {"mma_tf32.cuh": [(INT_SPLIT, NANFREE_SPLIT)]},
}
# each dtype's kernel header, variants and kernels (by a part of their name)
DTYPES = {"bfloat16": ("flash_bwd_tc.cuh", VARIANTS, "_tc_kernel"),
          "float32": ("flash_bwd_tf32.cuh", F32_VARIANTS, "_tf32_kernel")}


def variant_sources(name: str, dtype: str = "bfloat16") -> dict:
    """{header: text} of a variant: its substitutions in the dtype's kernel
    header, or in the headers it names (a dict of them) with the kernel
    header unchanged beside them."""
    header, variants, _ = DTYPES[dtype]
    subs = variants[name]
    if isinstance(subs, dict):
        # the kernel header goes beside the changed ones unchanged: its quoted
        # includes then find them in the variant's directory, not in csrc/
        return {header: substituted(header, [], name),
                **{h: substituted(h, s, name) for h, s in subs.items()}}
    return {header: substituted(header, subs, name)}


def variant_source(name: str, dtype: str = "bfloat16") -> str:
    """The dtype's kernel header with the variant's substitutions, each of
    which must apply."""
    return variant_sources(name, dtype)[DTYPES[dtype][0]]


def register_summary(log: str, kind: str = "_tc_kernel") -> str:
    """'dq48:167 dkv48:168 ...' for the kernels whose name holds ``kind`` in
    a ptxas -v log, with their spills."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        if fn is None or kind not in fn:
            continue
        tag = ("dq" if "_dq_" in fn else "dkv") + re.search(r"ILi(\d+)E", fn).group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and m.group(1) != "0":
            out.append(f"{tag}:spills {m.group(1)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{tag}:{m.group(1)}")
    return " ".join(out)


def sdpa_backward(q, k, v, do, scale: float, p: float):
    """A call of SDPA's backward alone: dq, dk, dv from a saved forward of
    F.scaled_dot_product_attention with dropout p (one head a batch row)."""
    q4, k4, v4 = (x[:, None].detach().clone().requires_grad_() for x in (q, k, v))
    out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, dropout_p=p,
                                                            scale=scale)
    do4 = do[:, None].to(q.dtype)
    return lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True)


def main(argv=None) -> dict:
    from .. import _build
    from ..ops import flash_attention as fa

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--only", nargs="*", help="variants to build besides the shipped source")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_flash_bwd measures the CUDA card; none is available")
    header, variants, kind = DTYPES[args.dtype]
    if args.only is not None and set(args.only) - set(variants):
        raise ValueError(f"unknown {args.dtype} variants {sorted(set(args.only) - set(variants))}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build(["flash_bwd", "flash_fwd"])
    others = {n: variant_sources(n, args.dtype) for n in variants
              if n != "shipped" and (args.only is None or n in args.only)}
    libs = {"shipped": (None, _build.build_log("flash_bwd")),
            **kernel_variants.build("flash_bwd", others)}
    dtype = getattr(torch, args.dtype)
    f32 = dtype == torch.float32
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"# {card}; K2 {args.dtype} at BH 32, {LAUNCHES} launches per timing, {args.rounds} "
          f"rounds in turns; ms (median)")
    for name, (_, log) in libs.items():
        print(f"# {name} registers: {register_summary(log, kind)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {}
    try:
        for bh, l, d in SHAPES:
            q, k, v = (torch.randn(bh, l, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
            do = torch.randn(bh, l, d, device="cuda", generator=gen)
            scale = d ** -0.5
            results[(l, d)] = {}
            for p in DROPOUTS:
                out, lse = fa.flash_attention(q, k, v, scale, p, 7)
                delta = (do * out).sum(-1)
                call = (q, k, v, do, lse, delta, scale, p, 7)
                impls = {n: (path, fa.flash_bwd_dq, fa.flash_bwd_dkv)
                         for n, (path, _) in libs.items()}
                if f32:
                    impls["simt"] = (None, fa.flash_bwd_dq_simt, fa.flash_bwd_dkv_simt)
                    sdpa, sdpa_ms = sdpa_backward(q, k, v, do, scale, p), []
                times = {n: {"dq_ms": [], "dkv_ms": []} for n in impls}
                ref = None
                for r in range(args.rounds):
                    for name in (list(impls) if r % 2 == 0 else list(impls)[::-1]):
                        path, dq_fn, dkv_fn = impls[name]
                        with kernel_variants.loaded("flash_bwd", path):
                            got = (dq_fn(*call), *dkv_fn(*call))
                            times[name]["dq_ms"].append(kernel_variants.events_ms(
                                lambda: dq_fn(*call), LAUNCHES))
                            times[name]["dkv_ms"].append(kernel_variants.events_ms(
                                lambda: dkv_fn(*call), LAUNCHES))
                        ref = got if ref is None else ref   # round 0 starts with shipped
                        gap = max((a - b).abs().max().item() for a, b in zip(got, ref))
                        if gap > 1e-3:
                            raise AssertionError(f"{name} differs from shipped by {gap}")
                    if f32:
                        sdpa_ms.append(kernel_variants.events_ms(sdpa, LAUNCHES))
                res = {n: {key: statistics.median(ts) for key, ts in t.items()}
                       for n, t in times.items()}
                text = "; ".join(f"{n} dq {t['dq_ms']:.4f} dkv {t['dkv_ms']:.4f}"
                                 for n, t in res.items())
                if f32:
                    res["sdpa_ms"] = statistics.median(sdpa_ms)
                    text += f"; SDPA f32 backward alone {res['sdpa_ms']:.4f}"
                results[(l, d)][p] = res
                print(f"({bh}, {l}, {d}) dropout {p}: {text}", flush=True)
                del out, lse, delta, call
            del q, k, v, do
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return results


if __name__ == "__main__":
    main()
